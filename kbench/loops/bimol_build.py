"""Closed loop of whole file builds into a Bimolecule count map, one
client: a copy of ``build.py``'s loop (whose method is a constant of
its own) with each call ending on `find()`.

Each call builds a fresh index from the FASTQ and ends when `find()` of
the query set "first_query" (the windows of the mix's `query_reads`
held-out reads) is on the host, which forces the last flush, the query
aux and the stored-orientation column inside the call.  One such call
warms up; the window then starts calls while the mean call still fits
in its seconds (at least one; one when tracing).  The judge also checks
the last build's whole contents.

When tracing, the window's `launches` (``kbench/launches.py``) holds what
the profiler's trace says the program's "bimol.min_rep" and
"bimol.strands" ranges launched, for
``metrics/bimol.min_rep_share_pct.py``: read from the trace the harness
exports after the window.
"""

import json
import pathlib
import time

from kbench import launches

CHECK_CONTENTS = True
#: the public index method of a call's first answer
METHOD = "find"
#: the mix's parameters at a CPU test's size: as they are
TINY: dict = {}
#: the program ranges whose launches the window keeps when tracing: the
#: two callers of the representative minimum (a compaction's, `_strands`)
MIN_REP_RANGES = ("kmerind/bimol.min_rep", "kmerind/bimol.strands")


def query_sets(mix: dict) -> dict:
    """{query set: (first, end) held-out read} of the mix."""
    return {"first_query": (0, mix["query_reads"])}


def drive(run):
    rows = run.rows["first_query"]
    kmers = run.inputs.windows()

    def call():
        run.idx = None
        idx = run.make_index()
        with run.span("build"):
            idx.build(str(run.inputs.path))
        with run.span("first_query"):
            ans = getattr(idx, METHOD)(rows)
        run.idx = idx
        return ans

    call()
    with run.measured() as win:
        while True:
            c0, t0 = time.process_time(), time.perf_counter()
            ans = call()
            t1 = time.perf_counter()
            win.calls.append((t0, t1, kmers))
            win.cpu_s.append(time.process_time() - c0)
            win.answers.append(("first_query", ans))
            mean = (t1 - win.start) / len(win.calls)
            if run.trace or t1 + mean - win.start > run.seconds:
                break
    if run.trace:
        # a profile exports its trace once: read the harness's export
        export = run.prof.export_chrome_trace

        def export_and_keep(path):
            export(path)
            win.launches = launches.launch_events(
                json.loads(pathlib.Path(path).read_text()), MIN_REP_RANGES)

        run.prof.export_chrome_trace = export_and_keep
