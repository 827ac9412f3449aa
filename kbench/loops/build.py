"""Closed loop of whole file builds, one client.

Each call builds a fresh index from the FASTQ and ends when `count()` of
the query set "first_query" (the windows of the mix's `query_reads`
held-out reads) is on the host.  One such call warms up; the window
then starts calls while the mean call still fits in its seconds (at
least one; one when tracing).  The judge also checks the last build's
whole contents.
"""

import time

CHECK_CONTENTS = True
#: the public index method of a call's first answer
METHOD = "count"
#: the mix's parameters at a CPU test's size: as they are
TINY: dict = {}


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
