"""Closed loop of `find(with_quality=True)` batches, one client, against
a multimap built from the FASTQ in set-up.

Batch i is `find(q, max_per_query, with_quality=True)` of query set
"batch<i mod pool>": the windows of the mix's `batch_reads` held-out
reads each, `pool_batches` sets packed in set-up and cycled.  One pooled
batch runs to warm up: every batch has the same shapes.  An answer is
(ids uint64[m, width], qualities float32[m, width], mask bool[m, width]),
~484 MB on the host at the cell's size, so the judge keeps at most
KEEP_MAX: the first two calls' and a seeded draw of one in KEEP_ONE_IN
of the later ones.  At least two calls; TRACE_BATCHES pooled batches
when tracing.
"""

import time

import numpy as np

CHECK_CONTENTS = False
#: the public index method each batch asks
METHOD = "find"
#: the mix's parameters at a CPU test's size
TINY = {"batch_reads": 32, "pool_batches": 3}
KEEP_ONE_IN = 16
KEEP_MAX = 4
TRACE_BATCHES = 8


def query_sets(mix: dict) -> dict:
    """{query set: (first, end) held-out read} of the mix."""
    b = mix["batch_reads"]
    return {f"batch{i}": (i * b, (i + 1) * b)
            for i in range(mix["pool_batches"])}


def drive(run):
    pool = list(query_sets(run.mix))
    idx = run.make_index()
    idx.build(str(run.inputs.path))
    run.idx = idx
    find = getattr(idx, METHOD)
    width = run.mix["max_per_query"]

    def ask(q):
        return find(q, max_per_query=width, with_quality=True)

    ask(run.rows[pool[0]])
    rng = np.random.default_rng(int(run.seed) % (1 << 63) + 7)
    keep = rng.random(1 << 22) < 1.0 / KEEP_ONE_IN
    keep[:2] = True
    with run.measured() as win:
        i = 0
        while True:
            name = pool[i % len(pool)]
            q = run.rows[name]
            c0, t0 = time.process_time(), time.perf_counter()
            with run.span("find_batch"):
                ans = ask(q)
            t1 = time.perf_counter()
            win.calls.append((t0, t1, q.shape[0]))
            win.cpu_s.append(time.process_time() - c0)
            if keep[i % keep.size] and len(win.answers) < KEEP_MAX:
                win.answers.append((name, ans))
            del ans
            i += 1
            if run.trace:
                if i >= max(2, min(len(pool), TRACE_BATCHES)):
                    break
            elif i >= 2 and t1 - win.start >= run.seconds:
                break
