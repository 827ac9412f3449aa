"""Closed loop of query batches, one client, against an index built from
the FASTQ in set-up.

Batch i is `count()` of query set "batch<i mod pool>": the windows of
the mix's `batch_reads` held-out reads each, `pool_batches` sets packed
in set-up and cycled; each pooled batch runs once to warm up.  Kept for
the judge: each pooled batch's last answer, and the answers of a seeded
draw of one in KEEP_ONE_IN of the calls (at most KEEP_MAX).  One pass
over the pool when tracing.
"""

import time

import numpy as np

CHECK_CONTENTS = False
#: the public index method each batch asks
METHOD = "count"
#: the mix's parameters at a CPU test's size
TINY = {"batch_reads": 64, "pool_batches": 4}
KEEP_ONE_IN = 16
KEEP_MAX = 256


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
    ask = getattr(idx, METHOD)
    for name in pool:
        ask(run.rows[name])
    rng = np.random.default_rng(int(run.seed) % (1 << 63) + 7)
    keep = rng.random(1 << 22) < 1.0 / KEEP_ONE_IN
    last = {}
    with run.measured() as win:
        i = 0
        while True:
            name = pool[i % len(pool)]
            q = run.rows[name]
            c0, t0 = time.process_time(), time.perf_counter()
            with run.span("count_batch"):
                ans = ask(q)
            t1 = time.perf_counter()
            win.calls.append((t0, t1, q.shape[0]))
            win.cpu_s.append(time.process_time() - c0)
            last[name] = ans
            if keep[i % keep.size] and len(win.answers) < KEEP_MAX:
                win.answers.append((name, ans))
            i += 1
            if (i >= len(pool)) if run.trace else (t1 - win.start
                                                   >= run.seconds):
                break
    win.answers.extend(last.items())
