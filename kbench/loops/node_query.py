"""Closed loop of node-query batches, one client, against a de Bruijn
graph built from the FASTQ in set-up.

Batch i is `node_counts()` of query set "batch<i mod pool>": the windows
of the mix's `batch_reads` held-out reads each, `pool_batches` sets
packed in set-up and cycled; each pooled batch runs once to warm up,
which also builds the graph's counter tables and query aux.  Kept for
the judge: each pooled batch's last answer, and the answers of a seeded
draw of one in KEEP_ONE_IN of the calls, at most KEEP_MAX (an answer is
21 MB on the host at the cell's size).  One pass over the pool when
tracing.
"""

import time

import numpy as np

CHECK_CONTENTS = False
#: the public graph method each batch asks
METHOD = "node_counts"
#: the mix's parameters at a CPU test's size
TINY = {"batch_reads": 64, "pool_batches": 4}
KEEP_ONE_IN = 16
KEEP_MAX = 64


def query_sets(mix: dict) -> dict:
    """{query set: (first, end) held-out read} of the mix."""
    b = mix["batch_reads"]
    return {f"batch{i}": (i * b, (i + 1) * b)
            for i in range(mix["pool_batches"])}


def drive(run):
    pool = list(query_sets(run.mix))
    graph = run.make_index()
    graph.build(str(run.inputs.path))
    run.idx = graph
    ask = getattr(graph, METHOD)
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
            with run.span("node_batch"):
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
