"""Judge of a canonical de Bruijn graph (``DeBruijnGraph``).

`collect` takes what the measured calls produced: the answers of every
kept `node_counts()` call, each (counters [m, 9], found [m]).  `compare`
holds them against the plain reference (``kbench/reference/debruijn.py``)
run on the same reads:

* counter_mismatches — answer rows whose 9 counters differ anywhere from
  the reference's counters of the query's node (zeros where absent),
  each missing or extra row counted as one;
* found_mismatches — answers whose `found` differs from the reference's
  (the node has a window), each missing or extra one counted as one.

Every number is exact: its limit is 0.  `control` is the reference put
in the program's place with an N neighbour's nibble read as A (DNA16
0x1) instead of all four bases: the lossy edge path that a graph fed
reads already encoded in the DNA alphabet takes.
"""

from __future__ import annotations

import numpy as np
import torch

from kbench.reference import debruijn as ref

LIMITS = {"counter_mismatches": 0, "found_mismatches": 0}
#: the DNA16 code of A, which the control reads an N neighbour as
LOSSY_N = 0x1


def collect(graph, run) -> dict:
    return {"answers": list(run.window.answers)}


def _mismatches(answers, queries: dict, keys, table) -> tuple[int, int]:
    """(counter_mismatches, found_mismatches) of the answers against the
    reference graph (keys, table)."""
    rows = found = 0
    want_of = {}
    for name, (got_c, got_f) in answers:
        if name not in want_of:
            want_of[name] = ref.node_counts(keys, table, queries[name])
        want_c, want_f = want_of[name]
        dev = want_c.device
        got_c = torch.from_numpy(np.asarray(got_c, np.int64)).to(dev)
        got_f = torch.from_numpy(np.asarray(got_f, bool)).to(dev)
        n, nf = min(got_c.shape[0], want_c.shape[0]), min(
            got_f.numel(), want_f.numel())
        rows += int((got_c[:n] != want_c[:n]).any(1).sum()) + abs(
            got_c.shape[0] - want_c.shape[0])
        found += int((got_f[:nf] != want_f[:nf]).sum()) + abs(
            got_f.numel() - want_f.numel())
    return rows, found


def compare(outputs, inputs, sets, seed, device) -> list:
    keys, table = ref.node_table(inputs.codes, inputs.k, device)
    queries = {name: ref.canonical_codes(inputs.held[lo:hi], inputs.k, device)
               for name, (lo, hi) in sets.items()}
    rows, found = _mismatches(outputs["answers"], queries, keys, table)
    return [(n, v, LIMITS[n]) for n, v in (("counter_mismatches", rows),
                                           ("found_mismatches", found))]


def control(inputs, sets, contents: bool, device, seed: int) -> dict:
    """The outputs of a graph that reads an N neighbour as A: one answer
    per query set."""
    keys, table = ref.node_table(inputs.codes, inputs.k, device,
                                 n_edge=LOSSY_N)
    out = []
    for name, (lo, hi) in sets.items():
        c, f = ref.node_counts(keys, table, ref.canonical_codes(
            inputs.held[lo:hi], inputs.k, device))
        out.append((name, (c.to(torch.int32).cpu().numpy(),
                           f.cpu().numpy())))
    return {"answers": out}
