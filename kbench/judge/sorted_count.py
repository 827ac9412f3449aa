"""Judge of kmerind's sort-based count map (``SortedCountIndex``).

The map's semantics are the canonical count index's plus one order: its
`items()` gives every distinct key once, in ascending key order over all
shards.  So the reference is the count judge's, the frozen plain
reference ``kbench/reference/kmers.py``, whose table (`window_table`) is
already the sorted distinct canonical codes, and the numbers are the
count judge's (``count.py``: answer_mismatches, distinct_gap,
count_mismatches, from its `collect`, which keeps `items()` in the order
the map gave it) and one more:

* order_mismatches — positions where the key sequence of `items()`
  differs from the reference's sorted distinct keys, each missing or
  extra position counted as one.

Every limit is 0.  `control` is the count judge's: the reference put in
the program's place with each k-mer keyed by its low 32 bits.
"""

from __future__ import annotations

import torch

from kbench.judge import count as count_judge
from kbench.reference import kmers as ref

LIMITS = {**count_judge.LIMITS, "order_mismatches": 0}

collect = count_judge.collect
control = count_judge.control


def order_mismatches(keys: torch.Tensor, got_keys: torch.Tensor) -> int:
    """Positions where `got_keys` (in the map's order) differs from the
    reference's sorted `keys`, plus |length difference|."""
    n = min(keys.numel(), got_keys.numel())
    return int((keys[:n] != got_keys[:n]).sum()) + abs(
        keys.numel() - got_keys.numel())


def compare(outputs, inputs, sets, seed, device) -> list:
    keys, counts = ref.window_table(inputs.codes, inputs.k, device)
    queries = count_judge.query_codes(inputs, sets, device)
    checks = [("answer_mismatches", count_judge.answer_mismatches(
        outputs["answers"], queries,
        lambda q: ref.lookup(keys, counts, q)))]
    if "keys" in outputs:
        got = torch.from_numpy(outputs["keys"]).to(device)
        checks += count_judge.content_checks(
            keys, counts, got, torch.from_numpy(outputs["counts"]).to(device))
        checks.append(("order_mismatches", order_mismatches(keys, got)))
    return [(n, v, LIMITS[n]) for n, v in checks]
