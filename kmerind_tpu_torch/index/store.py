"""Run-layout count store (the count subset of ``kmerind_tpu.index.store``).

A `RunCountStore` holds keys sorted over ALL rows with duplicates allowed,
per-row weights and an exclusive prefix sum; the count of key q is the
total weight of its key run.  Building a store from sorted chunks is then a
MERGE of already-sorted runs (the K2 kernel), and only weighted adoption
and compaction need a prefix sum (the K3 kernel, `_cumsum_i32`).  It is the
analog of the reference's lazy sorted map (distributed_sorted_map.hpp:
341,940) with the counting-map reduction (distributed_densehash_map.hpp:
2669+) virtualized into the prefix sum.

Functions are plain PyTorch on whatever device the store lives on; stores
are immutable by convention (every function returns new tensors), so a
run's identity versions its query metadata (`run_query_aux`).
"""

from __future__ import annotations

import dataclasses

import torch

from ..ops import kernels, sortops
from ..ops.keys import SENTINEL

__all__ = ["RunCountStore", "empty_run_count_store", "run_from_sorted",
           "run_merge", "run_from_sorted_unit", "run_merge_unit",
           "run_totals", "run_distinct", "run_query_aux", "run_lookup_aux",
           "run_compact"]


@dataclasses.dataclass
class RunCountStore:
    """Counting store in RUN layout.

    Invariants:
      * ``keys`` is lexicographically nondecreasing over ALL cap rows;
        padding rows hold the all-ones sentinel with weight 0.
      * ``weights[i] >= 0``.
      * ``csum[i] == sum(weights[:i])`` (int32[cap + 1]).

    Keys live column-major (int32-held uint32 words [w, cap], word 0 most
    significant, ``ops/keys.py``), so every merge and scan operand is one
    contiguous vector.
    """

    keys: torch.Tensor     # int32[w, cap]
    weights: torch.Tensor  # int32[cap]
    csum: torch.Tensor     # int32[cap + 1]

    @property
    def capacity(self) -> int:
        return self.keys.shape[1]


def empty_run_count_store(capacity: int, nwords: int, device) -> RunCountStore:
    return RunCountStore(
        keys=torch.full((nwords, capacity), SENTINEL, dtype=torch.int32,
                        device=device),
        weights=torch.zeros(capacity, dtype=torch.int32, device=device),
        csum=torch.zeros(capacity + 1, dtype=torch.int32, device=device),
    )


def _cumsum_i32(x: torch.Tensor) -> torch.Tensor:
    """Inclusive int32 prefix sum — the K3 kernel on the device."""
    return kernels.prefix_sum_i32(x.to(torch.int32).contiguous())


def _exclusive(incl: torch.Tensor) -> torch.Tensor:
    return torch.cat([incl.new_zeros(1), incl])


def run_from_sorted(kcols: torch.Tensor, weights: torch.Tensor) -> RunCountStore:
    """Adopt an already-sorted (sentinel-padded) weighted run as a store."""
    return RunCountStore(keys=kcols, weights=weights,
                         csum=_exclusive(_cumsum_i32(weights)))


def run_merge(store: RunCountStore, kcols: torch.Tensor,
              weights: torch.Tensor) -> RunCountStore:
    """Merge a sorted weighted run into the store (K2 merge with the weights
    as payload + prefix-sum rebuild).  Capacity next_pow2(cap + n)."""
    keys, (w,) = sortops.merge_sorted_runs_cols(
        store.keys, (store.weights,), kcols, (weights.to(torch.int32),))
    return run_from_sorted(keys, w)


def _unit_store(keys: torch.Tensor, n_live: torch.Tensor) -> RunCountStore:
    """Closed-form UNIT store: weight 1 per non-sentinel row, which sort to
    the front, so csum[i] = min(i, n_live)."""
    n = keys.shape[1]
    live = ~(keys == SENTINEL).all(dim=0)
    idx = torch.arange(n + 1, dtype=torch.int32, device=keys.device)
    return RunCountStore(keys=keys, weights=live.to(torch.int32),
                         csum=torch.minimum(idx, n_live.to(torch.int32)))


def run_from_sorted_unit(kcols: torch.Tensor,
                         weights: torch.Tensor) -> RunCountStore:
    """Adopt an already-sorted UNIT run (weight 1 per live row, sentinel
    tail) with closed-form csum — no prefix sum."""
    return _unit_store(kcols, weights.to(torch.int32).sum())


def run_merge_unit(a: RunCountStore, b: RunCountStore) -> RunCountStore:
    """Merge two UNIT runs keys-only (K2 with no payload): under a
    sentinel-safe spec the live rows are exactly the non-sentinel keys, so
    weights and csum are rebuilt in closed form."""
    keys, _ = sortops.merge_sorted_runs_cols(a.keys, (), b.keys, ())
    return _unit_store(keys, a.csum[-1] + b.csum[-1])


def _adjacent_neq(kcols: torch.Tensor):
    """(neq_prev bool[cap], neq_next bool[cap]) between adjacent rows of
    column-major keys [w, cap]."""
    cap = kcols.shape[1]
    neq_prev = torch.ones(cap, dtype=torch.bool, device=kcols.device)
    neq_next = torch.ones(cap, dtype=torch.bool, device=kcols.device)
    diff = (kcols[:, 1:] != kcols[:, :-1]).any(dim=0)
    neq_prev[1:] = diff
    neq_next[:-1] = diff
    return neq_prev, neq_next


def run_totals(store: RunCountStore):
    """(is_head bool[cap], is_last bool[cap], total int32[cap]): `total` is
    the weight sum of each row's key run (csum at the run's end minus csum
    at its start), broadcast to every row of the run through its run index
    (a cumsum of the head flags).  The JAX package broadcasts with a
    cummax / reversed cummin pair to avoid TPU gathers; on the GPU the
    gathers are cheap and torch's cummax is a slow single-block scan."""
    cap = store.capacity
    neq_prev, neq_next = _adjacent_neq(store.keys)
    run_id = torch.cumsum(neq_prev, 0) - 1
    start = store.csum[:cap][neq_prev]
    end = store.csum[1:][neq_next]
    return neq_prev, neq_next, (end - start)[run_id]


def run_distinct(store: RunCountStore) -> torch.Tensor:
    """0-d int: distinct keys with positive total weight (the map's size)."""
    is_head, _, total = run_totals(store)
    return (is_head & (total > 0)).sum()


def run_query_aux(store: RunCountStore, tbits: int = 16):
    """Per-run query metadata, built once per run version: (ext int32[w + 1,
    cap] — key columns plus the run-total row, bstart int32[2^tbits + 1] —
    prefix-bucket starts of word 0)."""
    _, _, total = run_totals(store)
    ext = torch.cat([store.keys, total[None, :]], dim=0)
    return ext, sortops._prefix_starts(store.keys[0], tbits)


def run_lookup_aux(ext: torch.Tensor, bstart: torch.Tensor,
                   queries: torch.Tensor) -> torch.Tensor:
    """int32[m] count per query row [m, w] against cached aux metadata: one
    bucket-seeded lower_bound plus one fused [w + 1, m] gather."""
    w = ext.shape[0] - 1
    cap = ext.shape[1]
    lo = sortops.lower_bound_cols_prebuilt(ext, w, bstart, queries)
    g = ext[:, lo.clamp(0, cap - 1)]
    hit = lo < cap
    for j in range(w):
        hit &= g[j] == queries[:, j]
    return torch.where(hit, g[w], 0)


def run_compact(store: RunCountStore, new_cap: int):
    """Collapse every key run to one (key, total) row, live rows first in
    key order, at capacity `new_cap`.  Returns (new_store, overflow) with
    overflow = distinct - new_cap when positive (the store is then cut and
    the caller retries larger)."""
    w = store.keys.shape[0]
    _, is_last, total = run_totals(store)
    emit = torch.nonzero(is_last & (total > 0)).squeeze(1)
    n_emit = emit.shape[0]
    keep = emit[:new_cap]
    keys = torch.full((w, new_cap), SENTINEL, dtype=torch.int32,
                      device=store.keys.device)
    totals = torch.zeros(new_cap, dtype=torch.int32, device=store.keys.device)
    keys[:, : keep.shape[0]] = store.keys[:, keep]
    totals[: keep.shape[0]] = total[keep]
    return run_from_sorted(keys, totals), max(n_emit - new_cap, 0)
