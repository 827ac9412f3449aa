"""Count and multimap stores (the count and multimap subsets of
``kmerind_tpu.index.store``).

A `CountStore` holds each distinct key once, sorted, with its count — one
shard of the range-partitioned `SortedCountIndex`, rebuilt whole by each
flush.  A `RunCountStore` holds keys sorted over ALL rows with duplicates allowed,
per-row weights and an exclusive prefix sum; the count of key q is the
total weight of its key run.  Building a store from sorted chunks is then a
MERGE of already-sorted runs (the K2 kernel), and only weighted adoption
and compaction need a prefix sum (the K3 kernel, `_cumsum_i32`).  It is the
analog of the reference's lazy sorted map (distributed_sorted_map.hpp:
341,940) with the counting-map reduction (distributed_densehash_map.hpp:
2669+) virtualized into the prefix sum.  A `MultiStore` holds (key, 64-bit
id, quality) pairs sorted by key with duplicates — the position and
position+quality multimaps (densehash_multimap) — and a flush merges a
sorted batch into it with K2.

One shard's store has the shapes given in its class; an index of p shards
stacks them on a leading axis ([p, ...], `shard` takes one apart).

Functions are plain PyTorch on whatever device the store lives on; stores
are immutable by convention (every function returns new tensors), so a
run's identity versions its query metadata (`run_query_aux`).
"""

from __future__ import annotations

import dataclasses

import torch

from ..ops import kernels, sortops
from ..ops.keys import SENTINEL, to_u64

__all__ = ["CountStore", "empty_count_store", "stack_count_stores",
           "count_lookup", "count_erase",
           "RunCountStore", "empty_run_count_store", "run_from_sorted",
           "run_merge", "run_from_sorted_unit", "run_merge_unit",
           "run_totals", "run_distinct", "run_query_aux", "run_lookup_aux",
           "run_compact", "stack_run_stores",
           "MultiStore", "empty_multi_store", "stack_multi_stores",
           "multi_grow", "multi_insert", "multi_merge_flush",
           "multi_merge_flush_flagged", "multi_query_aux",
           "multi_lookup_ranges_aux", "multi_lookup_ranges", "multi_count",
           "multi_gather", "multi_erase", "multi_distinct"]


def stack(ts) -> torch.Tensor:
    """Per-shard tensors -> one [p, ...] tensor; one shard becomes a view
    (no copy of a store that may fill most of the device)."""
    return ts[0].unsqueeze(0) if len(ts) == 1 else torch.stack(ts)


@dataclasses.dataclass
class CountStore:
    """Unique-key counting store.

    One shard: ``keys`` int32[cap, w] (uint32 words) sorted, distinct in
    rows [0, size), all-ones sentinel rows after; ``counts`` int32[cap], 0
    past size; ``size`` int32 0-d.  An index of p shards stacks them:
    [p, cap, w], [p, cap], [p] (`stack_count_stores`, `shard`)."""

    keys: torch.Tensor
    counts: torch.Tensor
    size: torch.Tensor

    def shard(self, s: int) -> "CountStore":
        return CountStore(self.keys[s], self.counts[s], self.size[s])


def empty_count_store(capacity: int, nwords: int, device) -> CountStore:
    return CountStore(
        keys=torch.full((capacity, nwords), SENTINEL, dtype=torch.int32,
                        device=device),
        counts=torch.zeros(capacity, dtype=torch.int32, device=device),
        size=torch.zeros((), dtype=torch.int32, device=device))


def stack_count_stores(stores) -> CountStore:
    """Per-shard stores of one capacity -> the stacked [p, ...] store."""
    return CountStore(*(torch.stack([getattr(x, f) for x in stores])
                        for f in ("keys", "counts", "size")))


def count_lookup(store: CountStore, queries: torch.Tensor) -> torch.Tensor:
    """int32[m] count per query row [m, w] of one shard (0 if absent):
    bucket-seeded binary search plus two gathers.  The JAX package routes
    batches with m * 8 >= cap to a sort-merge join instead (a TPU-tuned
    crossover, ROADMAP queue 2); the answers are the same."""
    idx = sortops.lower_bound_bucketed(store.keys, store.size, queries)
    hit = sortops.rows_equal_at(store.keys, idx, queries, store.size)
    return torch.where(hit, store.counts[idx.clamp(0, store.keys.shape[0] - 1)],
                       0)


def count_erase(store: CountStore, queries: torch.Tensor,
                qvalid: torch.Tensor):
    """Remove the valid query keys from one shard; the kept rows stay in
    order.  Returns (new_store, n_erased 0-d)."""
    cap = store.keys.shape[0]
    idx = sortops.lower_bound_bucketed(store.keys, store.size, queries)
    hit = sortops.rows_equal_at(store.keys, idx, queries, store.size) & qvalid
    kill = torch.zeros(cap + 1, dtype=torch.bool, device=store.keys.device)
    kill[torch.where(hit, idx, cap)] = True
    arange = torch.arange(cap, device=store.keys.device)
    rows = torch.nonzero((arange < store.size) & ~kill[:cap]).squeeze(1)
    keys = torch.full_like(store.keys, SENTINEL)
    counts = torch.zeros_like(store.counts)
    keys[: rows.shape[0]] = store.keys[rows]
    counts[: rows.shape[0]] = store.counts[rows]
    new_size = torch.tensor(rows.shape[0], dtype=torch.int32,
                            device=store.keys.device)
    return CountStore(keys, counts, new_size), store.size - new_size


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
        return self.keys.shape[-1]

    def shard(self, s: int) -> "RunCountStore":
        return RunCountStore(self.keys[s], self.weights[s], self.csum[s])


def stack_run_stores(stores) -> RunCountStore:
    """Per-shard run stores of one capacity -> the stacked [p, ...] run."""
    return RunCountStore(*(stack([getattr(x, f) for x in stores])
                           for f in ("keys", "weights", "csum")))


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


# ------------------------------------------------------------------ multimap
@dataclasses.dataclass
class MultiStore:
    """Multimap store: (key, id, quality) pairs sorted by key, duplicates
    allowed, in no promised order within a key (densehash_multimap).

    One shard: ``keys`` int32[w, cap] column-major (uint32 words, word 0
    most significant), sorted over rows [0, size) with all-ones sentinel
    rows after; ``val_hi`` / ``val_lo`` int32[cap] carry the uint32 halves
    of the 64-bit position id; ``val_q`` float32[cap] the windowed quality
    (0 where unused); ``size`` int32 0-d."""

    keys: torch.Tensor
    val_hi: torch.Tensor
    val_lo: torch.Tensor
    val_q: torch.Tensor
    size: torch.Tensor

    @property
    def capacity(self) -> int:
        return self.keys.shape[-1]

    def shard(self, s: int) -> "MultiStore":
        return MultiStore(self.keys[s], self.val_hi[s], self.val_lo[s],
                          self.val_q[s], self.size[s])


_MULTI_FIELDS = ("keys", "val_hi", "val_lo", "val_q", "size")


def empty_multi_store(capacity: int, nwords: int, device) -> MultiStore:
    return MultiStore(
        keys=torch.full((nwords, capacity), SENTINEL, dtype=torch.int32,
                        device=device),
        val_hi=torch.zeros(capacity, dtype=torch.int32, device=device),
        val_lo=torch.zeros(capacity, dtype=torch.int32, device=device),
        val_q=torch.zeros(capacity, dtype=torch.float32, device=device),
        size=torch.zeros((), dtype=torch.int32, device=device))


def stack_multi_stores(stores) -> MultiStore:
    """Per-shard multimap stores of one capacity -> the stacked store."""
    return MultiStore(*(stack([getattr(x, f) for x in stores])
                        for f in _MULTI_FIELDS))


def multi_grow(store: MultiStore, new_cap: int) -> MultiStore:
    """The store (one shard or stacked) padded to capacity new_cap:
    sentinel keys, zero payloads."""
    pad = new_cap - store.capacity
    keys = torch.nn.functional.pad(store.keys, (0, pad), value=SENTINEL)
    vals = (torch.nn.functional.pad(v, (0, pad)) for v in
            (store.val_hi, store.val_lo, store.val_q))
    return MultiStore(keys, *vals, store.size)


def _cut(store: MultiStore, keys, pays, total, q=None) -> tuple:
    """(store of the first cap rows of a merged or sorted output, overflow):
    copies, so the larger output's memory is released."""
    cap = store.capacity
    size = torch.clamp(total, max=cap).to(torch.int32)
    val_q = store.val_q if q is None else q[:cap].clone()
    new = MultiStore(keys[:, :cap].contiguous(), pays[0][:cap].clone(),
                     pays[1][:cap].clone(), val_q, size)
    return new, torch.clamp(total - cap, min=0)


def _qbits(q: torch.Tensor) -> torch.Tensor:
    return q.to(torch.float32).contiguous().view(torch.int32)


def multi_insert(store: MultiStore, words, val_hi, val_lo, valid,
                 val_q=None):
    """Add (key, id, quality) rows words[n, w] / [n] by one stable sort of
    the store's live rows and the valid new rows (densehash_multimap
    insert).  val_q None: quality 0.  Returns (new_store, overflow 0-d)."""
    cap = store.capacity
    n = words.shape[0]
    dev = words.device
    if val_q is None:
        val_q = torch.zeros(n, dtype=torch.float32, device=dev)
    live = torch.arange(cap, device=dev) < store.size
    s_cols, (s_hi, s_lo, s_q), s_valid = sortops.sort_rows(
        torch.cat([store.keys.t(), words]),
        (torch.cat([store.val_hi, val_hi]), torch.cat([store.val_lo, val_lo]),
         torch.cat([store.val_q, val_q.to(torch.float32)])),
        torch.cat([live, valid]), as_cols=True)
    keys = torch.where(s_valid[None, :], s_cols, SENTINEL)
    return _cut(store, keys, (s_hi, s_lo), s_valid.sum(), s_q)


def multi_merge_flush(store: MultiStore, words, val_hi, val_lo, valid,
                      val_q=None):
    """Flush a batch into the store for a sentinel-safe spec: sort only the
    batch (invalid rows become sentinels and sort last), then MERGE it with
    the sorted store — the K2 kernel with 2 payloads (the id halves), or 3
    with val_q.  val_q None means the store carries no quality: the column
    stays out of the sort and the merge and the store's own (zero) column
    is kept.  Returns (new_store, overflow 0-d)."""
    b_pays = (val_hi, val_lo) + (() if val_q is None else (_qbits(val_q),))
    a_pays = (store.val_hi, store.val_lo) + (
        () if val_q is None else (_qbits(store.val_q),))
    b_cols, b_pays, _ = sortops.sort_rows(
        words, b_pays, valid, is_stable=False, sentinel_ok=True, as_cols=True)
    m_cols, m_pays = sortops.merge_sorted_runs_cols(store.keys, a_pays,
                                                    b_cols, b_pays)
    q = None if val_q is None else m_pays[2].view(torch.float32)
    return _cut(store, m_cols, m_pays, store.size + valid.sum(), q)


def multi_merge_flush_flagged(store: MultiStore, words, val_hi, val_lo,
                              valid, val_q=None):
    """`multi_merge_flush` for a spec whose keys may equal the sentinel
    (k = 16 / 32 / 64 DNA): a liveness flag (0 live, 1 dead) rides the K2
    merge as a leading key column, so dead rows sort last without marking
    the key bits — w + 1 key columns.  Returns (new_store, overflow)."""
    cap = store.capacity
    b_pays = (val_hi, val_lo) + (() if val_q is None else (_qbits(val_q),))
    a_pays = (store.val_hi, store.val_lo) + (
        () if val_q is None else (_qbits(store.val_q),))
    b_cols, b_pays, b_valid = sortops.sort_rows(
        words, b_pays, valid, is_stable=False, sentinel_ok=False, as_cols=True)
    a_flag = (torch.arange(cap, device=words.device) >= store.size)
    a_keys = torch.cat([a_flag.to(torch.int32)[None], store.keys])
    b_keys = torch.cat([(~b_valid).to(torch.int32)[None], b_cols])
    m_cols, m_pays = sortops.merge_sorted_runs_cols(a_keys, a_pays,
                                                    b_keys, b_pays)
    total = store.size + valid.sum()
    live = torch.arange(cap, device=words.device) < total
    keys = torch.where(live[None, :], m_cols[1:, :cap], SENTINEL)
    q = None if val_q is None else m_pays[2].view(torch.float32)
    return _cut(store, keys, m_pays, total, q)


def multi_query_aux(store: MultiStore, tbits: int = 16):
    """Per-store-version query metadata: (ext int32[w + 1, cap] — the key
    columns plus each row's key-run length, bstart int32[2^tbits + 1] —
    prefix-bucket starts of word 0).  Run lengths come from the head flags
    through a cumsum and gathers (the JAX package's cummax / cummin pair is
    a slow single-block scan on CUDA)."""
    cap = store.capacity
    neq_prev, neq_next = _adjacent_neq(store.keys)
    idx = torch.arange(cap, device=store.keys.device)
    run_id = torch.cumsum(neq_prev, 0) - 1
    runlen = ((idx + 1)[neq_next] - idx[neq_prev])[run_id]
    ext = torch.cat([store.keys, runlen.to(torch.int32)[None]])
    return ext, sortops._prefix_starts(store.keys[0], tbits)


def multi_lookup_ranges_aux(store: MultiStore, ext: torch.Tensor,
                            bstart: torch.Tensor, queries: torch.Tensor):
    """(lo, hi) int64[m]: the rows [lo, hi) holding query row [m, w]'s
    pairs, from cached aux metadata: a bucket-seeded lower_bound (the
    bucket table's width read from its length) and one fused [w + 1, m]
    gather of the key words and the run length.  The JAX package routes
    batches with m * 8 >= cap to a sort-merge join; the answers are the
    same."""
    w, cap = store.keys.shape
    size = store.size.to(torch.int64)
    tbits = (bstart.shape[0] - 1).bit_length() - 1
    b = to_u64(queries[:, 0]) >> (32 - tbits)
    lo = sortops._bsearch_rounds(
        store.keys, queries, torch.minimum(bstart[b].to(torch.int64), size),
        torch.minimum(bstart[b + 1].to(torch.int64), size))
    g = ext[:, lo.clamp(0, cap - 1)]
    hit = lo < size
    for j in range(w):
        hit &= g[j] == queries[:, j]
    return lo, torch.where(hit, torch.minimum(lo + g[w], size), lo)


def multi_lookup_ranges(store: MultiStore, queries: torch.Tensor):
    """(lo, hi) of each query, building the aux metadata for this call."""
    return multi_lookup_ranges_aux(store, *multi_query_aux(store), queries)


def multi_count(store: MultiStore, queries: torch.Tensor) -> torch.Tensor:
    """Pairs per query key (int64[m])."""
    lo, hi = multi_lookup_ranges(store, queries)
    return hi - lo


def multi_gather(store: MultiStore, lo, hi, max_per_query: int):
    """(val_hi, val_lo, val_q, mask), each [m, max_per_query]: the first
    max_per_query pairs of each range [lo, hi); entries past the range are
    masked out."""
    offs = torch.arange(max_per_query, device=lo.device)[None, :]
    idx = lo[:, None] + offs
    mask = idx < hi[:, None]
    idx = idx.clamp(0, store.capacity - 1)
    return store.val_hi[idx], store.val_lo[idx], store.val_q[idx], mask


def multi_erase(store: MultiStore, queries, qvalid, aux=None):
    """Remove ALL pairs whose key equals a valid query key; the kept pairs
    stay in order.  aux: the store's `multi_query_aux`, if cached.
    Returns (new_store, n_erased 0-d)."""
    cap = store.capacity
    dev = store.keys.device
    lo, hi = (multi_lookup_ranges(store, queries) if aux is None
              else multi_lookup_ranges_aux(store, *aux, queries))
    one = qvalid.to(torch.int32)
    # mark the [lo, hi) ranges: +1 / -1 at their ends, then a prefix sum
    diff = torch.zeros(cap + 1, dtype=torch.int32, device=dev)
    diff.index_add_(0, torch.where(qvalid, lo, 0), one)
    diff.index_add_(0, torch.where(qvalid, hi, 0), -one)
    covered = torch.cumsum(diff[:cap], 0) > 0
    rows = torch.nonzero((torch.arange(cap, device=dev) < store.size)
                         & ~covered).squeeze(1)
    n = rows.shape[0]
    keys = torch.full_like(store.keys, SENTINEL)
    keys[:, :n] = store.keys[:, rows]
    vals = []
    for v in (store.val_hi, store.val_lo, store.val_q):
        out = torch.zeros_like(v)
        out[:n] = v[rows]
        vals.append(out)
    new_size = torch.tensor(n, dtype=torch.int32, device=dev)
    return MultiStore(keys, *vals, new_size), store.size - new_size


def multi_distinct(store: MultiStore) -> torch.Tensor:
    """0-d: distinct keys among the live rows (map_base::unique_size)."""
    neq_prev, _ = _adjacent_neq(store.keys)
    live = torch.arange(store.capacity, device=store.keys.device) < store.size
    return (neq_prev & live).sum()
