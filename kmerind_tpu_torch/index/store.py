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
sorted batch into it with K2.  A `RunBimolStore` is a `RunCountStore`
with each row's occurrence id and strand (the Bimolecule preset: K2 with
4 payloads, K3), and a `KVStore` the unique-key k-mer -> 64-bit value
map (one stable sort of store and batch per insert).

One shard's store has the shapes given in its class; an index of p shards
stacks them on a leading axis ([p, ...], `shard` takes one apart).

User predicates (erase_if / filter / count_if) see every key word and id
half as an int64 holding its unsigned value, keys row-major [n, w]
(`pred_keys`): the int32 bit patterns the store holds would compare
signed.

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
           "count_lookup", "count_erase", "count_keep", "count_filter",
           "count_select", "count_histogram", "histogram_of", "cleared",
           "pred_keys",
           "RunCountStore", "empty_run_count_store", "run_from_sorted",
           "run_merge", "run_from_sorted_unit", "run_merge_unit",
           "run_totals", "run_distinct", "run_query_aux", "run_lookup_aux",
           "run_erase_cover", "run_filter", "run_select", "run_histogram",
           "run_compact", "run_grow", "stack_run_stores",
           "RunBimolStore", "empty_run_bimol_store", "run_bimol_from_sorted",
           "run_bimol_merge", "run_bimol_strands", "run_bimol_find_aux",
           "run_bimol_export", "run_bimol_compact",
           "MultiStore", "empty_multi_store", "stack_multi_stores",
           "multi_grow", "multi_insert", "multi_merge_flush",
           "multi_merge_flush_flagged", "multi_query_aux",
           "multi_lookup_ranges_aux", "multi_lookup_ranges", "multi_count",
           "multi_gather", "multi_keep", "multi_erase", "multi_filter",
           "multi_select",
           "multi_distinct",
           "RunVecStore", "RunVecQStore", "empty_run_vec_store",
           "empty_run_vecq_store", "stack_stores", "run_vec_from_sorted",
           "run_vec_from_sorted_unit", "run_vec_merge", "run_vec_merge_unit",
           "run_vecq_from_sorted", "run_vecq_from_sorted_unit",
           "run_vecq_merge", "run_vecq_merge_unit", "run_vec_with_table",
           "run_vec_distinct", "run_vec_query_aux", "run_vec_lookup",
           "run_vec_export", "run_vec_compact", "run_vec_grow",
           "KVStore", "empty_kv_store", "kv_grow", "kv_reduce", "kv_insert",
           "kv_cut", "kv_lookup", "kv_keep", "kv_erase", "kv_filter",
           "kv_select"]


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

    @property
    def capacity(self) -> int:
        return self.keys.shape[-2]

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


def pred_keys(kcols: torch.Tensor) -> torch.Tensor:
    """Column-major int32-held key words [w, n] -> the [n, w] int64 rows
    (unsigned values) a user predicate sees."""
    return to_u64(kcols).t()


def _live(size, cap: int, device) -> torch.Tensor:
    return torch.arange(cap, device=device) < size


def count_keep(store: CountStore, keep: torch.Tensor):
    """One shard with only its live rows where `keep`, in order.  Returns
    (new_store, n_removed 0-d)."""
    keep = keep & _live(store.size, store.keys.shape[0], store.keys.device)
    rows = torch.nonzero(keep).squeeze(1)
    keys = torch.full_like(store.keys, SENTINEL)
    counts = torch.zeros_like(store.counts)
    keys[: rows.shape[0]] = store.keys[rows]
    counts[: rows.shape[0]] = store.counts[rows]
    new_size = torch.tensor(rows.shape[0], dtype=torch.int32,
                            device=store.keys.device)
    return CountStore(keys, counts, new_size), store.size - new_size


def count_erase(store: CountStore, queries: torch.Tensor,
                qvalid: torch.Tensor):
    """Remove the valid query keys from one shard; the kept rows stay in
    order.  Returns (new_store, n_erased 0-d)."""
    cap = store.keys.shape[0]
    idx = sortops.lower_bound_bucketed(store.keys, store.size, queries)
    hit = sortops.rows_equal_at(store.keys, idx, queries, store.size) & qvalid
    kill = torch.zeros(cap + 1, dtype=torch.bool, device=store.keys.device)
    kill[torch.where(hit, idx, cap)] = True
    return count_keep(store, ~kill[:cap])


def count_filter(store: CountStore, keep_pred):
    """One shard without the entries whose (key, count) fails
    keep_pred(keys int64[cap, w], counts int32[cap]) -> bool[cap].
    Returns (new_store, n_removed 0-d)."""
    return count_keep(store, keep_pred(to_u64(store.keys), store.counts))


def count_select(store: CountStore, pred):
    """(keys int32[t, w], counts int32[t]) of one shard's live entries
    satisfying pred(keys int64[cap, w], counts int32[cap]) -> bool[cap], in
    key order."""
    live = _live(store.size, store.keys.shape[0], store.keys.device)
    emit = pred(to_u64(store.keys), store.counts) & live
    return store.keys[emit], store.counts[emit]


def histogram_of(counts: torch.Tensor, live: torch.Tensor,
                 nbins: int) -> torch.Tensor:
    """int64[nbins]: how many live entries have each count, counts >=
    nbins - 1 in the last bin."""
    bins = counts[live].to(torch.int64).clamp(0, nbins - 1)
    return torch.bincount(bins, minlength=nbins)


def count_histogram(store: CountStore, nbins: int) -> torch.Tensor:
    """int64[nbins] spectrum of one shard's live counts (`histogram_of`)."""
    return histogram_of(store.counts, _live(store.size, store.keys.shape[0],
                                            store.keys.device), nbins)


def cleared(store):
    """A store (any kind, one shard or stacked) of the same capacity with
    no entries: sentinel keys, every other field zero."""
    fields = {}
    for f in dataclasses.fields(store):
        v = getattr(store, f.name)
        fields[f.name] = (torch.full_like(v, SENTINEL) if f.name == "keys"
                          else torch.zeros_like(v))
    return type(store)(**fields)


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


def _reweighted(store, weights: torch.Tensor):
    """The run (a `RunCountStore` or a `RunBimolStore`) with new weights and
    their prefix sum rebuilt (K3); every other column as it was."""
    return dataclasses.replace(store, weights=weights,
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


def _run_find(ext: torch.Tensor, bstart: torch.Tensor,
              queries: torch.Tensor):
    """(lo int64[m] — the first row of each query key's run, hit bool[m],
    total int32[m] — its run total, 0 when absent) against cached aux
    metadata: one bucket-seeded lower_bound plus one fused [w + 1, m]
    gather."""
    w = ext.shape[0] - 1
    cap = ext.shape[1]
    lo = sortops.lower_bound_cols_prebuilt(ext, w, bstart, queries)
    g = ext[:, lo.clamp(0, cap - 1)]
    hit = lo < cap
    for j in range(w):
        hit &= g[j] == queries[:, j]
    return lo, hit, torch.where(hit, g[w], 0)


def run_lookup_aux(ext: torch.Tensor, bstart: torch.Tensor,
                   queries: torch.Tensor) -> torch.Tensor:
    """int32[m] count per query row [m, w] against cached aux metadata."""
    return _run_find(ext, bstart, queries)[2]


def run_erase_cover(store, ext: torch.Tensor,
                    bstart: torch.Tensor, queries: torch.Tensor,
                    qvalid: torch.Tensor) -> RunCountStore:
    """Zero the weights of every row whose key equals a valid query row
    (the mutation half of erase; the caller counts the distinct keys
    erased over all runs) and rebuild the prefix sum (K3).  The rows stay
    in place, so the run stays sorted; `run_compact` reclaims them.  ext,
    bstart: the run's `run_query_aux`.  A `RunBimolStore` keeps its
    representatives (a weight-0 row never wins their minimum)."""
    lo, hit, _ = _run_find(ext, bstart, queries)
    neq_prev, _ = _adjacent_neq(store.keys)
    # a hit's lo is the head of its key's run: mark the run, then every row
    # of a marked run through its run index
    marked = torch.zeros(store.capacity + 1, dtype=torch.bool,
                         device=store.keys.device)
    marked[torch.where(hit & qvalid, lo, store.capacity)] = True
    run_id = torch.cumsum(neq_prev, 0) - 1
    covered = marked[:-1][neq_prev][run_id]
    return _reweighted(store, torch.where(covered, 0, store.weights))


def _clamped_totals(store: RunCountStore, saturate: int | None):
    """run_totals with each run's total, as readers see it, clamped at
    `saturate` (None: unclamped) beside the raw one."""
    is_head, is_last, total = run_totals(store)
    seen = total if saturate is None else total.clamp(max=saturate)
    return is_head, is_last, total, seen


def run_filter(store, keep_pred, saturate: int | None = None):
    """erase_if / filter over one run (a `RunCountStore` or a
    `RunBimolStore`): every row of a key whose (key, count) fails
    keep_pred(keys int64[cap, w], counts int32[cap]) -> bool[cap] gets
    weight 0, the prefix sum is rebuilt (K3).  Counts are the run totals
    clamped at `saturate`.  Returns (new_store, distinct keys removed
    0-d)."""
    _, is_last, total, seen = _clamped_totals(store, saturate)
    kill = (total > 0) & ~keep_pred(pred_keys(store.keys), seen)
    return (_reweighted(store, torch.where(kill, 0, store.weights)),
            (is_last & kill).sum())


def run_select(store: RunCountStore, pred=None,
               saturate: int | None = None):
    """(keys int32[t, w], counts int32[t]) of one run's distinct live keys
    whose (key, count) satisfies pred (as in `run_filter`; None: every
    one), in key order, the counts clamped at `saturate`."""
    _, is_last, total, seen = _clamped_totals(store, saturate)
    emit = is_last & (total > 0)
    if pred is not None:
        emit &= pred(pred_keys(store.keys), seen)
    return store.keys[:, emit].t(), seen[emit]


def run_histogram(store: RunCountStore, nbins: int,
                  saturate: int | None = None) -> torch.Tensor:
    """int64[nbins] spectrum of one run: distinct live keys per count
    (clamped at `saturate`), counts >= nbins - 1 in the last bin."""
    _, is_last, total, seen = _clamped_totals(store, saturate)
    return histogram_of(seen, is_last & (total > 0), nbins)


#: fill of each run column's padding rows (`run_grow`): no key, weight 0,
#: no representative
_RUN_PAD = {"keys": SENTINEL, "rep_hi": SENTINEL, "rep_lo": SENTINEL}


def run_grow(store, pad: int):
    """The run (a `RunCountStore` or a `RunBimolStore`, one shard or
    stacked) with `pad` more rows: sentinel keys of weight 0 (and sentinel
    representatives), the prefix sum carried flat."""
    fields = {}
    for f in dataclasses.fields(store):
        v = getattr(store, f.name)
        if f.name == "csum":
            last = v[..., -1:]
            fields[f.name] = torch.cat(
                [v, last.expand(last.shape[:-1] + (pad,))], dim=-1)
        else:
            fields[f.name] = torch.nn.functional.pad(
                v, (0, pad), value=_RUN_PAD.get(f.name, 0))
    return type(store)(**fields)


def run_compact(store: RunCountStore, new_cap: int,
                saturate: int | None = None):
    """Collapse every key run to one (key, total) row, live rows first in
    key order, at capacity `new_cap`, the totals clamped at `saturate`
    (exact for a saturating map: min(min(a, s) + b, s) == min(a + b, s)
    for b >= 0).  Returns (new_store, overflow) with overflow = distinct -
    new_cap when positive (the store is then cut and the caller retries
    larger)."""
    w = store.keys.shape[0]
    _, is_last, raw, total = _clamped_totals(store, saturate)
    emit = torch.nonzero(is_last & (raw > 0)).squeeze(1)
    n_emit = emit.shape[0]
    keep = emit[:new_cap]
    keys = torch.full((w, new_cap), SENTINEL, dtype=torch.int32,
                      device=store.keys.device)
    totals = torch.zeros(new_cap, dtype=torch.int32, device=store.keys.device)
    keys[:, : keep.shape[0]] = store.keys[:, keep]
    totals[: keep.shape[0]] = total[keep]
    return run_from_sorted(keys, totals), max(n_emit - new_cap, 0)


# ------------------------------------------------ run-layout Bimolecule map
@dataclasses.dataclass
class RunBimolStore(RunCountStore):
    """Bimolecule counting store in RUN layout (``kmerind_tpu.index.store.
    RunBimolStore``): a `RunCountStore` — canonical keys sorted with
    duplicates, weights, the count prefix sum, so the count family's
    totals, queries, erase, filter, histogram and select serve it as they
    are — plus each row's occurrence id (``rep_hi`` / ``rep_lo``, the
    uint32 halves of a 64-bit id) and strand (``rep_strand``, 1 where the
    input k-mer was the reverse complement of its canonical key).

    The Bimolecule preset (kmer_index.hpp:436-562) reports each key in the
    input orientation of its first occurrence: the live row of the key's
    run with the smallest id (`_segmented_min_rep`) supplies it.  Dead rows
    (weight 0) never win; padding rows hold sentinel keys and ids.  File
    ids use at most 63 bits and explicit inserts count up from 2^63, so
    ids compare as UNSIGNED 64-bit values.

    One shard: keys int32[w, cap], weights / rep_hi / rep_lo / rep_strand
    int32[cap], csum int32[cap + 1]; p shards stack [p, ...]."""

    rep_hi: torch.Tensor
    rep_lo: torch.Tensor
    rep_strand: torch.Tensor

    def shard(self, s: int) -> "RunBimolStore":
        return RunBimolStore(*(getattr(self, f.name)[s]
                               for f in dataclasses.fields(self)))


def empty_run_bimol_store(capacity: int, nwords: int,
                          device) -> RunBimolStore:
    base = empty_run_count_store(capacity, nwords, device)
    sent = torch.full((capacity,), SENTINEL, dtype=torch.int32,
                      device=device)
    return RunBimolStore(**vars(base), rep_hi=sent, rep_lo=sent.clone(),
                         rep_strand=torch.zeros_like(sent))


def run_bimol_from_sorted(kcols, weights, rep_hi, rep_lo,
                          rep_strand) -> RunBimolStore:
    """Adopt an already-sorted weighted run with its representative columns
    (the prefix sum is K3)."""
    wt = weights.to(torch.int32)
    return RunBimolStore(keys=kcols, weights=wt,
                         csum=_exclusive(_cumsum_i32(wt)),
                         rep_hi=rep_hi.to(torch.int32),
                         rep_lo=rep_lo.to(torch.int32),
                         rep_strand=rep_strand.to(torch.int32))


def run_bimol_merge(a: RunBimolStore, b: RunBimolStore) -> RunBimolStore:
    """Merge two Bimolecule runs: K2 with the weights, both id halves and
    the strand as its 4 payloads, then the prefix sum (K3).  Capacity
    next_pow2(cap_a + cap_b)."""
    pays = lambda r: (r.weights, r.rep_hi, r.rep_lo, r.rep_strand)  # noqa: E731
    keys, m = sortops.merge_sorted_runs_cols(a.keys, pays(a), b.keys, pays(b))
    return run_bimol_from_sorted(keys, *m)


_I64_MIN = torch.iinfo(torch.int64).min
_I64_MAX = torch.iinfo(torch.int64).max


def _segmented_min_rep(store: RunBimolStore):
    """(rep_hi, rep_lo, rep_strand) int32[cap]: each row's key-run minimum
    representative — the live row with the smallest unsigned 64-bit id, the
    first such row on a tie — broadcast over the run.  The id packs into
    one int64 biased by 2^63 (signed order = unsigned order; a dead row's
    is the sentinel's, INT64_MAX), one `scatter_reduce` "amin" per run
    index (a cumsum of the head flags) gives each run's minimum, a second
    over the row indices that hold it gives the first, and one gather
    broadcasts its strand.  A run with no live row reports sentinel ids and
    strand 0, as the JAX package's associative scan does.  No cummin: a
    single-block scan on CUDA."""
    cap = store.capacity
    dev = store.keys.device
    live = store.weights > 0
    key = ((to_u64(store.rep_hi) << 32) | to_u64(store.rep_lo)) ^ _I64_MIN
    key = torch.where(live, key, _I64_MAX)
    neq_prev, _ = _adjacent_neq(store.keys)
    run_id = torch.cumsum(neq_prev, 0) - 1
    rmin = torch.full((cap,), _I64_MAX, dtype=torch.int64,
                      device=dev).scatter_reduce(0, run_id, key, "amin")
    rmin = rmin[run_id]
    rows = torch.arange(cap, device=dev)
    first = torch.full((cap,), cap, dtype=torch.int64,
                       device=dev).scatter_reduce(
        0, run_id, torch.where(key == rmin, rows, cap), "amin")
    strand = torch.where(live, store.rep_strand, 0)[first[run_id]]
    ident = rmin ^ _I64_MIN
    return (ident >> 32).to(torch.int32), ident.to(torch.int32), strand


def run_bimol_strands(store: RunBimolStore) -> torch.Tensor:
    """int32[cap]: each row's stored orientation (the strand of its run's
    minimum representative) — built once per run version, beside its
    `run_query_aux`, for find."""
    return _segmented_min_rep(store)[2]


def run_bimol_find_aux(ext: torch.Tensor, bstart: torch.Tensor,
                       strands: torch.Tensor, queries: torch.Tensor,
                       saturate: int | None = None):
    """(counts int32[m], strand int32[m]) per canonical query row [m, w]:
    the count (clamped at `saturate`) and the stored orientation of each
    key present, 0 / 0 where absent (the device half of Bimolecule find).
    ext, bstart: the run's `run_query_aux`; strands: `run_bimol_strands`."""
    lo, hit, total = _run_find(ext, bstart, queries)
    counts = total if saturate is None else total.clamp(max=saturate)
    at = lo.clamp(0, strands.shape[0] - 1)
    return counts, torch.where(hit & (counts > 0), strands[at], 0)


def run_bimol_export(store: RunBimolStore, saturate: int | None = None):
    """(keys int32[t, w], counts int32[t], strand int32[t]): one row per
    distinct live key, in key order — its canonical words, count (clamped
    at `saturate`) and stored orientation."""
    _, is_last, total, seen = _clamped_totals(store, saturate)
    emit = is_last & (total > 0)
    strand = run_bimol_strands(store)
    return store.keys[:, emit].t(), seen[emit], strand[emit]


def run_bimol_compact(store: RunBimolStore, new_cap: int,
                      saturate: int | None = None):
    """Collapse every key run to one (key, total, minimum representative)
    row, live rows first in key order, at capacity `new_cap`, the totals
    clamped at `saturate`.  Returns (new_store, overflow = distinct -
    new_cap when positive: the store is then cut and the caller retries
    larger)."""
    w = store.keys.shape[0]
    dev = store.keys.device
    _, is_last, raw, total = _clamped_totals(store, saturate)
    mhi, mlo, mst = _segmented_min_rep(store)
    emit = torch.nonzero(is_last & (raw > 0)).squeeze(1)
    keep = emit[:new_cap]
    n = keep.shape[0]
    keys = torch.full((w, new_cap), SENTINEL, dtype=torch.int32, device=dev)
    keys[:, :n] = store.keys[:, keep]
    cols = []
    for src, fill in ((total, 0), (mhi, SENTINEL), (mlo, SENTINEL),
                      (mst, 0)):
        c = torch.full((new_cap,), fill, dtype=torch.int32, device=dev)
        c[:n] = src[keep]
        cols.append(c)
    return run_bimol_from_sorted(keys, *cols), max(emit.shape[0] - new_cap,
                                                   0)


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


def _runlen_aux(kcols: torch.Tensor, tbits: int = 16):
    """Query metadata of sorted key columns [w, cap]: (ext int32[w + 1,
    cap] — the key columns plus each row's key-run length, bstart
    int32[2^tbits + 1] — prefix-bucket starts of word 0).  Run lengths come
    from the head flags through a cumsum and gathers (the JAX package's
    cummax / cummin pair is a slow single-block scan on CUDA)."""
    cap = kcols.shape[1]
    neq_prev, neq_next = _adjacent_neq(kcols)
    idx = torch.arange(cap, device=kcols.device)
    run_id = torch.cumsum(neq_prev, 0) - 1
    runlen = ((idx + 1)[neq_next] - idx[neq_prev])[run_id]
    ext = torch.cat([kcols, runlen.to(torch.int32)[None]])
    return ext, sortops._prefix_starts(kcols[0], tbits)


def multi_query_aux(store: MultiStore, tbits: int = 16):
    """Per-store-version query metadata (`_runlen_aux` of the keys)."""
    return _runlen_aux(store.keys, tbits)


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


def _multi_pred(store: MultiStore, pred) -> torch.Tensor:
    """pred(keys int64[cap, w], id_hi int64[cap], id_lo int64[cap],
    qual float32[cap]) -> bool[cap] over one shard's rows."""
    return pred(pred_keys(store.keys), to_u64(store.val_hi),
                to_u64(store.val_lo), store.val_q)


def multi_keep(store: MultiStore, keep: torch.Tensor):
    """One shard with only its live pairs where `keep`, in order (the same
    capacity).  Returns (new_store, n_removed 0-d)."""
    dev = store.keys.device
    rows = torch.nonzero(keep & _live(store.size, store.capacity,
                                      dev)).squeeze(1)
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


def multi_erase(store: MultiStore, queries, qvalid, aux=None, pred=None):
    """Remove the pairs whose key equals a valid query key — all of them,
    or with `pred` (as in `_multi_pred`) those satisfying it (the keyed
    erase_if); the kept pairs stay in order.  aux: the store's
    `multi_query_aux`, if cached.  Returns (new_store, n_erased 0-d)."""
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
    if pred is not None:
        covered &= _multi_pred(store, pred)
    return multi_keep(store, ~covered)


def multi_filter(store: MultiStore, keep_pred):
    """One shard without the pairs failing keep_pred (as in
    `_multi_pred`).  Returns (new_store, n_removed 0-d)."""
    return multi_keep(store, _multi_pred(store, keep_pred))


def multi_select(store: MultiStore, pred):
    """(keys int32[t, w], matches int64[t]): each distinct key of one shard
    with at least one pair satisfying pred (as in `_multi_pred`), in key
    order, with its number of such pairs."""
    live = _live(store.size, store.capacity, store.keys.device)
    match = _multi_pred(store, pred) & live
    neq_prev, _ = _adjacent_neq(store.keys)
    head = neq_prev & live
    run_id = torch.cumsum(head, 0) - 1
    heads = torch.nonzero(head).squeeze(1)
    matches = torch.bincount(run_id[match], minlength=heads.shape[0])
    sel = matches > 0
    return store.keys[:, heads[sel]].t(), matches[sel]


def multi_distinct(store: MultiStore) -> torch.Tensor:
    """0-d: distinct keys among the live rows (map_base::unique_size)."""
    neq_prev, _ = _adjacent_neq(store.keys)
    live = torch.arange(store.capacity, device=store.keys.device) < store.size
    return (neq_prev & live).sum()


# --------------------------------------------------- de Bruijn node stores
@dataclasses.dataclass
class RunVecStore:
    """De Bruijn node store in RUN layout (``kmerind_tpu.index.store.
    RunVecStore``): keys sorted over all rows with duplicates allowed,
    per-row (edge byte, weight) payloads and a [9, cap] INCLUSIVE
    prefix-sum table of the counter contributions, one stream per counter.

    Row i adds ``weights[i] * bit_j(ebytes[i])`` to counter j (j < 8: out
    A, C, G, T, in A, C, G, T — one increment per set DNA16 bit,
    edge_counts::update, de_bruijn_node_trait.hpp:195-245) and
    ``weights[i]`` to the self counter (j = 8); a node's counters are the
    table's difference across its key run.  Padding rows hold the all-ones
    sentinel with weight 0 and edge byte 0 (weight-0 rows change no
    counter).

    One shard: keys int32[w, cap] (uint32 words, column-major), ebytes /
    weights int32[cap], bsum int32[9, cap] — or None on a LAZY run (an
    intermediate LSM run; `run_vec_with_table` builds it when a query,
    export or save needs it).  p shards stack [p, ...] (`stack_stores`)."""

    keys: torch.Tensor
    ebytes: torch.Tensor
    weights: torch.Tensor
    bsum: torch.Tensor | None

    @property
    def capacity(self) -> int:
        return self.keys.shape[-1]

    def shard(self, s: int):
        return type(self)(**{f.name: None if getattr(self, f.name) is None
                             else getattr(self, f.name)[s]
                             for f in dataclasses.fields(self)})


@dataclasses.dataclass
class RunVecQStore(RunVecStore):
    """`RunVecStore` with each row's windowed-quality sum (qsums
    float32[cap]) and its INCLUSIVE prefix sum (qcsum, None on a lazy run)
    — the quality de Bruijn graph's node store.  The JAX package keeps
    qcsum in float32: a node's sum is the difference of two prefixes whose
    float32 spacing grows with the run's total until it rivals the node's
    sum; the port keeps it in float64."""

    qsums: torch.Tensor
    qcsum: torch.Tensor | None


def stack_stores(stores):
    """Per-shard stores of one kind and capacity -> the stacked [p, ...]
    store (a lazy run's None tables stay None)."""
    first = stores[0]
    return type(first)(**{
        f.name: None if getattr(first, f.name) is None
        else stack([getattr(x, f.name) for x in stores])
        for f in dataclasses.fields(first)})


def empty_run_vec_store(capacity: int, nwords: int, device) -> RunVecStore:
    zeros = torch.zeros(capacity, dtype=torch.int32, device=device)
    return RunVecStore(
        keys=torch.full((nwords, capacity), SENTINEL, dtype=torch.int32,
                        device=device),
        ebytes=zeros, weights=zeros.clone(),
        bsum=torch.zeros((9, capacity), dtype=torch.int32, device=device))


def empty_run_vecq_store(capacity: int, nwords: int, device) -> RunVecQStore:
    base = empty_run_vec_store(capacity, nwords, device)
    return RunVecQStore(
        **vars(base),
        qsums=torch.zeros(capacity, dtype=torch.float32, device=device),
        qcsum=torch.zeros(capacity, dtype=torch.float64, device=device))


def _vec_bsum(ebytes: torch.Tensor, weights: torch.Tensor) -> torch.Tensor:
    """int32[9, cap] inclusive prefix sums of the rows' counter
    contributions: nine K3 launches, one per stream."""
    cols = [_cumsum_i32(((ebytes >> j) & 1) * weights) for j in range(8)]
    return torch.stack(cols + [_cumsum_i32(weights)])


def _vec_bsum_unit(ebytes: torch.Tensor, n_live) -> torch.Tensor:
    """[9, cap] table of a UNIT run (weight 1 per live row, the live rows
    first, dead rows with edge byte 0): eight K3 launches over the bit
    streams, no weight multiply, and the closed-form self stream
    min(i + 1, n_live)."""
    n = ebytes.shape[0]
    cols = [_cumsum_i32((ebytes >> j) & 1) for j in range(8)]
    idx = torch.arange(1, n + 1, dtype=torch.int32, device=ebytes.device)
    return torch.stack(cols + [torch.minimum(idx, n_live.to(torch.int32))])


def _qcsum(qsums: torch.Tensor) -> torch.Tensor:
    return torch.cumsum(qsums.to(torch.float64), 0)


def run_vec_from_sorted(kcols, ebytes, weights,
                        table: bool = True) -> RunVecStore:
    """Adopt an already-sorted (sentinel-padded) weighted edge run; its
    table is built now (K3) or, table=False, deferred."""
    eb, wt = ebytes.to(torch.int32), weights.to(torch.int32)
    return RunVecStore(keys=kcols, ebytes=eb, weights=wt,
                       bsum=_vec_bsum(eb, wt) if table else None)


def run_vecq_from_sorted(kcols, ebytes, weights, qsums,
                         table: bool = True) -> RunVecQStore:
    """`run_vec_from_sorted` with the quality sums."""
    qs = qsums.to(torch.float32)
    return RunVecQStore(**vars(run_vec_from_sorted(kcols, ebytes, weights,
                                                   table)),
                        qsums=qs, qcsum=_qcsum(qs) if table else None)


def _unit_run(kcols, ebytes, n_live, table: bool) -> RunVecStore:
    """A UNIT edge run: weight 1 on the first n_live rows."""
    eb = ebytes.to(torch.int32)
    n = kcols.shape[1]
    live = torch.arange(n, device=kcols.device) < n_live
    return RunVecStore(keys=kcols, ebytes=eb, weights=live.to(torch.int32),
                       bsum=_vec_bsum_unit(eb, n_live) if table else None)


def run_vec_from_sorted_unit(kcols, ebytes, weights,
                             table: bool = True) -> RunVecStore:
    """Adopt a sorted UNIT edge run (file-ingest output: weight 1 per live
    row, sentinel tail, dead edge bytes 0)."""
    return _unit_run(kcols, ebytes, weights.to(torch.int32).sum(), table)


def run_vecq_from_sorted_unit(kcols, ebytes, weights, qsums,
                              table: bool = True) -> RunVecQStore:
    """`run_vec_from_sorted_unit` with the quality sums (0.0 on dead
    rows)."""
    qs = qsums.to(torch.float32)
    return RunVecQStore(**vars(run_vec_from_sorted_unit(kcols, ebytes,
                                                        weights, table)),
                        qsums=qs, qcsum=_qcsum(qs) if table else None)


def run_vec_merge(a: RunVecStore, b: RunVecStore,
                  table: bool = True) -> RunVecStore:
    """Merge two edge runs: K2 with the edge byte and the weight as its 2
    payloads (3 with the quality bits), then the tables (K3) unless
    table=False.  Capacity next_pow2(cap_a + cap_b)."""
    q = isinstance(a, RunVecQStore)
    pays = lambda r: (r.ebytes, r.weights) + (  # noqa: E731
        (_qbits(r.qsums),) if q else ())
    keys, m = sortops.merge_sorted_runs_cols(a.keys, pays(a), b.keys, pays(b))
    if q:
        return run_vecq_from_sorted(keys, m[0], m[1],
                                    m[2].view(torch.float32), table)
    return run_vec_from_sorted(keys, m[0], m[1], table)


def run_vec_merge_unit(a: RunVecStore, b: RunVecStore,
                       table: bool = True) -> RunVecStore:
    """Merge two UNIT edge runs: the weight column does not ride K2 (1
    payload, the edge byte; 2 with the quality bits); the weights and the
    self stream come back in closed form from the operands' live totals
    (the sums of their weights)."""
    q = isinstance(a, RunVecQStore)
    pays = lambda r: (r.ebytes,) + (  # noqa: E731
        (_qbits(r.qsums),) if q else ())
    keys, m = sortops.merge_sorted_runs_cols(a.keys, pays(a), b.keys, pays(b))
    run = _unit_run(keys, m[0], a.weights.sum() + b.weights.sum(), table)
    if not q:
        return run
    qs = m[1].view(torch.float32)
    return RunVecQStore(**vars(run), qsums=qs,
                        qcsum=_qcsum(qs) if table else None)


#: the quality store's merges: `run_vec_merge` / `run_vec_merge_unit` carry
#: the quality bits of a `RunVecQStore` (the JAX package's separate twins)
run_vecq_merge = run_vec_merge
run_vecq_merge_unit = run_vec_merge_unit


def run_vec_with_table(store: RunVecStore, unit: bool = False) -> RunVecStore:
    """A LAZY run with its tables built: nine K3 launches, eight for a UNIT
    run (its self stream in closed form; the JAX package's lazy tables
    always take nine); a run that has them comes back as it is."""
    if store.bsum is not None:
        return store
    bsum = (_vec_bsum_unit(store.ebytes, store.weights.sum()) if unit
            else _vec_bsum(store.ebytes, store.weights))
    fields = dict(vars(store), bsum=bsum)
    if isinstance(store, RunVecQStore):
        fields["qcsum"] = _qcsum(store.qsums)
    return type(store)(**fields)


def _run_bounds(kcols: torch.Tensor):
    """(heads int64[r], lasts int64[r]): the first and last row of every
    run of equal keys, in order."""
    neq_prev, neq_next = _adjacent_neq(kcols)
    return torch.nonzero(neq_prev).squeeze(1), torch.nonzero(neq_next).squeeze(1)


def _diff_at(incl: torch.Tensor, heads, lasts) -> torch.Tensor:
    """Sum over each run [head, last] of the stream whose inclusive prefix
    is `incl` ([..., cap]): incl at the last row minus incl before the
    head (0 at row 0)."""
    before = incl[..., (heads - 1).clamp(min=0)]
    return incl[..., lasts] - torch.where(heads > 0, before, 0)


def run_vec_distinct(store: RunVecStore) -> torch.Tensor:
    """0-d: distinct keys with a positive total weight (the graph's node
    count).  Weights are never negative, so a key counts when a row of its
    run is live: no table needed (a consolidated run may never need
    one)."""
    heads, lasts = _run_bounds(store.keys)
    live = torch.cumsum(store.weights > 0, 0, dtype=torch.int32)
    return (_diff_at(live, heads, lasts) > 0).sum()


def run_vec_query_aux(store: RunVecStore, tbits: int = 16):
    """Per-run query metadata (`_runlen_aux` of the keys)."""
    return _runlen_aux(store.keys, tbits)


def run_vec_lookup(store: RunVecStore, queries: torch.Tensor, aux=None):
    """(counts int32[m, 9], qsum float64[m] or None) per query key row
    [m, w], zeros where absent: one bucket-seeded lower_bound, the run
    length from the aux row, and one [9, 2m] gather of the table at both
    run bounds.  qsum: the quality sums' difference likewise (a quality
    store), else None.  aux: the run's `run_vec_query_aux`, if cached."""
    ext, bstart = run_vec_query_aux(store) if aux is None else aux
    w, cap = store.keys.shape
    m = queries.shape[0]
    lo = sortops.lower_bound_cols_prebuilt(ext, w, bstart, queries)
    g = ext[:, lo.clamp(0, cap - 1)]
    hit = lo < cap
    for j in range(w):
        hit &= g[j] == queries[:, j]
    hi = torch.where(hit, torch.clamp(lo + g[w], max=cap), 0)
    bounds = torch.cat([torch.where(hit, lo, 0), hi])
    at = (bounds - 1).clamp(min=0)

    def diff(table):
        v = torch.where(bounds > 0, table[..., at], 0)
        return v[..., m:] - v[..., :m]

    counts = torch.where(hit[:, None], diff(store.bsum).t(), 0)
    qsum = None
    if isinstance(store, RunVecQStore):
        qsum = torch.where(hit, diff(store.qcsum), 0.0)
    return counts, qsum


def run_vec_export(store: RunVecStore, saturate: int | None = None):
    """(keys int32[t, w], counters int32[t, 9], qsum float64[t] or None):
    every distinct key with a positive self total, in key order, its 9
    counters summed over its rows (clamped at `saturate`); qsum the
    quality sum of a quality store."""
    heads, lasts = _run_bounds(store.keys)
    totals = _diff_at(store.bsum, heads, lasts)
    emit = totals[8] > 0
    if saturate is not None:
        totals = totals.clamp(max=saturate)
    qsum = None
    if isinstance(store, RunVecQStore):
        qsum = _diff_at(store.qcsum, heads, lasts)[emit]
    return store.keys[:, lasts[emit]].t(), totals[:, emit].t(), qsum


def run_vec_compact(store: RunVecStore, new_cap: int):
    """Collapse equal (key, edge byte) rows into one weighted row (summing
    the quality sums too), live rows first in key order, at capacity
    `new_cap`, as a LAZY run.  The run is sorted by key already, so one
    int64 sort of (key run index << 8 | edge byte) groups the rows (dead
    rows last), and each group's sums are differences of prefix sums at
    its bounds.  Returns (new_store, overflow = groups - new_cap when
    positive: the store is then cut and the caller retries larger)."""
    w = store.keys.shape[0]
    dev = store.keys.device
    neq_prev, _ = _adjacent_neq(store.keys)
    live = store.weights > 0
    group = (torch.cumsum(neq_prev, 0) << 8) | store.ebytes.to(torch.int64)
    group, order = torch.sort(torch.where(live, group,
                                          torch.iinfo(torch.int64).max))
    heads, lasts = _run_bounds(group[None])
    keep = live[order[lasts]]
    n_emit = int(keep.sum())
    heads, lasts = heads[keep][:new_cap], lasts[keep][:new_cap]
    src = order[lasts]
    n = src.shape[0]
    keys = torch.full((w, new_cap), SENTINEL, dtype=torch.int32, device=dev)
    keys[:, :n] = store.keys[:, src]
    eb = torch.zeros(new_cap, dtype=torch.int32, device=dev)
    eb[:n] = store.ebytes[src]
    wt = torch.zeros_like(eb)
    wt[:n] = _diff_at(torch.cumsum(store.weights[order], 0), heads,
                      lasts).to(torch.int32)
    ovf = max(n_emit - new_cap, 0)
    if not isinstance(store, RunVecQStore):
        return run_vec_from_sorted(keys, eb, wt, table=False), ovf
    qs = torch.zeros(new_cap, dtype=torch.float32, device=dev)
    qs[:n] = _diff_at(_qcsum(store.qsums[order]), heads, lasts).to(
        torch.float32)
    return run_vecq_from_sorted(keys, eb, wt, qs, table=False), ovf


def run_vec_grow(store: RunVecStore, pad: int) -> RunVecStore:
    """The run (one shard or stacked, with its tables) with `pad` more
    rows: sentinel keys of weight 0, the prefix sums carried flat."""
    pad_ = torch.nn.functional.pad

    def flat(t):
        return torch.cat([t, t[..., -1:].expand(t.shape[:-1] + (pad,))], -1)

    fields = dict(vars(store), keys=pad_(store.keys, (0, pad), value=SENTINEL),
                  ebytes=pad_(store.ebytes, (0, pad)),
                  weights=pad_(store.weights, (0, pad)),
                  bsum=flat(store.bsum))
    if isinstance(store, RunVecQStore):
        fields.update(qsums=pad_(store.qsums, (0, pad)),
                      qcsum=flat(store.qcsum))
    return type(store)(**fields)


# ------------------------------------------------ unique-key value map
@dataclasses.dataclass
class KVStore:
    """Unique-key k-mer -> 64-bit value map (``kmerind_tpu.index.store.
    KVStore``; the reference's generic ``KmerIndex = Index<densehash_map<
    Kmer, T>>``, kmer_index.hpp:397-399, and its sorted-map twin).

    One shard: ``keys`` int32[cap, w] ROW-major (uint32 words; the JAX
    layout, so npz files cross-load) sorted and distinct in rows [0, size),
    all-ones sentinel rows after; ``val_hi`` / ``val_lo`` int32[cap] the
    uint32 halves of the value, 0 past size; ``size`` int32 0-d.  p shards
    stack [p, ...]."""

    keys: torch.Tensor
    val_hi: torch.Tensor
    val_lo: torch.Tensor
    size: torch.Tensor

    @property
    def capacity(self) -> int:
        return self.keys.shape[-2]

    def shard(self, s: int) -> "KVStore":
        return KVStore(self.keys[s], self.val_hi[s], self.val_lo[s],
                       self.size[s])


def empty_kv_store(capacity: int, nwords: int, device) -> KVStore:
    zeros = torch.zeros(capacity, dtype=torch.int32, device=device)
    return KVStore(
        keys=torch.full((capacity, nwords), SENTINEL, dtype=torch.int32,
                        device=device),
        val_hi=zeros, val_lo=zeros.clone(),
        size=torch.zeros((), dtype=torch.int32, device=device))


def kv_grow(store: KVStore, new_cap: int) -> KVStore:
    """The store (one shard or stacked) padded to capacity new_cap."""
    pad = new_cap - store.capacity
    pad_ = torch.nn.functional.pad
    return KVStore(pad_(store.keys, (0, 0, 0, pad), value=SENTINEL),
                   pad_(store.val_hi, (0, pad)), pad_(store.val_lo, (0, pad)),
                   store.size)


def kv_reduce(words, val_hi, val_lo, valid, reduce: str = "first",
              order=()):
    """One row per distinct valid key of rows words [n, w] / [n]: under
    reduce="first" the row first in (`order` columns, then arrival) order —
    `order` holds int32-held uint32 priority columns, most significant
    first —, under "min" / "max" the row with the smallest / largest
    unsigned 64-bit value.  One stable sort (`sortops.kv_order`: the key
    words, then the priority or the value halves — their bitwise NOT for
    "max") and `compact_runs`.

    Returns (keys [n, w] — the distinct keys first, in key order, sentinel
    rows after; val_hi, val_lo [n], 0 past n_unique; n_unique 0-d)."""
    if reduce == "first":
        extra = tuple(order)
    elif reduce == "min":
        extra = (val_hi, val_lo)
    elif reduce == "max":
        extra = (~val_hi, ~val_lo)
    else:
        raise ValueError(f"unknown reduce {reduce!r}")
    perm = sortops.kv_order(valid, words, extra)
    uniq, (hi, lo), _, n_unique, _ = sortops.compact_runs(
        words[perm], valid[perm], payloads=(val_hi[perm], val_lo[perm]))
    live = torch.arange(words.shape[0], device=words.device) < n_unique
    return (torch.where(live[:, None], uniq, SENTINEL),
            torch.where(live, hi, 0), torch.where(live, lo, 0), n_unique)


def kv_insert(store: KVStore, words, val_hi, val_lo, valid,
              reduce: str = "first"):
    """Merge (key, value) rows words [n, w] / [n] into one shard under the
    reduction (densehash insert; the reduction map's min / max functor,
    distributed_densehash_map.hpp:2429+): one `kv_reduce` of the store's
    live rows and the valid new rows.  Under "first" the store's entries
    win, then the earlier batch rows (priority 0 for the store, 1..n in
    arrival order for the batch).  Returns the reduced rows as
    `kv_reduce` (cap + n of them); `kv_cut` makes them a store."""
    cap, n = store.capacity, words.shape[0]
    dev = words.device
    order = ()
    if reduce == "first":
        order = (torch.cat([torch.zeros(cap, dtype=torch.int32, device=dev),
                            torch.arange(1, n + 1, dtype=torch.int32,
                                         device=dev)]),)
    live = torch.arange(cap, device=dev) < store.size
    return kv_reduce(torch.cat([store.keys, words]),
                     torch.cat([store.val_hi, val_hi]),
                     torch.cat([store.val_lo, val_lo]),
                     torch.cat([live, valid]), reduce, order)


def kv_cut(keys, val_hi, val_lo, n_unique, cap: int) -> KVStore:
    """The store of `kv_reduce`'s first cap rows (sentinel-padded when
    there are fewer); the caller makes cap >= n_unique."""
    n = keys.shape[0]
    if cap > n:
        pad_ = torch.nn.functional.pad
        keys = pad_(keys, (0, 0, 0, cap - n), value=SENTINEL)
        val_hi, val_lo = pad_(val_hi, (0, cap - n)), pad_(val_lo, (0, cap - n))
    return KVStore(keys[:cap].contiguous(), val_hi[:cap].clone(),
                   val_lo[:cap].clone(), n_unique.to(torch.int32))


def kv_lookup(store: KVStore, queries: torch.Tensor):
    """(val_hi, val_lo int32[m], found bool[m]) per query row [m, w] of one
    shard, 0 where absent: a bucket-seeded lower_bound at every m (the JAX
    package's sort-merge join branch for m * 8 <= cap is a TPU-tuned
    route; the answers are the same) and three gathers."""
    cap = store.capacity
    idx = sortops.lower_bound_bucketed(store.keys, store.size, queries)
    hit = sortops.rows_equal_at(store.keys, idx, queries, store.size)
    at = idx.clamp(0, cap - 1)
    return (torch.where(hit, store.val_hi[at], 0),
            torch.where(hit, store.val_lo[at], 0), hit)


def kv_keep(store: KVStore, keep: torch.Tensor):
    """One shard with only its live entries where `keep`, in key order (the
    same capacity).  Returns (new_store, n_removed 0-d)."""
    dev = store.keys.device
    rows = torch.nonzero(keep & _live(store.size, store.capacity,
                                      dev)).squeeze(1)
    n = rows.shape[0]
    keys = torch.full_like(store.keys, SENTINEL)
    keys[:n] = store.keys[rows]
    vals = []
    for v in (store.val_hi, store.val_lo):
        out = torch.zeros_like(v)
        out[:n] = v[rows]
        vals.append(out)
    new_size = torch.tensor(n, dtype=torch.int32, device=dev)
    return KVStore(keys, *vals, new_size), store.size - new_size


def kv_erase(store: KVStore, queries: torch.Tensor, qvalid: torch.Tensor):
    """Remove the valid query keys from one shard.  Returns (new_store,
    n_erased 0-d)."""
    cap = store.capacity
    idx = sortops.lower_bound_bucketed(store.keys, store.size, queries)
    hit = sortops.rows_equal_at(store.keys, idx, queries, store.size) & qvalid
    kill = torch.zeros(cap + 1, dtype=torch.bool, device=store.keys.device)
    kill[torch.where(hit, idx, cap)] = True
    return kv_keep(store, ~kill[:cap])


def _kv_pred(store: KVStore, pred) -> torch.Tensor:
    """pred(keys int64[cap, w], val_hi int64[cap], val_lo int64[cap]) ->
    bool[cap] over one shard's rows (unsigned values)."""
    return pred(to_u64(store.keys), to_u64(store.val_hi),
                to_u64(store.val_lo))


def kv_filter(store: KVStore, keep_pred):
    """One shard without the entries failing keep_pred (as in `_kv_pred`).
    Returns (new_store, n_removed 0-d)."""
    return kv_keep(store, _kv_pred(store, keep_pred))


def kv_select(store: KVStore, pred):
    """(keys int32[t, w], val_hi, val_lo int32[t]) of one shard's live
    entries satisfying pred (as in `_kv_pred`), in key order."""
    emit = _kv_pred(store, pred) & _live(store.size, store.capacity,
                                         store.keys.device)
    return store.keys[emit], store.val_hi[emit], store.val_lo[emit]
