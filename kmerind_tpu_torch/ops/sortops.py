"""Sort / merge / reduce / binary-search / join primitives over multi-word
keys: the port of ``kmerind_tpu.ops.sortops``.

Keys are int32-held uint32 words (``ops/keys.py``), word 0 most
significant, so lexicographic row order is k-mer order.  Row-major keys are
[n, w]; the run store keeps them column-major [w, n].

Where the JAX package avoids TPU gathers and scatters — cummax / cummin
broadcasts, compaction by a stable sort — the port gathers and compacts
with boolean masks: same results, and torch's cummax is a slow
single-block scan on CUDA.

The two bitonic merges are the JAX package's half-cleaner network on a CPU
tensor (``kernels.bitonic_merge_rows_plain`` / ``_cols_plain``) and, on a
CUDA tensor, the one-run kernels (``kernels.bitonic_merge_rows`` /
``bitonic_merge_cols``): the prefix merged with the suffix read backwards,
in place.  The sort-merge joins (`lookup_join*`) give the same answers as
the bucket-seeded searches the port's indexes call; no index routes
through them.
"""

from __future__ import annotations

import torch

from . import kernels
from .keys import SENTINEL, biased, lex_argsort, to_u64

__all__ = ["sort_rows", "compact_runs", "unique_counts", "run_weight_totals",
           "run_length_counts", "segment_reduce_sorted", "kv_order",
           "lower_bound", "upper_bound", "rows_equal_at", "bitonic_merge",
           "bitonic_merge_cols", "merge_sorted_runs",
           "merge_sorted_runs_cols", "lookup_join_runs",
           "lookup_join_runs_cols", "lower_bound_cols", "upper_bound_cols",
           "lower_bound_cols_bucketed", "lower_bound_cols_prebuilt",
           "lower_bound_bucketed", "lookup_join", "lookup_join_vals",
           "lookup_join_ranges"]


def sort_rows(words: torch.Tensor, payloads=(), valid=None,
              is_stable: bool = True, sentinel_ok: bool = False,
              as_cols: bool = False):
    """Sort rows of [n, w] key words lexicographically, carrying payloads.

    Invalid rows sort after all valid rows — by a leading invalid-flag key,
    or, when `sentinel_ok` (no valid key can be all-ones,
    KmerSpec.sentinel_safe), by overwriting invalid rows with the all-ones
    sentinel.  The sort itself is `torch.sort` (the JAX package's
    ``lax.sort``, not a Pallas kernel): one int64 key for up to two words,
    stable LSD passes beyond (`keys.lex_argsort`).

    as_cols: return the sorted keys column-major ([w, n]).

    Returns (sorted_words, sorted_payloads_tuple, sorted_valid).
    """
    n, w = words.shape
    if valid is None:
        valid = torch.ones(n, dtype=torch.bool, device=words.device)
    if sentinel_ok:
        cols = [torch.where(valid, words[:, j], SENTINEL) for j in range(w)]
        perm = lex_argsort([biased(c) for c in cols], stable=is_stable)
        sorted_valid = (torch.arange(n, device=words.device)
                        < valid.sum())
    else:
        cols = [words[:, j] for j in range(w)]
        perm = lex_argsort([(~valid).to(torch.int32)]
                           + [biased(c) for c in cols], stable=is_stable)
        sorted_valid = valid[perm]
    sorted_words = torch.stack([c[perm] for c in cols],
                               dim=0 if as_cols else 1)
    return sorted_words, tuple(p[perm] for p in payloads), sorted_valid


def _row_neq_prev(sorted_words: torch.Tensor) -> torch.Tensor:
    """bool[n]: row differs from the previous row (row 0 -> True)."""
    neq = torch.ones(sorted_words.shape[0], dtype=torch.bool,
                     device=sorted_words.device)
    neq[1:] = (sorted_words[1:] != sorted_words[:-1]).any(dim=1)
    return neq


def compact_runs(sorted_words: torch.Tensor, sorted_valid: torch.Tensor,
                 payloads=()):
    """Move the first valid row of every run of equal keys to the front, in
    order; the other rows follow in order (a stable partition).

    Returns (uniq_rows [n, w], payload_firsts, starts int64[n] — source row
    of each output row, n_unique, total_valid), the counts as 0-d
    tensors."""
    is_new = _row_neq_prev(sorted_words) & sorted_valid
    starts = torch.cat([torch.nonzero(is_new).squeeze(1),
                        torch.nonzero(~is_new).squeeze(1)])
    return (sorted_words[starts], tuple(p[starts] for p in payloads), starts,
            is_new.sum(), sorted_valid.sum())


def _i32(value: int) -> int:
    """An unsigned 32-bit value as the int32 with the same bits."""
    value &= 0xFFFFFFFF
    return value - (1 << 32) if value >> 31 else value


def unique_counts(sorted_words: torch.Tensor, sorted_valid: torch.Tensor,
                  sentinel: int = 0xFFFFFFFF):
    """Deduplicate sorted rows [n, w] (valid rows first) and count each
    key's multiplicity — the counting map's insert semantics
    (distributed_densehash_map.hpp:2669+).

    Returns (uniq [n, w] — the distinct keys, then `sentinel` rows;
    counts int32[n] — each distinct key's run length, 0 past n_unique;
    n_unique 0-d)."""
    n = sorted_words.shape[0]
    uniq, _, starts, n_unique, total_valid = compact_runs(sorted_words,
                                                          sorted_valid)
    j = torch.arange(n, device=sorted_words.device)
    next_start = torch.cat([starts[1:], starts.new_zeros(1)])
    counts = torch.where(j + 1 < n_unique, next_start - starts,
                         torch.where(j + 1 == n_unique, total_valid - starts,
                                     0))
    uniq = torch.where((j < n_unique)[:, None], uniq, _i32(sentinel))
    return uniq, counts.to(torch.int32), n_unique


def run_weight_totals(sorted_words: torch.Tensor, sorted_valid: torch.Tensor,
                      weights: torch.Tensor) -> torch.Tensor:
    """int32[n]: per-row sum of `weights` over the row's run of equal keys
    (invalid rows contribute 0): prefix sums at each run's end minus at its
    start, broadcast through run ids (a cumsum of the head flags).  Sums
    are exact in int64 and wrap to int32 like the JAX package's int32
    prefix sums."""
    n = sorted_words.shape[0]
    wmask = torch.where(sorted_valid, weights.to(torch.int64), 0)
    incl = torch.cumsum(wmask, 0)
    neq_prev = _row_neq_prev(sorted_words)
    neq_next = torch.ones(n, dtype=torch.bool, device=sorted_words.device)
    neq_next[:-1] = neq_prev[1:]
    run_id = torch.cumsum(neq_prev, 0) - 1
    totals = incl[neq_next] - (incl - wmask)[neq_prev]
    return totals[run_id].to(torch.int32)


def run_length_counts(sorted_words: torch.Tensor, sorted_valid: torch.Tensor):
    """Run lengths of equal sorted keys without compaction: (weights
    int32[n], emit bool[n]) — the last valid row of every run holds the
    run's length, every other row 0 / False.  The rows must be sorted with
    all valid rows first (`sort_rows` guarantees it).  The K4 kernel on the
    device (``kernels.run_length_weights``), reading the keys
    column-major: free when `sorted_words` is the transpose of
    ``sort_rows(..., as_cols=True)``'s output."""
    weights = kernels.run_length_weights(
        sorted_words.t().contiguous(), sorted_valid.sum(dtype=torch.int32))
    return weights, weights > 0


def segment_reduce_sorted(sorted_words: torch.Tensor,
                          sorted_valid: torch.Tensor, values: torch.Tensor,
                          reduce: str = "sum"):
    """Reduce `values` ([n] or [n, d]) over runs of equal sorted keys: their
    sum (the counting maps), or their "min" / "max" (the reduction maps'
    min / max functors, distributed_densehash_map.hpp:2429+).

    Returns (uniq [n, w] — the distinct keys first, sentinel rows after;
    reduced — each key's sum, min or max, 0 past n_unique; n_unique 0-d).
    min / max: a group index from the cumsum of the head flags, then one
    `scatter_reduce` (the JAX package's segment_min / segment_max)."""
    if reduce in ("min", "max"):
        return _segment_extreme(sorted_words, sorted_valid, values, reduce)
    if reduce != "sum":
        raise ValueError(f"unknown reduce {reduce!r}")
    cols = values[:, None] if values.dim() == 1 else values
    totals = tuple(run_weight_totals(sorted_words, sorted_valid, cols[:, j])
                   for j in range(cols.shape[1]))
    uniq, red, _, n_unique, _ = compact_runs(sorted_words, sorted_valid,
                                             payloads=totals)
    live = torch.arange(sorted_words.shape[0],
                        device=sorted_words.device) < n_unique
    uniq = torch.where(live[:, None], uniq, SENTINEL)
    reduced = torch.where(live[:, None], torch.stack(red, dim=1), 0)
    if values.dim() == 1:
        reduced = reduced[:, 0]
    return uniq, reduced.to(values.dtype), n_unique


def _segment_extreme(sorted_words, sorted_valid, values, reduce: str):
    """`segment_reduce_sorted` for reduce "min" / "max": each valid key
    run's extreme value (invalid rows take no part)."""
    n = sorted_words.shape[0]
    is_new = _row_neq_prev(sorted_words) & sorted_valid
    seg = (torch.cumsum(is_new, 0) - 1).clamp(min=0)
    ident = (torch.iinfo(values.dtype) if not values.dtype.is_floating_point
             else None)
    if reduce == "min":
        fill = ident.max if ident else float("inf")
    else:
        fill = ident.min if ident else float("-inf")
    vmask = sorted_valid if values.dim() == 1 else sorted_valid[:, None]
    vals = torch.where(vmask, values, fill)
    index = seg if values.dim() == 1 else seg[:, None].expand_as(values)
    red = torch.full_like(values, fill).scatter_reduce(
        0, index, vals, "amin" if reduce == "min" else "amax")
    n_unique = is_new.sum()
    live = torch.arange(n, device=sorted_words.device) < n_unique
    uniq = torch.full_like(sorted_words, SENTINEL)
    uniq[: int(n_unique)] = sorted_words[is_new]
    reduced = torch.where(live if values.dim() == 1 else live[:, None],
                          red, 0)
    return uniq, reduced, n_unique


def kv_order(valid: torch.Tensor, words: torch.Tensor,
             extra=()) -> torch.Tensor:
    """Permutation sorting (key, value) rows for a unique-value map's
    reduction: invalid rows last (`valid` False), then the key
    words [n, w] ascending, then each `extra` column (int32-held uint32
    bits: a priority, or the value halves) ascending as unsigned.  Stable
    LSD passes (`keys.lex_argsort`), so rows equal in every column keep
    their order; the first row of each key is then the row the reduction
    keeps (`compact_runs`)."""
    cols = [(~valid).to(torch.int32)]
    cols += [biased(words[:, j]) for j in range(words.shape[1])]
    cols += [biased(c) for c in extra]
    return lex_argsort(cols)


def merge_sorted_runs(a_keys: torch.Tensor, a_payloads,
                      b_keys: torch.Tensor, b_payloads):
    """Merge two ascending row-major runs ([n_i, w] keys plus aligned [n_i]
    payloads) into one of n = next_pow2(n_a + n_b) rows, sentinel keys with
    payload 0 at the tail — the K2′ kernel (``kernels.merge_sorted_runs``)
    on the device.

    Returns (keys [n, w], payloads)."""
    return kernels.merge_sorted_runs(a_keys, tuple(a_payloads),
                                     b_keys, tuple(b_payloads))


def merge_sorted_runs_cols(a_kcols: torch.Tensor, a_payloads,
                           b_kcols: torch.Tensor, b_payloads):
    """Merge two ascending column-major runs ([w, n_i] keys plus aligned
    [n_i] payloads) into one of n = next_pow2(n_a + n_b) rows, sentinel
    keys with payload 0 at the tail — the K2 kernel
    (``kernels.merge_runs_cols``) on the device.

    Returns (kcols [w, n], payloads)."""
    return kernels.merge_runs_cols(a_kcols, tuple(a_payloads),
                                   b_kcols, tuple(b_payloads))


#: payload element size -> the integer dtype a payload travels through the
#: kernels as (widened to int32 from these bits, narrowed back after)
_BITS = {1: torch.uint8, 2: torch.int16, 4: torch.int32}


def _as_i32(payloads) -> list:
    """Payload columns as the kernels' int32 columns: a 32-bit payload as
    its bits, an 8- or 16-bit one (uint8, int8, bool, int16, float16,
    bfloat16) widened from its bits; `_from_i32` narrows them back.  The
    JAX package runs without x64, so a 64-bit payload raises."""
    out = []
    for p in payloads:
        bits = _BITS.get(p.element_size())
        if bits is None:
            raise TypeError("bitonic_merge: payloads of 8, 16 or 32 bits "
                            f"only, got {p.dtype}")
        q = p.view(bits)
        out.append(q.contiguous() if bits is torch.int32
                   else q.to(torch.int32))
    return out


def _from_i32(cols, payloads) -> tuple:
    """The kernels' int32 columns back in each payload's own dtype."""
    return tuple(
        c.view(p.dtype) if p.element_size() == 4
        else c.to(_BITS[p.element_size()]).view(p.dtype)
        for c, p in zip(cols, payloads))


def _merge_bitonic(keys: torch.Tensor, payloads, row_major: bool):
    """One bitonic run of row-major keys [n, w]
    (``kernels.bitonic_merge_rows``) or column-major [w, n]
    (``kernels.bitonic_merge_cols``), payloads through `_as_i32` /
    `_from_i32`; n a power of two."""
    n = keys.shape[0 if row_major else 1]
    if n & (n - 1):
        raise ValueError("bitonic_merge needs power-of-two length")
    merge = (kernels.bitonic_merge_rows if row_major
             else kernels.bitonic_merge_cols)
    out, cols = merge(keys.contiguous(), _as_i32(payloads))
    return out, _from_i32(cols, payloads)


def bitonic_merge(keys: torch.Tensor, payloads=()):
    """Sort a bitonic run of rows — an ascending prefix followed by a
    descending suffix — of keys [n, w] (n a power of two) with aligned [n]
    payloads of 8, 16 or 32 bits.  Not stable: equal keys leave in no set
    order.

    ``kernels.bitonic_merge_rows``: on a CPU tensor the JAX package's
    half-cleaner network; on a CUDA tensor the one-run kernel, which finds
    the split on the device and merges the prefix with the suffix read
    backwards.

    Returns (sorted_keys [n, w], payloads_tuple)."""
    return _merge_bitonic(keys, payloads, row_major=True)


def bitonic_merge_cols(kcols: torch.Tensor, payloads=()):
    """`bitonic_merge` over column-major keys [w, n] (word 0 most
    significant): on a CUDA tensor ``kernels.bitonic_merge_cols``.
    Returns ([w, n], payloads_tuple)."""
    return _merge_bitonic(kcols, payloads, row_major=False)


def _bsearch_rounds(kcols: torch.Tensor, queries: torch.Tensor,
                    lo: torch.Tensor, hi: torch.Tensor,
                    side: str = "left") -> torch.Tensor:
    """lower_bound (side "left") or upper_bound ("right") refinement from
    per-query [lo, hi) ranges over sorted column-major keys [w, cap].  The
    round count is the bit length of the widest range (one host read),
    after which every range has converged — the JAX package's while_loop,
    unrolled on the host."""
    w, cap = kcols.shape
    m = queries.shape[0]
    if m == 0:
        return lo
    q_cols = [biased(queries[:, j]) for j in range(w)]
    rounds = int((hi - lo).max()).bit_length()
    for _ in range(rounds):
        active = lo < hi
        mid = (lo + hi) >> 1
        kmid = kcols[:, mid.clamp(0, cap - 1)]
        # left: kmid < q; right: kmid <= q (not kmid > q)
        go_right = torch.zeros(m, dtype=torch.bool, device=kcols.device) \
            if side == "left" else torch.ones(m, dtype=torch.bool,
                                              device=kcols.device)
        for j in reversed(range(w)):
            kj = biased(kmid[j])
            go_right = torch.where(kj != q_cols[j], kj < q_cols[j],
                                   go_right)
        lo = torch.where(active & go_right, mid + 1, lo)
        hi = torch.where(active & ~go_right, mid, hi)
    return lo


def _bsearch(kcols: torch.Tensor, size, queries: torch.Tensor,
             side: str) -> torch.Tensor:
    """int64[m] insertion index of each query row [m, w] among the sorted
    first `size` rows of column-major keys [w, cap]."""
    m = queries.shape[0]
    size = torch.as_tensor(size, device=kcols.device).to(torch.int64)
    lo = torch.zeros(m, dtype=torch.int64, device=kcols.device)
    return _bsearch_rounds(kcols, queries, lo, lo + size, side)


def lower_bound(keys: torch.Tensor, size, queries: torch.Tensor):
    """int64[m]: the first row of the sorted rows [0, size) of keys [cap, w]
    not less than each query row [m, w]."""
    return _bsearch(keys.t(), size, queries, "left")


def upper_bound(keys: torch.Tensor, size, queries: torch.Tensor):
    """int64[m]: the first row of the sorted rows [0, size) of keys [cap, w]
    greater than each query row [m, w]."""
    return _bsearch(keys.t(), size, queries, "right")


def lower_bound_cols(kcols: torch.Tensor, size, queries: torch.Tensor):
    """`lower_bound` over column-major keys [w, cap]; queries [m, w]."""
    return _bsearch(kcols, size, queries, "left")


def upper_bound_cols(kcols: torch.Tensor, size, queries: torch.Tensor):
    """`upper_bound` over column-major keys [w, cap]; queries [m, w]."""
    return _bsearch(kcols, size, queries, "right")


def _prefix_starts(hi_word: torch.Tensor, tbits: int) -> torch.Tensor:
    """int32[2^tbits + 1] bucket table over a SORTED most-significant word
    column: starts[b] = first row whose top tbits >= b."""
    buck = to_u64(hi_word) >> (32 - tbits)
    probes = torch.arange((1 << tbits) + 1, device=hi_word.device)
    return torch.searchsorted(buck, probes, side="left", out_int32=True)


def lower_bound_cols_bucketed(kcols: torch.Tensor, size,
                              queries: torch.Tensor,
                              tbits: int = 16) -> torch.Tensor:
    """`lower_bound_cols` seeded by a 2^tbits-entry prefix-bucket table of
    word 0: each search starts inside its query's bucket.  It searches all
    cap rows, as the JAX function does: the run stores' sentinel tails are
    sorted too, so `size` does not bound the result."""
    starts = _prefix_starts(kcols[0], tbits).to(torch.int64)
    b = to_u64(queries[:, 0]) >> (32 - tbits)
    return _bsearch_rounds(kcols, queries, starts[b], starts[b + 1])


def lower_bound_cols_prebuilt(ext: torch.Tensor, w: int, bstart: torch.Tensor,
                              queries: torch.Tensor) -> torch.Tensor:
    """lower_bound of each query row [m, w] in the sorted key columns
    ext[:w] ([w + extra, cap]), seeded by a prebuilt prefix-bucket table
    `bstart` (`_prefix_starts`).  The table's width is read from its length
    (2^tbits + 1 entries), so any tbits the aux builder chose works."""
    tbits = (bstart.shape[0] - 1).bit_length() - 1
    if bstart.shape[0] != (1 << tbits) + 1:
        raise ValueError(f"bucket table of {bstart.shape[0]} entries is not "
                         "2^tbits + 1")
    b = to_u64(queries[:, 0]) >> (32 - tbits)
    return _bsearch_rounds(ext[:w], queries, bstart[b].to(torch.int64),
                           bstart[b + 1].to(torch.int64))


def lower_bound_bucketed(keys: torch.Tensor, size, queries: torch.Tensor,
                         tbits: int = 16) -> torch.Tensor:
    """lower_bound of each query row [m, w] in the live rows [0, size) of
    sorted row-major keys [cap, w], seeded by a 2^tbits-entry prefix-bucket
    table of word 0.  Rows >= size must hold the all-ones sentinel (every
    store's invariant), so clipping the bucket bounds to `size` keeps the
    result."""
    starts = _prefix_starts(keys[:, 0], tbits).to(torch.int64)
    b = to_u64(queries[:, 0]) >> (32 - tbits)
    size = torch.as_tensor(size, device=keys.device).to(torch.int64)
    return _bsearch_rounds(keys.t(), queries, torch.minimum(starts[b], size),
                           torch.minimum(starts[b + 1], size))


def rows_equal_at(keys: torch.Tensor, idx: torch.Tensor, queries: torch.Tensor,
                  size) -> torch.Tensor:
    """bool[m]: keys[idx] == queries and idx < size (the query is
    present)."""
    rows = keys[idx.clamp(0, keys.shape[0] - 1)]
    return (idx < size) & (rows == queries).all(dim=-1)


# ------------------------------------------------------------ sort-merge joins
# The JAX package's gather-free lookups: one stable sort of the store rows
# and the query rows by (key words, flag), scans, and the queries' answers
# put back in query order.  Its cummax broadcasts become gathers through a
# cumsum of the flags here (torch's cummax is a single-block scan on CUDA).

def _join_sort(store_cols, flag_store: torch.Tensor, queries: torch.Tensor):
    """Sort the store rows (column-major [w, cap]) and the query rows
    ([m, w]) together by (key words, flag): store rows carry
    `flag_store` (0 live, 2 padding), queries 1.  Returns (perm, flag,
    neq_prev — each sorted row differs from the one before)."""
    w = store_cols.shape[0]
    m = queries.shape[0]
    words = [torch.cat([store_cols[j], queries[:, j]]) for j in range(w)]
    flag = torch.cat([flag_store, torch.ones(m, dtype=torch.int32,
                                             device=queries.device)])
    perm = lex_argsort([biased(c) for c in words] + [flag])
    s = [c[perm] for c in words]
    neq = torch.zeros(perm.shape[0], dtype=torch.bool, device=perm.device)
    neq[0] = True
    for c in s:
        neq[1:] |= c[1:] != c[:-1]
    return perm, flag[perm], neq


def _at_run_head(values: torch.Tensor, neq_prev: torch.Tensor):
    """Each row's value at the head of its run of equal keys."""
    return values[neq_prev][torch.cumsum(neq_prev, 0) - 1]


def _last_where(mask: torch.Tensor) -> torch.Tensor:
    """int64 per row: the last row at or before it where mask holds, -1 if
    none (the JAX package's cummax of the flagged positions)."""
    idx = torch.arange(mask.shape[0], device=mask.device)
    pos = torch.cat([idx[mask], idx.new_full((1,), -1)])
    cnt = torch.cumsum(mask, 0)
    return pos[torch.where(cnt > 0, cnt - 1, pos.shape[0] - 1)]


def _to_query_order(values, perm, s_flag, cap: int, m: int):
    """The sorted query rows' values back in query order."""
    q = s_flag == 1
    qidx = perm[q] - cap
    out = []
    for v in values:
        o = v.new_zeros(m)
        o[qidx] = v[q]
        out.append(o)
    return out


def _store_flag(cap: int, size, device) -> torch.Tensor:
    return torch.where(torch.arange(cap, device=device) < size, 0,
                       2).to(torch.int32)


def lookup_join(keys: torch.Tensor, size, vals: torch.Tensor,
                queries: torch.Tensor) -> torch.Tensor:
    """int32[m] value of each query row [m, w] in a unique-key store (keys
    [cap, w] with live rows [0, size), vals [cap]), 0 when absent: the
    sort-merge join.  Padding rows sort after the queries of their key,
    so a real all-ones key is never shadowed by the sentinel tail."""
    cap = keys.shape[0]
    perm, s_flag, neq = _join_sort(keys.t(), _store_flag(
        cap, size, keys.device), queries)
    s_val = torch.cat([vals.to(torch.int32),
                       vals.new_zeros(queries.shape[0],
                                      dtype=torch.int32)])[perm]
    idx = torch.arange(perm.shape[0], device=perm.device)
    last_store = _last_where(s_flag == 0)
    match = last_store >= _at_run_head(idx, neq)
    res = torch.where(match, s_val[last_store.clamp(min=0)], 0)
    return _to_query_order([res], perm, s_flag, cap, queries.shape[0])[0]


def lookup_join_vals(keys: torch.Tensor, size, vals: tuple,
                     queries: torch.Tensor):
    """`lookup_join` carrying any number of value columns ([cap] each, any
    dtype).  Returns (matched — one [m] column per value column, 0 where
    absent; found bool[m]) in query order."""
    cap, m = keys.shape[0], queries.shape[0]
    perm, s_flag, neq = _join_sort(keys.t(), _store_flag(
        cap, size, keys.device), queries)
    idx = torch.arange(perm.shape[0], device=perm.device)
    last_store = _last_where(s_flag == 0)
    match = last_store >= _at_run_head(idx, neq)
    at = perm[last_store.clamp(min=0)].clamp(max=cap - 1)
    cols = [torch.where(match, v[at], 0).to(v.dtype) for v in vals]
    *out, found = _to_query_order(cols + [match], perm, s_flag, cap, m)
    return tuple(out), found


def lookup_join_ranges(keys: torch.Tensor, size, queries: torch.Tensor):
    """(lo int32[m], hi int32[m]): the rows [lo, hi) of each query's key
    in a sorted multimap store (keys [cap, w], live rows [0, size)), lo ==
    hi when absent — from live-store-row counts over the joined order."""
    cap = keys.shape[0]
    perm, s_flag, neq = _join_sort(keys.t(), _store_flag(
        cap, size, keys.device), queries)
    is_store = (s_flag == 0).to(torch.int64)
    incl = torch.cumsum(is_store, 0)
    lo = _at_run_head(incl - is_store, neq)
    out = _to_query_order([lo, incl], perm, s_flag, cap, queries.shape[0])
    return tuple(o.to(torch.int32) for o in out)


def lookup_join_runs_cols(kcols: torch.Tensor, csum: torch.Tensor,
                          queries: torch.Tensor) -> torch.Tensor:
    """int32[m] total weight of each query's key run in a run store
    (column-major keys [w, cap] sorted over all rows, csum int32[cap + 1]
    the exclusive prefix sum of its weights): the sort-merge join, the
    sums wrapping like int32."""
    cap, m = kcols.shape[1], queries.shape[0]
    perm, s_flag, neq = _join_sort(
        kcols, torch.zeros(cap, dtype=torch.int32, device=kcols.device),
        queries)
    wts = (csum[1:] - csum[:-1]).to(torch.int64)
    s_wts = torch.cat([wts, wts.new_zeros(m)])[perm]
    incl = torch.cumsum(s_wts, 0)
    counts = torch.where(s_flag == 1, incl - _at_run_head(incl - s_wts, neq),
                         0)
    return _to_query_order([counts], perm, s_flag, cap, m)[0].to(torch.int32)


def lookup_join_runs(keys: torch.Tensor, csum: torch.Tensor,
                     queries: torch.Tensor) -> torch.Tensor:
    """`lookup_join_runs_cols` over row-major store keys [cap, w]."""
    return lookup_join_runs_cols(keys.t(), csum, queries)
