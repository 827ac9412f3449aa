"""Sort / merge / reduce / binary-search primitives over multi-word keys
(the subset of ``kmerind_tpu.ops.sortops`` that the port's indexes
call).

Keys are int32-held uint32 words (``ops/keys.py``), word 0 most
significant, so lexicographic row order is k-mer order.  Row-major keys are
[n, w]; the run store keeps them column-major [w, n].

Where the JAX package avoids TPU gathers and scatters — cummax / cummin
broadcasts, compaction by a stable sort — the port gathers and compacts
with boolean masks: same results, and torch's cummax is a slow
single-block scan on CUDA.
"""

from __future__ import annotations

import torch

from . import kernels
from .keys import SENTINEL, biased, lex_argsort, to_u64

__all__ = ["sort_rows", "compact_runs", "run_weight_totals",
           "run_length_counts", "segment_reduce_sorted", "kv_order",
           "merge_sorted_runs",
           "merge_sorted_runs_cols", "lower_bound_cols_prebuilt",
           "lower_bound_bucketed", "rows_equal_at"]


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


def _bsearch_rounds(kcols: torch.Tensor, queries: torch.Tensor,
                    lo: torch.Tensor, hi: torch.Tensor) -> torch.Tensor:
    """lower_bound refinement from per-query [lo, hi) ranges over sorted
    column-major keys [w, cap].  The round count is the bit length of the
    widest range (one host read), after which every range has converged —
    the JAX package's while_loop, unrolled on the host."""
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
        less = torch.zeros(m, dtype=torch.bool, device=kcols.device)
        for j in reversed(range(w)):
            kj = biased(kmid[j])
            less = torch.where(kj != q_cols[j], kj < q_cols[j], less)
        lo = torch.where(active & less, mid + 1, lo)
        hi = torch.where(active & ~less, mid, hi)
    return lo


def _prefix_starts(hi_word: torch.Tensor, tbits: int) -> torch.Tensor:
    """int32[2^tbits + 1] bucket table over a SORTED most-significant word
    column: starts[b] = first row whose top tbits >= b."""
    buck = to_u64(hi_word) >> (32 - tbits)
    probes = torch.arange((1 << tbits) + 1, device=hi_word.device)
    return torch.searchsorted(buck, probes, side="left", out_int32=True)


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
