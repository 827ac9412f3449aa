"""Sort / merge / binary-search primitives over multi-word keys (the
main-path subset of ``kmerind_tpu.ops.sortops``).

Keys are int32-held uint32 words (``ops/keys.py``), word 0 most
significant, so lexicographic row order is k-mer order.  Row-major keys are
[n, w]; the run store keeps them column-major [w, n].
"""

from __future__ import annotations

import torch

from . import kernels
from .keys import SENTINEL, biased, lex_argsort, to_u64

__all__ = ["sort_rows", "merge_sorted_runs_cols",
           "lower_bound_cols_prebuilt"]


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
