"""Vectorized sliding-window k-mer extraction (plain PyTorch).

The port of ``kmerind_tpu.ops.packing``: all window packs of a code stream
by the log2(k)-step doubling scheme

    P_t[i] = pack of codes[i : i + 2**t)        (first char most significant)
    P_t[i] = (P_{t-1}[i] << b*2**(t-1)) | P_{t-1}[i + 2**(t-1)]

with an arbitrary window length assembled from the binary digits of m, and
the same construction over the complemented, reversed stream for the
reverse complements.  `extract_canonical` here is the plain version of the
K1 kernel (``ops/kernels.py::extract_canonical``), which the main path calls
for device tensors.

Words are computed in int64 holding uint32 values (masked after every left
shift, as uint32 arithmetic drops the high bits) and returned as int32 bit
patterns (``ops/keys.py``).
"""

from __future__ import annotations

import torch

from ..kmer import KmerSpec
from .keys import biased

__all__ = ["extract_kmers", "extract_revcomp", "extract_canonical",
           "lex_less", "window_valid"]

_U32 = 0xFFFFFFFF


def _shift_idx(a: torch.Tensor, s: int) -> torch.Tensor:
    """a'[i] = a[i + s] along dim 0, zero-filled past the end."""
    if s == 0:
        return a
    out = torch.zeros_like(a)
    if s < a.shape[0]:
        out[: a.shape[0] - s] = a[s:]
    return out


def _pow_packs(codes: torch.Tensor, bits: int, max_m: int) -> dict:
    """P[t][i] = pack of codes[i : i+2**t), for all 2**t <= max_m."""
    pows = {0: codes}
    t = 1
    while (1 << t) <= max_m:
        half = 1 << (t - 1)
        prev = pows[t - 1]
        pows[t] = ((prev << (bits * half)) & _U32) | _shift_idx(prev, half)
        t += 1
    return pows


def _combine(pows: dict, bits: int, m: int) -> torch.Tensor:
    """W[i] = pack of codes[i : i+m) assembled from power-of-two packs."""
    acc = None
    consumed = 0
    for t in reversed(range(max(pows) + 1)):
        if m & (1 << t):
            part = _shift_idx(pows[t], consumed)
            acc = part if acc is None else (
                ((acc << (bits * (1 << t))) & _U32) | part)
            consumed += 1 << t
    return acc


def _window_words(codes: torch.Tensor, spec: KmerSpec) -> torch.Tensor:
    """int64[n, nwords] (uint32 values): words of the k-mer starting at
    every position."""
    b = spec.bits_per_char
    cpw = spec.chars_per_word
    r = spec.last_word_chars
    pows = _pow_packs(codes.to(torch.int64), b, max(cpw, r))
    full = _combine(pows, b, cpw) if spec.nwords > 1 or r == cpw else None
    last = full if r == cpw else _combine(pows, b, r)
    cols = [_shift_idx(full, w * cpw) for w in range(spec.nwords - 1)]
    cols.append(_shift_idx(last, (spec.nwords - 1) * cpw))
    return torch.stack(cols, dim=1)


def extract_kmers(codes: torch.Tensor, spec: KmerSpec) -> torch.Tensor:
    """int32[n, nwords]: forward-strand k-mer at every window position.
    Rows past n-k are garbage — mask with `window_valid`."""
    return _window_words(codes, spec).to(torch.int32)


def _revcomp_words(codes: torch.Tensor, spec: KmerSpec) -> torch.Tensor:
    lut = torch.tensor(spec.alphabet.to_complement, device=codes.device)
    comp = lut[codes.to(torch.int64)]
    flipped = _window_words(comp.flip(0), spec)
    return _shift_idx(flipped.flip(0), spec.k - 1)


def extract_revcomp(codes: torch.Tensor, spec: KmerSpec) -> torch.Tensor:
    """int32[n, nwords]: row i is revcomp(codes[i:i+k]) — a window pack over
    the complemented, reversed stream, realigned (kmer.hpp:1118-1140
    semantics without bit twiddling)."""
    return _revcomp_words(codes, spec).to(torch.int32)


def lex_less(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """bool[...]: row-wise lexicographic a < b over int32-held uint32 word
    rows [..., w] (the reference's word-array `less`,
    src/utils/bitgroup_ops.hpp:3539-3575)."""
    less = torch.zeros(a.shape[:-1], dtype=torch.bool, device=a.device)
    for j in reversed(range(a.shape[-1])):
        aj, bj = biased(a[..., j]), biased(b[..., j])
        less = torch.where(aj != bj, aj < bj, less)
    return less


def extract_canonical(codes: torch.Tensor, spec: KmerSpec):
    """(canonical int32[n, nwords], was_rc bool[n]) at every window start.

    canonical = min(kmer, revcomp(kmer)) in lexicographic order — the
    `lex_less` transform (kmer_transform.hpp:109-123); `was_rc` marks
    windows where the reverse complement was the smaller strand.  Rows past
    n-k are garbage.  Plain version of the K1 kernel."""
    fwd = _window_words(codes, spec)
    rc = _revcomp_words(codes, spec)
    # int64 words hold uint32 values, so signed order is word order here
    less = torch.zeros(codes.shape[0], dtype=torch.bool, device=codes.device)
    for j in reversed(range(spec.nwords)):
        less = torch.where(rc[:, j] != fwd[:, j], rc[:, j] < fwd[:, j], less)
    return torch.where(less[:, None], rc, fwd).to(torch.int32), less


def window_valid(base_valid: torch.Tensor, seg_id: torch.Tensor,
                 k: int) -> torch.Tensor:
    """bool[n]: window [i, i+k) holds a real k-mer — every base valid (not
    padding) and all bases in one record (seg_id constant), the tensor form
    of the reference's per-record iteration (sequence_iterator.hpp:241-283)
    plus the k-1 overlap bookkeeping (kmer_file_helper.hpp:361)."""
    v = base_valid.to(torch.int32)
    span = 1
    while span < k:
        step = min(span, k - span)
        v = torch.minimum(v, _shift_idx(v, step))
        span += step
    n = base_valid.shape[0]
    out = v.to(torch.bool)
    if k > 1:
        out &= seg_id == _shift_idx(seg_id, k - 1)
    return out & (torch.arange(n, device=base_valid.device) <= n - k)
