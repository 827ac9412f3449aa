"""Word-parallel ops on packed k-mer tensors (plain PyTorch).

The port of ``kmerind_tpu.ops.bitops`` (the packed-word ops of
``bliss::common::Kmer``: reverse / reverse complement kmer.hpp:1080-1140,
char shifts :969-1070, bitwise ops :872-961, compare :790-865, the 64-bit
views :1203-1333).  Words are int32-held uint32 bit patterns
(``ops/keys.py``): ordering compares `biased` words, shifts widen to
int64 first.
"""

from __future__ import annotations

import torch

from ..kmer import KmerSpec
from .keys import biased, to_u64

__all__ = ["unpack_kmers", "pack_kmers", "reverse", "revcomp",
           "shift_left_chars", "shift_right_chars", "char_reverse_word_swar",
           "kmer_equal", "kmer_compare", "kmer_xor", "kmer_and", "kmer_or",
           "prefix64", "suffix64", "infix_chars", "get_chars_at",
           "set_chars_at", "masked_equal"]


def unpack_kmers(words: torch.Tensor, spec: KmerSpec) -> torch.Tensor:
    """int32[n, nwords] -> int64[n, k] character codes (first char first)."""
    b = spec.bits_per_char
    mask = (1 << b) - 1
    cols = []
    for w, nch in enumerate(spec.word_char_counts()):
        u = to_u64(words[:, w])
        for j in range(nch):
            cols.append((u >> (b * (nch - 1 - j))) & mask)
    return torch.stack(cols, dim=1)


def pack_kmers(codes: torch.Tensor, spec: KmerSpec) -> torch.Tensor:
    """int[n, k] codes -> int32[n, nwords] packed words."""
    b = spec.bits_per_char
    cpw = spec.chars_per_word
    codes = codes.to(torch.int64)
    out = []
    for w, nch in enumerate(spec.word_char_counts()):
        acc = torch.zeros(codes.shape[0], dtype=torch.int64,
                          device=codes.device)
        for j in range(nch):
            acc = (acc << b) | codes[:, w * cpw + j]
        out.append(acc)
    return torch.stack(out, dim=1).to(torch.int32)


def revcomp(words: torch.Tensor, spec: KmerSpec) -> torch.Tensor:
    """Reverse complement of packed k-mers [n, nwords]."""
    comp = torch.tensor(spec.alphabet.to_complement, device=words.device)
    codes = comp[unpack_kmers(words, spec)]
    return pack_kmers(codes.flip(1), spec)


def reverse(words: torch.Tensor, spec: KmerSpec) -> torch.Tensor:
    """Character-order reversal of packed k-mers (Kmer::reverse,
    kmer.hpp:1080-1108)."""
    return pack_kmers(unpack_kmers(words, spec).flip(1), spec)


def _shifted(words: torch.Tensor, spec: KmerSpec, s: int, left: bool):
    codes = unpack_kmers(words, spec)
    zeros = codes.new_zeros((codes.shape[0], min(s, spec.k)))
    cat = [codes[:, s:], zeros] if left else [zeros, codes]
    return pack_kmers(torch.cat(cat, dim=1)[:, :spec.k], spec)


def shift_left_chars(words: torch.Tensor, spec: KmerSpec,
                     s: int) -> torch.Tensor:
    """Shift characters towards the front: drops the first s chars,
    zero-fills at the back (Kmer::operator<<=, kmer.hpp:969-1020)."""
    return _shifted(words, spec, s, left=True)


def shift_right_chars(words: torch.Tensor, spec: KmerSpec,
                      s: int) -> torch.Tensor:
    """Shift characters towards the back: drops the last s chars,
    zero-fills at the front (Kmer::operator>>=, kmer.hpp:1025-1070)."""
    return _shifted(words, spec, s, left=False)


def char_reverse_word_swar(x: torch.Tensor, bits: int) -> torch.Tensor:
    """Reverse the order of the bit groups of `bits` bits within full
    32-bit words, SWAR style (bitgroup_ops.hpp's SWAR backend): only for
    power-of-two group widths; every 32 / bits group is reversed."""
    if bits not in (1, 2, 4, 8, 16):
        raise ValueError("SWAR reverse requires power-of-two group width")
    x = to_u64(x)
    x = ((x << 16) | (x >> 16)) & 0xFFFFFFFF
    for width, m in ((8, 0x00FF00FF), (4, 0x0F0F0F0F), (2, 0x33333333),
                     (1, 0x55555555)):
        if bits <= width:
            x = ((x & m) << width) | ((x >> width) & m)
    return x.to(torch.int32)


def kmer_equal(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Row-wise equality over [n, nwords]."""
    return (a == b).all(dim=-1)


def kmer_compare(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Row-wise three-way compare, -1 / 0 / +1, in lexicographic char
    order (the words compared unsigned)."""
    cmp = torch.zeros(a.shape[:-1], dtype=torch.int32, device=a.device)
    for j in reversed(range(a.shape[-1])):
        aj, bj = biased(a[..., j]), biased(b[..., j])
        sign = torch.where(aj < bj, -1, 1).to(torch.int32)
        cmp = torch.where(aj != bj, sign, cmp)
    return cmp


def kmer_xor(a, b):
    return a ^ b


def kmer_and(a, b):
    return a & b


def kmer_or(a, b):
    return a | b


def prefix64(words: torch.Tensor):
    """(hi, lo) words: the most significant 64 bits of each k-mer
    (zero-extended when nwords == 1; Kmer::getPrefix, kmer.hpp:1203)."""
    hi = words[:, 0]
    return hi, words[:, 1] if words.shape[1] > 1 else torch.zeros_like(hi)


def suffix64(words: torch.Tensor):
    """(hi, lo) words: the least significant 64 bits (getSuffix)."""
    lo = words[:, -1]
    return words[:, -2] if words.shape[1] > 1 else torch.zeros_like(lo), lo


def infix_chars(words: torch.Tensor, spec: KmerSpec, start: int,
                length: int) -> torch.Tensor:
    """Characters [start, start + length) of each k-mer, packed in the
    KmerSpec(length) layout (getInfix, kmer.hpp:1244-1285)."""
    codes = unpack_kmers(words, spec)[:, start:start + length]
    return pack_kmers(codes, KmerSpec(length, spec.alphabet))


def get_chars_at(words: torch.Tensor, spec: KmerSpec, pos: int,
                 n: int) -> torch.Tensor:
    """uint8[rows, n] character codes at [pos, pos + n) (getCharsAtPos)."""
    return unpack_kmers(words, spec)[:, pos:pos + n].to(torch.uint8)


def set_chars_at(words: torch.Tensor, spec: KmerSpec, pos: int,
                 new_codes: torch.Tensor) -> torch.Tensor:
    """The k-mers with characters [pos, pos + new_codes.shape[1]) replaced
    (setCharsAtPos)."""
    codes = unpack_kmers(words, spec)
    codes[:, pos:pos + new_codes.shape[1]] = new_codes.to(codes.dtype)
    return pack_kmers(codes, spec)


def masked_equal(a: torch.Tensor, b: torch.Tensor,
                 mask_words: torch.Tensor) -> torch.Tensor:
    """Row-wise equality under a per-word bit mask (Kmer::masked_equal,
    kmer.hpp:1288-1333)."""
    return ((a & mask_words) == (b & mask_words)).all(dim=-1)
