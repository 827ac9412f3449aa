"""Word-parallel ops on packed k-mer tensors (plain PyTorch).

The port of the part of ``kmerind_tpu.ops.bitops`` that query
canonicalisation needs (``index/api.py``): unpack to character codes, pack
back, and the reverse complement (Kmer::reverse_complement,
src/common/kmer.hpp:1118-1140).  Words are int32-held uint32 bit patterns
(``ops/keys.py``).
"""

from __future__ import annotations

import torch

from ..kmer import KmerSpec
from .keys import to_u64

__all__ = ["unpack_kmers", "pack_kmers", "revcomp"]


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
