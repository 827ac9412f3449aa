"""K-mer hash functions and the owner map, vectorized over key-word tensors.

The port of ``kmerind_tpu.ops.hashing`` (after the reference's hash functor
family, src/index/kmer_hash.hpp:157-330): ``murmur`` (MurmurHash3_x86_32
over the row's words as little-endian 4-byte blocks), ``farm`` (the
bit-exact FarmHash64 of ``ops/farmhash.py``, folded to 32 bits), the
``fmix32`` fold (also the ``std`` slot), ``identity`` (word 0) and the
independent ``mix32``.  Digests equal the JAX package's bit for bit.

Keys are int32 tensors carrying uint32 bits (``ops/keys.py``).  CPU torch
has no uint32 arithmetic, so every hash works on int64 tensors holding
0..2^32-1 and masks after each multiply and shift: products of two 32-bit
values may pass 2^63, and int64 multiplication wraps modulo 2^64, which
leaves the low 32 bits exact.  Each hash returns int64 values in
[0, 2^32).
"""

from __future__ import annotations

import functools

import torch

from . import farmhash
from .keys import to_u64

__all__ = ["fmix32", "murmur3_32", "mix32", "identity_hash", "owner_from_hash",
           "HASHES"]

_M32 = 0xFFFFFFFF
_C1 = 0xCC9E2D51
_C2 = 0x1B873593


def _rotl32(x: torch.Tensor, r: int) -> torch.Tensor:
    return ((x << r) & _M32) | (x >> (32 - r))


def _mul(x: torch.Tensor, c: int) -> torch.Tensor:
    return (x * c) & _M32


def fmix32(h: torch.Tensor) -> torch.Tensor:
    """MurmurHash3's 32-bit finalizer on int64 values in [0, 2^32)."""
    h = h ^ (h >> 16)
    h = _mul(h, 0x85EBCA6B)
    h = h ^ (h >> 13)
    h = _mul(h, 0xC2B2AE35)
    return h ^ (h >> 16)


def _words(words: torch.Tensor) -> list:
    """The row's words as int64 values in [0, 2^32), word 0 first."""
    return [to_u64(words[..., j]) for j in range(words.shape[-1])]


def _full(words: torch.Tensor, value: int) -> torch.Tensor:
    return torch.full(words.shape[:-1], value & _M32, dtype=torch.int64,
                      device=words.device)


def murmur3_32(words: torch.Tensor, seed: int = 42) -> torch.Tensor:
    """MurmurHash3_x86_32 of each row of int32[..., nwords]: each word one
    4-byte block, 4 * nwords bytes, empty tail."""
    h = _full(words, seed)
    for k1 in _words(words):
        k1 = _mul(_rotl32(_mul(k1, _C1), 15), _C2)
        h = _rotl32(h ^ k1, 13)
        h = (h * 5 + 0xE6546B64) & _M32
    return fmix32(h ^ (4 * words.shape[-1]))


def identity_hash(words: torch.Tensor, seed: int = 0) -> torch.Tensor:
    """The k-mer's most significant word (kmer_hash.hpp:210-241)."""
    del seed
    return to_u64(words[..., 0])


def mix32(words: torch.Tensor, seed: int = 0x9E3779B1) -> torch.Tensor:
    """The independent xxHash32-style mixer of the JAX package."""
    p2, p3, p4 = 0x85EBCA77, 0xC2B2AE3D, 0x27D4EB2F
    h = _full(words, seed)
    for k in _words(words):
        k = _mul(_rotl32(_mul(k, p3), 17), p4)
        h = (_mul(_rotl32(h ^ k, 19), p2) + 0x165667B1) & _M32
    h = _mul(h ^ (h >> 15), p2)
    h = _mul(h ^ (h >> 13), p3)
    return h ^ (h >> 16)


def _farm_slot(words: torch.Tensor, seed: int = 42) -> torch.Tensor:
    """FarmHash64WithSeed of the row's words as a little-endian byte
    stream, folded hi ^ lo (the reference's farm DistHash,
    kmer_hash.hpp:288)."""
    return farmhash.farm32(words, seed)


def _fmix32_fold(words: torch.Tensor, seed: int = 0) -> torch.Tensor:
    return functools.reduce(lambda h, w: fmix32(h ^ w), _words(words),
                            _full(words, seed))


HASHES = {
    "murmur": murmur3_32,
    "farm": _farm_slot,
    "fmix32": _fmix32_fold,
    "identity": identity_hash,
}
# "std" fills the reference's cpp_std slot (std::hash per chunk,
# xor-combined — kmer_hash.hpp:157-209): the fmix32 fold plays that role
HASHES["std"] = HASHES["fmix32"]


def owner_from_hash(h: torch.Tensor, nparts: int) -> torch.Tensor:
    """Owner shard in [0, nparts) of each hash value (int64 in [0, 2^32)):
    the top log2(p) bits for a power-of-two p, else (h * p) >> 32 computed
    as a 16 + 16 split in wrapping 32-bit arithmetic, as the JAX package
    does.  int64."""
    if nparts & (nparts - 1) == 0:
        if nparts == 1:
            return torch.zeros_like(h)
        return h >> (33 - nparts.bit_length())
    hi, lo = h >> 16, h & 0xFFFF
    t = (hi * nparts + (((lo * nparts) & _M32) >> 16)) & _M32
    return t >> 16
