"""FarmHash64 (farmhashna) vectorized over key-word tensors.

The port of ``kmerind_tpu.ops.farmhash``: a bit-exact FarmHash64WithSeed
(the reference's `farm` hash functor, src/index/kmer_hash.hpp:288, over
ext/farmhash/src/farmhash.cc namespace farmhashna) for streams of up to 64
bytes — every realistic k-mer.

Every 64-bit quantity is one int64 tensor holding the uint64 bits:
addition, subtraction, xor and multiplication wrap modulo 2^64 exactly as
uint64 does.  Only the right shift differs — torch's ``>>`` on int64 is
arithmetic and drags the sign bit in — so `_shr` masks the top bits off.
The byte stream is never materialized: farmhashna reads it only through
Fetch64 / Fetch32 / byte loads at static offsets, which become shifts and
ors of the packed words.

Two stream layouts, as in the JAX package:

* `hash64_words` — the row's uint32 words as a little-endian byte stream,
  word 0 first, 4 * nwords bytes (the `farm` slot of ``hashing.HASHES``);
* `hash64_kmers` — the reference's stream: the k-mer value in little-endian
  byte order, ceil(nbits / 8) bytes (kmer.hpp:78-100).
"""

from __future__ import annotations

import numpy as np
import torch

from .keys import to_u64

__all__ = ["hash64_words", "hash64_kmers", "hash64_bytes", "farm32"]

_M32 = 0xFFFFFFFF
_M64 = (1 << 64) - 1
_K0 = 0xC3A5C85C97CB3127
_K1 = 0xB492B66FBE98F273
_K2 = 0x9AE16A3B2F90404F
_KMUL = 0x9DDFEA08EB382D69  # Hash128to64's multiplier


def _c(v: int) -> int:
    """A uint64 constant as the int64 with the same bits."""
    v &= _M64
    return v - (1 << 64) if v >> 63 else v


def _shr(a: torch.Tensor, s: int) -> torch.Tensor:
    """Logical right shift of int64-held uint64 bits."""
    if s == 0:
        return a
    return (a >> s) & ((1 << (64 - s)) - 1)


def _rot(a: torch.Tensor, s: int) -> torch.Tensor:
    """farmhash Rotate64: rotate RIGHT by 0 < s < 64."""
    return _shr(a, s) | (a << (64 - s))


def _shift_mix(a):
    return a ^ _shr(a, 47)


def _hash_len_16_mul(u, v, mul):
    """HashLen16(u, v, mul) — farmhash.cc:378."""
    a = _shift_mix((u ^ v) * mul)
    b = _shift_mix((v ^ a) * mul)
    return b * mul


def _hash_128_to_64(lo64, hi64):
    """Hash128to64(Uint128(lo, hi)) — farmhash.h:129."""
    return _hash_len_16_mul(lo64, hi64, _c(_KMUL))


def _hash64(u32_at, length: int):
    """farmhashna::Hash64 of a static-length (<= 64 bytes) stream.
    u32_at(byte_off): the little-endian uint32 at that offset (int64)."""

    def f64(o):  # Fetch64: the later four bytes are the high half
        return (u32_at(o + 4) << 32) | u32_at(o)

    k0, k1, k2 = _c(_K0), _c(_K1), _c(_K2)
    mul = _c(_K2 + length * 2)
    if length <= 16:
        # HashLen0to16, farmhash.cc:388
        if length >= 8:
            a = f64(0) + k2
            b = f64(length - 8)
            c = _rot(b, 37) * mul + a
            d = (_rot(a, 25) + b) * mul
            return _hash_len_16_mul(c, d, mul)
        if length >= 4:
            u = length + (u32_at(0) << 3)
            return _hash_len_16_mul(u, u32_at(length - 4), mul)
        if length > 0:
            a = u32_at(0) & 0xFF
            b = u32_at(length >> 1) & 0xFF
            c = u32_at(length - 1) & 0xFF
            y = a + (b << 8)
            z = length + (c << 2)
            return _shift_mix(y * k2 ^ z * k0) * k2
        raise ValueError("farmhash of an empty stream")
    if length <= 32:
        # HashLen17to32, farmhash.cc:415
        a = f64(0) * k1
        b = f64(8)
        c = f64(length - 8) * mul
        d = f64(length - 16) * k2
        return _hash_len_16_mul(_rot(a + b, 43) + _rot(c, 30) + d,
                                a + _rot(b + k2, 18) + c, mul)
    if length <= 64:
        # HashLen33to64, farmhash.cc:450
        a = f64(0) * k2
        b = f64(8)
        c = f64(length - 8) * mul
        d = f64(length - 16) * k2
        y = _rot(a + b, 43) + _rot(c, 30) + d
        z = _hash_len_16_mul(y, a + _rot(b + k2, 18) + c, mul)
        e = f64(16) * mul
        f = f64(24)
        g = (y + f64(length - 32)) * mul
        h = (z + f64(length - 24)) * mul
        return _hash_len_16_mul(_rot(e + f, 43) + _rot(g, 30) + h,
                                e + _rot(f + a, 18) + g, mul)
    raise ValueError(f"farmhash streams > 64 bytes unsupported ({length})")


def _hash64_with_seed(u32_at, length: int, seed: int):
    """farmhashna::Hash64WithSeed = HashLen16(Hash64(s) - k2, seed)
    (farmhash.cc:523-528), as (hi, lo) int64 halves in [0, 2^32)."""
    h = _hash64(u32_at, length)
    h = _hash_128_to_64(h - _c(_K2), torch.full_like(h, _c(seed)))
    return _shr(h, 32), h & _M32


def _word_stream(words: torch.Tensor):
    """u32_at over the words-as-little-endian-bytes stream, word 0 first."""
    cols = [to_u64(words[..., j]) for j in range(words.shape[-1])]

    def u32_at(o: int):
        w, sh = divmod(o, 4)
        out = cols[w] >> (8 * sh) if w < len(cols) else torch.zeros_like(
            cols[0])
        if sh and w + 1 < len(cols):
            out = out | ((cols[w + 1] << (32 - 8 * sh)) & _M32)
        return out

    return u32_at


def _kmer_stream(words: torch.Tensor, spec):
    """u32_at over the reference's stream: the k-mer value V (word 0 most
    significant, word_bits(w) significant bits each, contiguous) in
    little-endian byte order."""
    wbits = spec.word_bits()
    cols = [to_u64(words[..., j]) for j in range(spec.nwords)]
    cshift = [sum(wbits[w + 1:]) for w in range(spec.nwords)]

    def u32_at(o: int):
        out = torch.zeros_like(cols[0])
        for w, col in enumerate(cols):
            s = cshift[w] - 8 * o
            if s >= 32 or s + wbits[w] <= 0:
                continue  # word w lies outside [8o, 8o + 32)
            out = out | ((col << s) & _M32 if s >= 0 else col >> -s)
        return out

    return u32_at


def hash64_words(words: torch.Tensor, seed: int = 42):
    """FarmHash64WithSeed of each row's words as a little-endian byte
    stream of 4 * nwords bytes: a (hi, lo) pair of int64 in [0, 2^32)."""
    return _hash64_with_seed(_word_stream(words), 4 * words.shape[-1], seed)


def hash64_kmers(words: torch.Tensor, spec, seed: int = 42):
    """Bit-exact `util::Hash64WithSeed(kmer.getData(), nBytes, seed)` of
    the reference's farm functor (kmer_hash.hpp:288) per packed k-mer row:
    a (hi, lo) pair of int64 in [0, 2^32)."""
    return _hash64_with_seed(_kmer_stream(words, spec), (spec.nbits + 7) // 8,
                             seed)


def hash64_bytes(data: bytes, seed: int = 42) -> int:
    """FarmHash64WithSeed of a byte string of 1 to 64 bytes, as a Python
    int — a host helper for checks and tools."""
    n = len(data)
    if n == 0 or n > 64:
        raise ValueError("1..64 bytes supported")
    buf = np.frombuffer(data + b"\x00" * ((-n) % 4 + 8), dtype="<u4")
    words = torch.from_numpy(buf.astype(np.uint32).view(np.int32))[None]
    hi, lo = _hash64_with_seed(_word_stream(words), n, seed)
    return (int(hi[0]) << 32) | int(lo[0])


def farm32(words: torch.Tensor, seed: int = 42) -> torch.Tensor:
    """The 32-bit fold hi ^ lo of `hash64_words` — the `farm` slot."""
    hi, lo = hash64_words(words, seed)
    return hi ^ lo
