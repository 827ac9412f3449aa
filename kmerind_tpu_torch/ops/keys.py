"""How the port stores and orders k-mer key words.

Every k-mer word is an unsigned 32-bit value (``kmer.py`` layout, word 0
most significant).  PyTorch has no usable ``uint32`` (no ``<``, ``>>``,
``cummax`` or ``searchsorted`` on the CPU), so across the whole port a key
word is held as an **int32 tensor carrying the uint32 bit pattern**:

* the CUDA kernels read and write the same memory as ``uint32_t``;
* numpy interop is a zero-copy ``.view(np.uint32)`` / ``.view(np.int32)``;
* equality is plain int32 equality, and the all-ones sentinel
  ``0xFFFFFFFF`` is int32 ``-1`` (`SENTINEL`).

int32's signed order is not the unsigned order, so ordering code compares
``biased(x) = x ^ INT32_MIN``, whose signed order equals the unsigned order
of ``x`` (the sentinel maps to INT32_MAX and still sorts last).  Code that
needs the unsigned value itself (shifts, bucket indices) widens it with
`to_u64` to an int64 holding 0..2^32-1.
"""

from __future__ import annotations

import numpy as np
import torch

__all__ = ["SENTINEL", "INT32_MIN", "biased", "to_u64",
           "lex_argsort", "from_numpy_u32", "to_numpy_u32"]

SENTINEL = -1            # 0xFFFFFFFF as int32
INT32_MIN = -(1 << 31)


def biased(x: torch.Tensor) -> torch.Tensor:
    """int32 whose signed order is the unsigned order of the bits of x."""
    return x ^ INT32_MIN


def to_u64(x: torch.Tensor) -> torch.Tensor:
    """Zero-extended int64 value of int32-held uint32 bits."""
    return x.to(torch.int64) & 0xFFFFFFFF


def lex_argsort(cols, stable: bool = True) -> torch.Tensor:
    """Permutation sorting rows lexicographically by `cols`.

    cols: int32 [n] tensors, most significant first, compared as SIGNED
    (pass `biased` words for unsigned key order; small non-negative flags
    may go in as they are).  Two columns pack into one int64 key
    ``hi << 32 | (lo + 2^31)``; more columns sort least-significant pair
    first in stable passes (LSD), so one `torch.sort` serves w <= 2.
    """
    perm = None
    i = len(cols)
    while i > 0:
        j = max(0, i - 2)
        key = cols[j].to(torch.int64)
        if i - j == 2:
            key = (key << 32) | (cols[j + 1].to(torch.int64) - INT32_MIN)
        if perm is not None:
            key = key[perm]
        _, p = torch.sort(key, stable=stable or perm is not None)
        perm = p if perm is None else perm[p]
        i = j
    return perm


def from_numpy_u32(a: np.ndarray, device) -> torch.Tensor:
    """uint32 numpy array -> int32 tensor with the same bits on `device`."""
    a = np.array(a, dtype=np.uint32)  # a writable copy
    return torch.from_numpy(a.view(np.int32)).to(device)


def to_numpy_u32(t: torch.Tensor) -> np.ndarray:
    """int32 tensor of uint32 bits -> uint32 numpy array (host copy)."""
    return t.detach().cpu().contiguous().numpy().view(np.uint32)
