"""Edge bytes of de Bruijn graph construction (plain PyTorch).

The port of ``kmerind_tpu.debruijn.edges`` (the reference's edge
iterator, test/test/debruijn/edge_iterator.hpp:56-170): for every k-mer
window one byte packs the DNA16 one-hot codes of the neighbouring bases —
the upper 4 bits the LEFT (in-edge) base, the lower 4 bits the RIGHT
(out-edge) base.  A window at a record's end gets 0 (the gap '.', no edge
bits) on the missing side.

When canonicalization stores a window's reverse complement, its edge byte
is reverse-complemented too — halves swapped, each 4-bit code
bit-reversed (input_edge_utils::reverse_complement_edges,
de_bruijn_node_trait.hpp:120-127) — so a node's counters are always
ordered for the canonical strand.
"""

from __future__ import annotations

import functools

import numpy as np
import torch

from ..alphabets import DNA16, Alphabet

__all__ = ["dna16_code_lut", "edge_bytes_for_windows", "revcomp_edge_byte",
           "edge_byte_to_vec"]


@functools.lru_cache(maxsize=None)
def dna16_code_lut(alphabet: Alphabet) -> np.ndarray:
    """uint8[size]: alphabet code -> DNA16 one-hot code
    (DNA16::FROM_ASCII[ALPHA::TO_ASCII[c]], de_bruijn_node_trait.hpp:
    230-233)."""
    return DNA16.from_ascii[alphabet.to_ascii]


def _shift(a: torch.Tensor, s: int) -> torch.Tensor:
    """a'[i] = a[i + s] (s < 0 looks behind), zero-filled off either end."""
    out = torch.zeros_like(a)
    n = a.shape[0]
    if s >= 0 and s < n:
        out[:n - s] = a[s:]
    elif s < 0 and -s < n:
        out[-s:] = a[:n + s]
    return out


def edge_bytes_for_windows(codes: torch.Tensor, valid: torch.Tensor,
                           seg_id: torch.Tensor, k: int, alphabet: Alphabet,
                           raw: bool = False) -> torch.Tensor:
    """uint8[n]: the edge byte of the k-mer window starting at each
    position.  The left base is codes[i - 1] and the right base codes[i +
    k], each where it exists, is valid and lies in the window's record
    (same seg_id); a missing side encodes as 0.

    raw=True: `codes` are raw ASCII bytes and a nibble is
    DNA16::FROM_ASCII[byte], as the reference's edge iterator reads raw
    chars (edge_iterator.hpp:130-170): an 'N' neighbour is 0xF (all four
    bases).  raw=False: `codes` are in the k-mer alphabet and go through
    `dna16_code_lut` (lossy for bytes outside the alphabet: 'N' -> 'A'
    under DNA)."""
    dev = codes.device
    lut = torch.tensor(DNA16.from_ascii if raw else dna16_code_lut(alphabet),
                       device=dev)
    d16 = lut[codes.to(torch.int64)].to(torch.int32)
    n = codes.shape[0]
    idx = torch.arange(n, device=dev)
    left_ok = _shift(valid, -1) & (_shift(seg_id, -1) == seg_id) & (idx >= 1)
    right_ok = (_shift(valid, k) & (_shift(seg_id, k) == seg_id)
                & (idx + k < n))
    left4 = torch.where(left_ok, _shift(d16, -1), 0)
    right4 = torch.where(right_ok, _shift(d16, k), 0)
    return ((left4 << 4) | right4).to(torch.uint8)


def _rev4(x: torch.Tensor) -> torch.Tensor:
    return ((x & 1) << 3) | ((x & 2) << 1) | ((x & 4) >> 1) | ((x & 8) >> 3)


def revcomp_edge_byte(edge: torch.Tensor) -> torch.Tensor:
    """Reverse-complement edge bytes: swap the halves, 4-bit-reverse each
    (the DNA16 complement is the bit reversal)."""
    e = edge.to(torch.int32)
    return ((_rev4(e & 0xF) << 4) | _rev4((e >> 4) & 0xF)).to(edge.dtype)


def edge_byte_to_vec(edge: torch.Tensor) -> torch.Tensor:
    """int32[n, 9] counter increments of uint8[n] edge bytes: [out A, C, G,
    T, in A, C, G, T, self] (edge_counts::update,
    de_bruijn_node_trait.hpp:195-245: one increment per set DNA16 bit)."""
    e = edge.to(torch.int32)
    bits = [(e >> b) & 1 for b in range(8)]
    return torch.stack(bits + [torch.ones_like(e)], dim=1)
