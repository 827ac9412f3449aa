"""Plain PyTorch reference of a canonical de Bruijn graph's node counters.

A frozen copy of ``tests/plain_debruijn.py``, the reference the CPU
tests hold the port to, so that a later change to the tests never
moves this yardstick: do not edit it.  A test keeps the two equal.

It works from generated read codes (uint8[r, L]: A, C, G, T = 0..3 and
N = 4, one read a row) and imports nothing of the packages under test.
Every k-window of a read is a node: its bases as 2-bit codes, an N read
as A (kmerind's 2-bit DNA alphabet), the first base in the top bits, so
codes order as the strings do; the node is the smaller code of the
window and its reverse complement (the forward one on a tie).

A window's edge byte holds the DNA16 one-hot code (A, C, G, T = 1, 2, 4,
8; N = 0xF, all four bases) of the base after the window in its low
nibble and of the base before it in its high nibble, 0 where the read
ends (kmerind's edge iterator).  Where the node is the window's reverse
complement, the byte is reverse-complemented: halves swapped, each nibble
bit-reversed.  A node's 9 counters [out A, C, G, T; in A, C, G, T; self]
count its windows' set bits, low nibble first, and its windows.

Every function takes the device to compute on and works in blocks of
reads.  k <= 31, so a node fits one int64.
"""

from __future__ import annotations

import numpy as np
import torch

BLOCK_READS = 1 << 18
#: DNA16 codes of A, C, G, T and N, by read code
DNA16 = (0x1, 0x2, 0x4, 0x8, 0xF)


def _rev4(x: torch.Tensor) -> torch.Tensor:
    return ((x & 1) << 3) | ((x & 2) << 1) | ((x & 4) >> 1) | ((x & 8) >> 3)


def _windows(c: torch.Tensor, k: int, n_edge: int):
    """(node codes int64 [r, nwin], edge bytes int64 [r, nwin]) of every
    k-window of the reads `c` [r, L], an N neighbour's nibble `n_edge`."""
    if 2 * k > 62:
        raise ValueError("the reference keeps a k-mer in one int64 (k <= 31)")
    nwin = c.shape[1] - k + 1
    x = torch.where(c == 4, 0, c).to(torch.int64)
    fwd = torch.zeros((c.shape[0], nwin), dtype=torch.int64, device=c.device)
    rc = torch.zeros_like(fwd)
    for j in range(k):
        fwd = (fwd << 2) | x[:, j:j + nwin]
        rc = (rc << 2) | (3 - x[:, k - 1 - j:k - 1 - j + nwin])
    lut = torch.tensor(DNA16[:4] + (n_edge,), dtype=torch.int64,
                       device=c.device)
    d16 = lut[c.to(torch.int64)]
    left = torch.zeros_like(fwd)
    right = torch.zeros_like(fwd)
    left[:, 1:] = d16[:, :nwin - 1]
    right[:, :nwin - 1] = d16[:, k:]
    edge = torch.where(rc < fwd, (_rev4(right) << 4) | _rev4(left),
                       (left << 4) | right)
    return torch.minimum(fwd, rc), edge


def canonical_codes(codes: np.ndarray, k: int, device) -> torch.Tensor:
    """int64 node codes of every k-window of the reads, read by read and
    window by window: the codes of the queries that ask for them."""
    out = [_windows(torch.from_numpy(codes[lo:lo + BLOCK_READS]).to(device),
                    k, DNA16[4])[0].reshape(-1)
           for lo in range(0, codes.shape[0], BLOCK_READS)]
    return torch.cat(out) if out else torch.zeros(0, dtype=torch.int64,
                                                  device=device)


def node_table(codes: np.ndarray, k: int, device, n_edge: int = DNA16[4]):
    """(sorted node codes int64[n], counters int64[n, 9]): every node of
    the graph of the reads, with its 9 counters.  `n_edge` is the nibble
    an N neighbour sets (DNA16: 0xF)."""
    nodes, edges = [], []
    for lo in range(0, codes.shape[0], BLOCK_READS):
        c = torch.from_numpy(codes[lo:lo + BLOCK_READS]).to(device)
        node, edge = _windows(c, k, n_edge)
        nodes.append(node.reshape(-1))
        edges.append(edge.reshape(-1).to(torch.uint8))
    if not nodes:
        return (torch.zeros(0, dtype=torch.int64, device=device),
                torch.zeros((0, 9), dtype=torch.int64, device=device))
    keys, inv, windows = torch.unique(torch.cat(nodes), sorted=True,
                                      return_inverse=True,
                                      return_counts=True)
    edge = torch.cat(edges).to(torch.int64)
    table = torch.zeros((keys.numel(), 9), dtype=torch.int64, device=device)
    for b in range(8):
        table[:, b].index_add_(0, inv, (edge >> b) & 1)
    table[:, 8] = windows
    return keys, table


def node_counts(keys: torch.Tensor, table: torch.Tensor,
                queries: torch.Tensor):
    """(counters int64[m, 9], found bool[m]) of each query node code in the
    graph (keys, table): zeros and not found where it is absent."""
    if keys.numel() == 0:
        return (torch.zeros((queries.numel(), 9), dtype=torch.int64,
                            device=queries.device),
                torch.zeros_like(queries, dtype=torch.bool))
    pos = torch.searchsorted(keys, queries).clamp_(max=keys.numel() - 1)
    found = keys[pos] == queries
    return torch.where(found[:, None], table[pos], 0), found
