"""Plain PyTorch reference of kmerind's Bimolecule count map.

It works from generated read codes (uint8[r, L]: A, C, G, T = 0..3 and
N = 4, one read a row) and imports nothing of the packages under test.
Every k-window of a read is a k-mer: its bases as 2-bit codes, an N read
as A (kmerind's 2-bit DNA alphabet), the first base in the top bits, so
codes order as the strings do.  Its key is canonical, the smaller code of
the window and its reverse complement, and its strand is 1 where the
window is not its own canonical form.  Its long position id is its
global base offset, read * L + offset in the read, so ids order the
windows as the file does; explicitly inserted k-mers take ids after
every file id, in the order given.

A key's count is the number of its windows (and inserts).  The map
REPORTS each key in the input orientation of its earliest occurrence,
the one with the smallest id: reverse-complemented where that
occurrence's strand is 1.  k is odd here (k = 31 in the benchmark), so no
k-mer is its own reverse complement and that orientation is always
defined.

Every function takes the device to compute on and works in blocks of
reads.  k <= 31, so a k-mer fits one int64.
"""

from __future__ import annotations

import numpy as np
import torch

BLOCK_READS = 1 << 18


def _windows(c: torch.Tensor, k: int):
    """(forward codes int64 [r, nwin], reverse-complement codes) of every
    k-window of the reads `c` [r, L], N read as A."""
    nwin = c.shape[1] - k + 1
    x = torch.where(c == 4, 0, c).to(torch.int64)
    fwd = torch.zeros((c.shape[0], nwin), dtype=torch.int64, device=c.device)
    rc = torch.zeros_like(fwd)
    for j in range(k):
        fwd = (fwd << 2) | x[:, j:j + nwin]
        rc = (rc << 2) | (3 - x[:, k - 1 - j:k - 1 - j + nwin])
    return fwd, rc


def _check_k(k: int):
    if 2 * k > 62:
        raise ValueError("the reference keeps a k-mer in one int64 (k <= 31)")
    if k % 2 == 0:
        raise ValueError("an even k has k-mers that are their own reverse "
                         "complement, whose orientation is not defined")


def revcomp(codes: torch.Tensor, k: int) -> torch.Tensor:
    """int64 codes of the reverse complements of the k-mer codes."""
    out = torch.zeros_like(codes)
    for j in range(k):
        out = (out << 2) | (3 - ((codes >> (2 * j)) & 3))
    return out


def canonical(codes: torch.Tensor, k: int) -> torch.Tensor:
    """int64 canonical codes of the k-mer codes, in either orientation."""
    return torch.minimum(codes, revcomp(codes, k))


def windows(codes: np.ndarray, k: int, device):
    """(canonical codes int64[n], strands int64[n], long ids int64[n]) of
    every k-window of the reads, read by read and window by window: file
    order."""
    _check_k(k)
    keys, strands, ids = [], [], []
    for lo in range(0, codes.shape[0], BLOCK_READS):
        c = torch.from_numpy(codes[lo:lo + BLOCK_READS]).to(device)
        fwd, rc = _windows(c, k)
        keys.append(torch.minimum(fwd, rc).reshape(-1))
        strands.append((rc < fwd).to(torch.int64).reshape(-1))
        r = torch.arange(lo, lo + c.shape[0], device=device)[:, None]
        j = torch.arange(fwd.shape[1], device=device)[None, :]
        ids.append((r * codes.shape[1] + j).reshape(-1))
    if not keys:
        z = torch.zeros(0, dtype=torch.int64, device=device)
        return z, z.clone(), z.clone()
    return torch.cat(keys), torch.cat(strands), torch.cat(ids)


def table(codes: np.ndarray, k: int, device, inserted=None, last=False):
    """(sorted distinct canonical codes int64[t], counts int64[t], strand
    int64[t] of each key's earliest occurrence): the contents of a
    Bimolecule count map built from the reads, then given the input-strand
    k-mer codes `inserted` (int64, each one count).  The windows are
    sorted by key stably in id order, so each key's run starts at its
    earliest occurrence.  With `last` the strand is the LATEST
    occurrence's instead, as a hash map that overwrites would store it."""
    keys, strands, ids = windows(codes, k, device)
    if inserted is not None and len(inserted):
        ins = torch.as_tensor(np.asarray(inserted, np.int64), device=device)
        rc = revcomp(ins, k)
        first = ids[-1] + 1 if ids.numel() else 0
        keys = torch.cat([keys, torch.minimum(ins, rc)])
        strands = torch.cat([strands, (rc < ins).to(torch.int64)])
        ids = torch.cat([ids, first + torch.arange(ins.numel(),
                                                   device=device)])
    sk, order = torch.sort(keys, stable=True)
    del keys
    uniq, counts = torch.unique_consecutive(sk, return_counts=True)
    ends = torch.cumsum(counts, 0)
    at = ends - 1 if last else ends - counts
    return uniq, counts, strands[order[at]]


def stored(keys: torch.Tensor, strand: torch.Tensor, k: int) -> torch.Tensor:
    """int64 codes of canonical keys in their stored orientation:
    reverse-complemented where the strand is 1."""
    return torch.where(strand == 1, revcomp(keys, k), keys)


def find(keys: torch.Tensor, counts: torch.Tensor, strand: torch.Tensor,
         queries: torch.Tensor, k: int):
    """(stored codes int64[h], counts int64[h]) of the queries found, in
    query order: each query k-mer code, in either orientation, answered by
    its canonical key's count and stored orientation; absent ones are left
    out."""
    q = canonical(queries, k)
    if keys.numel() == 0:
        z = torch.zeros(0, dtype=torch.int64, device=queries.device)
        return z, z.clone()
    pos = torch.searchsorted(keys, q).clamp_(max=keys.numel() - 1)
    pos = pos[keys[pos] == q]
    return stored(keys[pos], strand[pos], k), counts[pos]


def items(keys: torch.Tensor, counts: torch.Tensor, strand: torch.Tensor,
          k: int):
    """(stored codes int64[t], counts int64[t]) of every key, in canonical
    key order."""
    return stored(keys, strand, k), counts
