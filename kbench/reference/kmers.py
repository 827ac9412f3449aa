"""Plain PyTorch reference of what a k-mer index built from the reads holds.

It works from the generated read codes and phred scores that the FASTQ
was written from, and imports nothing of the program under test.  DNA
codes A, C, G, T = 0..3 and N = 4; the DNA alphabet reads N as A (as
kmerind's 2-bit DNA alphabet does), so every window is a k-mer.
A k-mer's code is its 2-bit bases read as one integer, the first base
in the top bits, so codes order as the strings do; its canonical form is
the smaller code of the k-mer and its reverse complement.  Every
function takes the device to compute on and works in blocks of reads.
"""

from __future__ import annotations

import numpy as np
import torch

BLOCK_READS = 1 << 18


def _windows(c: torch.Tensor, k: int):
    """(forward codes int64 [r, nwin], reverse-complement codes) of every
    k-window of the uint8 reads `c` [r, L], N read as A."""
    nwin = c.shape[1] - k + 1
    x = torch.where(c == 4, 0, c).to(torch.int64)
    fwd = torch.zeros((c.shape[0], nwin), dtype=torch.int64, device=c.device)
    rc = torch.zeros_like(fwd)
    for j in range(k):
        fwd = (fwd << 2) | x[:, j:j + nwin]
        rc = (rc << 2) | (3 - x[:, k - 1 - j:k - 1 - j + nwin])
    return fwd, rc


def canonical_codes(codes: np.ndarray, k: int, device) -> torch.Tensor:
    """int64 canonical codes of every k-window of the reads, read by read
    and window by window."""
    if 2 * k > 62:
        raise ValueError("the reference keeps a k-mer in one int64 (k <= 31)")
    out = []
    for lo in range(0, codes.shape[0], BLOCK_READS):
        c = torch.from_numpy(codes[lo:lo + BLOCK_READS]).to(device)
        fwd, rc = _windows(c, k)
        out.append(torch.minimum(fwd, rc).reshape(-1))
    return torch.cat(out) if out else torch.zeros(0, dtype=torch.int64,
                                                  device=device)


def window_table(codes: np.ndarray, k: int, device):
    """(sorted distinct canonical codes int64, their counts int64): the
    contents of a canonical count index built from the reads."""
    return torch.unique(canonical_codes(codes, k, device), sorted=True,
                        return_counts=True)


def lookup(keys: torch.Tensor, counts: torch.Tensor,
           queries: torch.Tensor) -> torch.Tensor:
    """int64 count of each query code in the table (keys, counts), 0 where
    it is absent."""
    if keys.numel() == 0:
        return torch.zeros_like(queries)
    pos = torch.searchsorted(keys, queries).clamp_(max=keys.numel() - 1)
    return torch.where(keys[pos] == queries, counts[pos],
                       torch.zeros_like(queries))


def window_quality(quals: torch.Tensor, k: int) -> torch.Tensor:
    """float64 [r, L - k + 1] quality of every k-window of the phred scores
    `quals` [r, L]: the product of its bases' probabilities of being
    right, 1 - 10^(-q/10), or 0 where a base has phred 0 — from float64
    prefix sums of the log2 probabilities."""
    q = quals.to(torch.float64)
    logp = torch.where(quals == 0, torch.zeros_like(q),
                       torch.log2(1.0 - torch.pow(10.0, -q / 10.0)))
    nwin = quals.shape[1] - k + 1
    cs = torch.nn.functional.pad(torch.cumsum(logp, 1), (1, 0))
    zeros = torch.nn.functional.pad(torch.cumsum((quals == 0).to(
        torch.int32), 1), (1, 0))
    bad = zeros[:, k:k + nwin] > zeros[:, :nwin]
    return torch.where(bad, torch.zeros_like(cs[:, :nwin]),
                       torch.exp2(cs[:, k:k + nwin] - cs[:, :nwin]))


def window_pairs(codes: np.ndarray, quals: np.ndarray, k: int, keep,
                 record_bytes: int, seq_offset: int, device):
    """(canonical code, position id, quality) of every window whose
    canonical code is in the sorted int64 tensor `keep`, as int64, int64
    and float64 tensors.  A window's position id is its read's record
    start in the FASTQ shifted left 16 bits, or'd with the window's byte
    offset in its record (the short-read id); the records are
    `record_bytes` wide with the sequence at `seq_offset`."""
    keys, ids, qs = [], [], []
    for lo in range(0, codes.shape[0], BLOCK_READS):
        c = torch.from_numpy(codes[lo:lo + BLOCK_READS]).to(device)
        fwd, rc = _windows(c, k)
        canon = torch.minimum(fwd, rc)
        hit = torch.isin(canon, keep)
        if not bool(hit.any()):
            continue
        r, j = torch.nonzero(hit, as_tuple=True)
        wq = window_quality(torch.from_numpy(
            quals[lo:lo + BLOCK_READS]).to(device), k)
        keys.append(canon[r, j])
        ids.append(((r + lo) * record_bytes << 16) | (j + seq_offset))
        qs.append(wq[r, j])
    if not keys:
        z = torch.zeros(0, dtype=torch.int64, device=device)
        return z, z.clone(), z.to(torch.float64)
    return torch.cat(keys), torch.cat(ids), torch.cat(qs)
