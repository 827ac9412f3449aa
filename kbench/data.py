"""The benchmark's inputs: seeded reads, their phred scores and their FASTQ.

`make_reads`, `make_quals` and `write_fastq` are frozen copies of
``chip_smoke.py`` ``make_reads`` / ``make_quals`` / ``write_fastq``
(lines 391-453 there), with the read length, the error rates and the
record layout made parameters.  With ``read_len=150`` and the default
rates they draw the same numbers in the same order as the originals.
They are copies so that a later change to the smoke script never moves
this yardstick: do not edit them.

`pack_windows` is the benchmark's own query packing: every k-window of a
set of reads, as the uint32 key rows the index API takes.
"""

from __future__ import annotations

import os
import pathlib

import numpy as np
import torch

#: "@r" + 7 digits + "\n" before each sequence
ID_DIGITS = 7
SEQ_OFFSET = 3 + ID_DIGITS


def record_bytes(read_len: int) -> int:
    """Bytes of one `write_fastq` record."""
    return SEQ_OFFSET + 2 * (read_len + 1) + 2


def make_reads(genome_len: int, n_reads: int, seed: int, read_len: int,
               sub_rate: float = 0.005, n_rate: float = 0.001) -> np.ndarray:
    """uint8[n_reads, read_len] codes (A,C,G,T = 0..3, N = 4): reads of a
    random genome, half reverse-complemented, `sub_rate` substitutions,
    `n_rate` N."""
    rng = np.random.default_rng(seed)
    genome = rng.integers(0, 4, genome_len, dtype=np.uint8)
    windows = np.lib.stride_tricks.sliding_window_view(genome, read_len)
    codes = windows[rng.integers(0, genome_len - read_len + 1, n_reads)]
    flip = rng.random(n_reads) < 0.5
    codes[flip] = 3 - codes[flip, ::-1]
    flat = codes.reshape(-1)
    nsub = rng.binomial(flat.size, sub_rate)
    pos = rng.integers(0, flat.size, nsub)
    flat[pos] = (flat[pos] + rng.integers(1, 4, nsub, dtype=np.uint8)) % 4
    flat[rng.integers(0, flat.size, rng.binomial(flat.size, n_rate))] = 4
    return codes


def make_quals(codes: np.ndarray, seed: int) -> np.ndarray:
    """uint8 phred scores of the shape of `codes`, drawn from the seed
    after the reads (which they do not change): 2-41, mostly high, 2 ('#')
    on every N, and 0 ('!', a base the codec reads as incorrect, whose
    windows have quality exactly 0) at a rate of 0.05 %."""
    rng = np.random.default_rng(seed + 1000)
    q = 41 - np.minimum(rng.geometric(0.15, codes.shape) - 1, 39)
    q[codes == 4] = 2
    q[rng.random(codes.shape) < 0.0005] = 0
    return q.astype(np.uint8)


def write_fastq(codes: np.ndarray, quals: np.ndarray, path: pathlib.Path):
    """Fixed-width FASTQ records (`record_bytes` each, the sequence at byte
    SEQ_OFFSET of its record), written in one vectorized pass and synced
    to disk, so no write-back runs while the file is read."""
    n, read_len = codes.shape
    if n >= 10 ** ID_DIGITS:
        raise ValueError(f"{n} reads do not fit {ID_DIGITS}-digit names")
    width = record_bytes(read_len)
    rec = np.empty((n, width), np.uint8)
    rec[:, 0], rec[:, 1] = ord("@"), ord("r")
    ids = np.arange(n)
    for p in range(ID_DIGITS):
        rec[:, 2 + p] = 48 + (ids // 10 ** (ID_DIGITS - 1 - p)) % 10
    s = SEQ_OFFSET + read_len
    rec[:, SEQ_OFFSET - 1] = rec[:, s] = rec[:, s + 2] = rec[:, width - 1] = 10
    rec[:, SEQ_OFFSET:s] = np.frombuffer(b"ACGTN", np.uint8)[codes]
    rec[:, s + 1] = ord("+")
    rec[:, s + 3:width - 1] = 33 + quals
    with open(path, "wb") as f:
        rec.tofile(f)
        f.flush()
        os.fsync(f.fileno())


def pack_windows(codes: np.ndarray, k: int, device) -> np.ndarray:
    """uint32[m, ceil(k / 16)] key rows of every k-window of the reads
    `codes` (read by read, windows in order; N read as A, as the DNA
    alphabet reads it), packed as the index API takes DNA k-mers: 16 bases
    a word, the first base in the top bits of word 0, the last word
    right-aligned.  Packed on `device` in blocks of reads."""
    cpw = 16
    nwords = -(-k // cpw)
    out = []
    for lo in range(0, codes.shape[0], 1 << 16):
        c = torch.from_numpy(codes[lo:lo + (1 << 16)]).to(device)
        c = torch.where(c == 4, 0, c).to(torch.int64)
        nwin = c.shape[1] - k + 1
        words = []
        for w in range(nwords):
            v = torch.zeros((c.shape[0], nwin), dtype=torch.int64,
                            device=device)
            for j in range(w * cpw, min(k, (w + 1) * cpw)):
                v = (v << 2) | c[:, j:j + nwin]
            words.append(v.reshape(-1))
        out.append(torch.stack(words, 1).to(torch.int32).cpu().numpy()
                   .view(np.uint32))
    return np.concatenate(out) if out else np.zeros((0, nwords), np.uint32)


def words_to_codes(words: np.ndarray, k: int) -> np.ndarray:
    """int64 codes (2 bits a base, the first base on top) of DNA key rows
    uint32[m, ceil(k / 16)] as `pack_windows` lays them out."""
    nwords = -(-k // 16)
    out = np.zeros(words.shape[0], np.int64)
    for w in range(nwords):
        bits = 2 * min(16, k - 16 * w)
        out = (out << bits) | words[:, w].astype(np.int64)
    return out


def codes_to_words(codes: np.ndarray, k: int) -> np.ndarray:
    """The inverse of `words_to_codes`."""
    nwords = -(-k // 16)
    out = np.zeros((codes.shape[0], nwords), np.uint32)
    rest = codes.astype(np.int64)
    for w in range(nwords - 1, -1, -1):
        bits = 2 * min(16, k - 16 * w)
        out[:, w] = (rest & ((1 << bits) - 1)).astype(np.uint32)
        rest = rest >> bits
    return out
