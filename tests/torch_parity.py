"""Shared numpy helpers for the PyTorch port's parity tests
(tests/test_torch_*.py): synthetic inputs made from a seed, and the
cross-package comparisons of read batches and k-mer words."""

from __future__ import annotations

import numpy as np
import torch

BATCH_COLUMNS = ("codes", "valid", "owned", "seg_id", "offset_in_record",
                 "global_pos", "qual", "record_start", "seq_index",
                 "file_id")


def assert_batches_equal(got, want):
    """ReadBatch from the port == ReadBatch from the JAX package, column by
    column (dtype and values), plus the alphabet by name."""
    for f in BATCH_COLUMNS:
        a, b = getattr(got, f), getattr(want, f)
        assert a.dtype == b.dtype, (f, a.dtype, b.dtype)
        np.testing.assert_array_equal(a, b, err_msg=f)
    assert (got.alphabet is None) == (want.alphabet is None)
    if got.alphabet is not None:
        assert got.alphabet.name == want.alphabet.name


def words_np(t: torch.Tensor) -> np.ndarray:
    """Port key words (int32 bit patterns) -> uint32 numpy."""
    return t.detach().cpu().contiguous().numpy().view(np.uint32)


def words_t(a: np.ndarray) -> torch.Tensor:
    """uint32 numpy key words -> port int32 tensor (same bits)."""
    return torch.from_numpy(np.ascontiguousarray(a, np.uint32).view(np.int32))


def sorted_key_cols(rng, w: int, n: int, hi_values: int = 4,
                    n_sentinel: int = 0) -> np.ndarray:
    """uint32[w, n] ascending run (lexicographic over the w words) with
    many ties in word 0 and `n_sentinel` all-ones rows at the tail."""
    live = n - n_sentinel
    cols = [rng.integers(0, hi_values, live, dtype=np.uint32)]
    cols += [rng.integers(0, 2**32, live, dtype=np.uint32)
             for _ in range(w - 1)]
    order = np.lexsort(cols[::-1])
    keys = np.full((w, n), 0xFFFFFFFF, np.uint32)
    keys[:, :live] = np.stack([c[order] for c in cols])
    return keys


def write_reads(path, n_reads: int, read_len: int, genome_len: int,
                seed: int, fmt: str = "fastq", n_rate: float = 0.0,
                line_width: int = 60):
    """Reads sampled from a random genome (half reverse-complemented), so
    the same k-mers recur on both strands; 'N' at rate `n_rate`.  FASTA
    records wrap at `line_width`.  Returns the read strings."""
    rng = np.random.default_rng(seed)
    alpha = np.frombuffer(b"ACGT", np.uint8)
    genome = rng.integers(0, 4, genome_len)
    starts = rng.integers(0, genome_len - read_len + 1, n_reads)
    codes = genome[starts[:, None] + np.arange(read_len)]
    flip = rng.random(n_reads) < 0.5
    codes[flip] = 3 - codes[flip, ::-1]
    seqs = alpha[codes]
    seqs[rng.random(seqs.shape) < n_rate] = ord("N")
    reads = [bytes(r).decode() for r in seqs]
    with open(path, "w") as f:
        for i, r in enumerate(reads):
            if fmt == "fastq":
                f.write(f"@r{i}\n{r}\n+\n{'I' * len(r)}\n")
            else:
                lines = "\n".join(r[j:j + line_width]
                                  for j in range(0, len(r), line_width))
                f.write(f">r{i}\n{lines}\n")
    return reads
