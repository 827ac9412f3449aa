"""K4 run-length weights: the port's plain version (the kernel wrapper's CPU
path, ``kernels.run_length_weights``) and ``sortops.run_length_counts``
against the JAX package's Pallas kernel in interpret mode and its
``sortops.run_length_counts``, at the shapes of test_runlength_pallas.py.
Integer outputs: exact equality."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from kmerind_tpu.ops import sortops as jsort
from kmerind_tpu.ops.pallas_kernels import run_length_weights_pallas
from kmerind_tpu_torch.ops import kernels, sortops

from torch_parity import words_t

PALLAS_BLOCK = 2048 * 128      # rows per Pallas grid block


def _make_sorted(rng, n, w, nkeys, tv):
    """Rows with a sorted valid prefix of tv rows (sort_rows' invariant)."""
    keys = rng.integers(0, 2**32, (max(nkeys, 1), w), dtype=np.uint32)
    pick = keys[rng.integers(0, max(nkeys, 1), n)]
    pre = pick[:tv]
    pre = pre[np.lexsort(pre.T[::-1])]
    return np.concatenate([pre, pick[tv:]])


SHAPES = [
    (1 << 12, 2, 50, 1.0),       # exactly one block
    (1 << 12, 2, 50, 0.7),       # invalid tail inside the block
    (300000, 1, 7, 0.9),         # non-multiple length; long runs
    (1 << 19, 3, 100000, 0.99),  # multiple blocks, 3-word keys
    (5000, 2, 1, 1.0),           # a single run spanning everything
    (4096, 2, 10, 0.0),          # all rows invalid
]


def _port(swords, tv):
    w = kernels.run_length_weights(words_t(swords.T),
                                   torch.tensor(tv, dtype=torch.int32))
    return w.numpy()


@pytest.mark.parametrize("n,w,nkeys,tvfrac", SHAPES)
def test_matches_jax_run_length_counts(n, w, nkeys, tvfrac):
    rng = np.random.default_rng(n + w)
    tv = int(n * tvfrac)
    swords = _make_sorted(rng, n, w, nkeys, tv)
    svalid = np.arange(n) < tv
    ref_w, ref_e = jax.jit(jsort.run_length_counts)(
        jnp.asarray(swords), jnp.asarray(svalid))
    np.testing.assert_array_equal(_port(swords, tv), np.asarray(ref_w))
    got_w, got_e = sortops.run_length_counts(words_t(swords),
                                             torch.from_numpy(svalid))
    assert got_w.dtype == torch.int32
    np.testing.assert_array_equal(got_w.numpy(), np.asarray(ref_w))
    np.testing.assert_array_equal(got_e.numpy(), np.asarray(ref_e))


@pytest.mark.parametrize("n,w,nkeys,tvfrac",
                         [s for s in SHAPES if s[0] <= PALLAS_BLOCK])
def test_matches_pallas_interpret(n, w, nkeys, tvfrac):
    """One Pallas grid block or less: the interpreted kernel stays fast."""
    rng = np.random.default_rng(n + w)
    tv = int(n * tvfrac)
    swords = _make_sorted(rng, n, w, nkeys, tv)
    got = run_length_weights_pallas(jnp.asarray(swords), jnp.int32(tv),
                                    interpret=True)
    np.testing.assert_array_equal(_port(swords, tv), np.asarray(got))


def test_run_spanning_pallas_block_boundary():
    """A run crossing the Pallas kernel's block boundary (its SMEM carry
    path) has one weight with the full length in both packages."""
    n = 1 << 19
    swords = np.zeros((n, 2), np.uint32)
    swords[:PALLAS_BLOCK + 100] = 7
    swords[PALLAS_BLOCK + 100:] = 9
    got = _port(swords, n)
    assert list(np.flatnonzero(got)) == [PALLAS_BLOCK + 99, n - 1]
    assert got[PALLAS_BLOCK + 99] == PALLAS_BLOCK + 100
    ref_w, _ = jax.jit(jsort.run_length_counts)(
        jnp.asarray(swords), jnp.ones(n, bool))
    np.testing.assert_array_equal(got, np.asarray(ref_w))


def test_run_over_many_tiles_with_invalid_tail():
    """One run covering many of the CUDA kernel's 2048-row tiles, then short
    runs, tv < n with the first invalid row equal to the last valid one:
    the same weights as the Pallas kernel in interpret mode."""
    n, tv = 1 << 16, 61_000
    swords = np.zeros((n, 2), np.uint32)
    swords[:100] = 3
    swords[100:60_000] = 4                       # ~29 tiles of one run
    swords[60_000:, 1] = 5 + (np.arange(n - 60_000) // 7)
    swords[tv] = swords[tv - 1]
    got = _port(swords, tv)
    ref = run_length_weights_pallas(jnp.asarray(swords), jnp.int32(tv),
                                    interpret=True)
    np.testing.assert_array_equal(got, np.asarray(ref))
    assert got[59_999] == 59_900 and got.sum() == tv


def test_first_invalid_row_equal_to_last_valid():
    """Weights sum to total_valid even when the first invalid row
    bit-equals the last valid row (the j == tv-1 end)."""
    n, tv = 1 << 12, 1000
    swords = np.full((n, 2), 5, np.uint32)
    got = _port(swords, tv)
    ref = run_length_weights_pallas(jnp.asarray(swords), jnp.int32(tv),
                                    interpret=True)
    np.testing.assert_array_equal(got, np.asarray(ref))
    assert got.sum() == tv and got[tv - 1] == tv


def test_empty_input():
    got = kernels.run_length_weights(torch.zeros((2, 0), dtype=torch.int32),
                                     torch.tensor(0, dtype=torch.int32))
    assert got.shape == (0,) and got.dtype == torch.int32
