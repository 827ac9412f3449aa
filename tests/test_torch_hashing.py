"""The port's owner hashes against the JAX package's: murmur3 x86_32,
fmix32 (and its "std" alias), identity, mix32, the bit-exact FarmHash64
and its 32-bit fold must give the same digests bit for bit on the same
key words (made from a numpy seed), and the owner maps the same shards."""

import pathlib
import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import kmerind_tpu as kt
import kmerind_tpu_torch as kp
from kmerind_tpu.index.distributed import owners_for as jax_owners_for
from kmerind_tpu.ops import farmhash as jfarm
from kmerind_tpu.ops import hashing as jhash
from kmerind_tpu_torch.index.distributed import owners_for
from kmerind_tpu_torch.ops import farmhash, hashing

from torch_parity import words_t

sys.path.insert(0, str(pathlib.Path(__file__).resolve().parent.parent))

import chip_smoke  # noqa: E402


def _rows(w: int, n: int = 2000, seed: int = 0) -> np.ndarray:
    """uint32[n, w] key words with the all-ones and all-zero rows and
    single high bits among random ones."""
    rng = np.random.default_rng(seed + w)
    a = rng.integers(0, 2**32, (n, w), dtype=np.uint32)
    a[0], a[1] = 0xFFFFFFFF, 0
    a[2:34, 0] = np.uint32(1) << np.arange(32, dtype=np.uint32)
    return a


@pytest.mark.parametrize("w", [1, 2, 3, 4])
@pytest.mark.parametrize("name", ["murmur", "farm", "fmix32", "std",
                                  "identity"])
def test_hashes_digest_equal(name, w):
    a = _rows(w)
    for seed in (42, 7):
        want = np.asarray(jhash.HASHES[name](jnp.asarray(a), seed))
        got = hashing.HASHES[name](words_t(a), seed)
        assert got.dtype == torch.int64
        np.testing.assert_array_equal(got.numpy(), want.astype(np.int64))


@pytest.mark.parametrize("w", [1, 2, 3, 4])
def test_mix32_and_hash64_words(w):
    a = _rows(w, seed=1)
    np.testing.assert_array_equal(hashing.mix32(words_t(a)).numpy(),
                                  np.asarray(jhash.mix32(jnp.asarray(a))))
    hi, lo = farmhash.hash64_words(words_t(a), 11)
    jhi, jlo = jfarm.hash64_words(jnp.asarray(a), 11)
    np.testing.assert_array_equal(hi.numpy(), np.asarray(jhi))
    np.testing.assert_array_equal(lo.numpy(), np.asarray(jlo))
    np.testing.assert_array_equal(farmhash.farm32(words_t(a)).numpy(),
                                  np.asarray(jfarm.farm32(jnp.asarray(a))))


@pytest.mark.parametrize("k,alpha", [(3, "DNA"), (21, "DNA"), (32, "DNA"),
                                     (63, "DNA"), (100, "DNA"),
                                     (31, "DNA16")])
def test_hash64_kmers_reference_stream(k, alpha):
    """The reference's byte stream (the k-mer value, little-endian,
    ceil(nbits / 8) bytes) — every length branch of farmhashna."""
    jspec = kt.KmerSpec(k, getattr(kt, alpha))
    spec = kp.KmerSpec(k, getattr(kp, alpha))
    rng = np.random.default_rng(k)
    codes = rng.integers(0, spec.alphabet.size, (300, k))
    rows = np.stack([jspec.pack_codes(c) for c in codes])
    hi, lo = farmhash.hash64_kmers(words_t(rows), spec, 5)
    jhi, jlo = jfarm.hash64_kmers(jnp.asarray(rows), jspec, 5)
    np.testing.assert_array_equal(hi.numpy(), np.asarray(jhi))
    np.testing.assert_array_equal(lo.numpy(), np.asarray(jlo))


@pytest.mark.parametrize("p", [1, 2, 3, 4, 5, 8])
def test_owner_from_hash(p):
    """Both branches: the top bits for a power of two, the 16 + 16 split
    otherwise; every owner in [0, p)."""
    h = np.concatenate([np.asarray(jhash.murmur3_32(jnp.asarray(_rows(2)))),
                        np.array([0, 0xFFFFFFFF, 0x80000000], np.uint32)])
    want = np.asarray(jhash.owner_from_hash(jnp.asarray(h), p))
    got = hashing.owner_from_hash(torch.from_numpy(h.astype(np.int64)), p)
    np.testing.assert_array_equal(got.numpy(), want)
    assert 0 <= int(got.min()) and int(got.max()) < p


@pytest.mark.parametrize("hash_name", ["murmur", "farm", "fmix32",
                                       "identity"])
@pytest.mark.parametrize("p", [3, 4])
def test_owners_for(hash_name, p):
    a = _rows(2, seed=3)
    want = np.asarray(jax_owners_for(jnp.asarray(a), p, hash_name))
    got = owners_for(words_t(a), p, hash_name)
    np.testing.assert_array_equal(got.numpy(), want)
    assert owners_for(words_t(a), 1, hash_name) is None


def test_smoke_numpy_murmur_is_independent_and_equal():
    """chip_smoke.py's plain numpy MurmurHash3_x86_32 (its P3p owner check)
    gives the port's digests, and the published test vector."""
    a = _rows(2, seed=4)
    np.testing.assert_array_equal(
        chip_smoke.murmur3_x86_32(a).astype(np.int64),
        hashing.murmur3_32(words_t(a)).numpy())
    # MurmurHash3_x86_32 of four zero bytes, seed 0
    assert int(chip_smoke.murmur3_x86_32(np.zeros((1, 1), np.uint32),
                                         seed=0)[0]) == 0x2362F9DE
