"""The port's quality codec and windowed k-mer quality against the JAX
package's: the decode / encode tables of every preset bit for bit, and
window qualities of random phred bytes (made from a numpy seed, with
"incorrect" bases) at rtol 1e-6, exactly 0 where the JAX package gives
0."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import kmerind_tpu as kt
import kmerind_tpu_torch as kp
from kmerind_tpu import quality as jq
from kmerind_tpu.io.kmer_parsers import DeviceBases as JaxBases
from kmerind_tpu.io.kmer_parsers import extract_tuples as jax_extract
from kmerind_tpu_torch import quality as q
from kmerind_tpu_torch.io.kmer_parsers import DeviceBases, extract_tuples

PRESETS = ["ILLUMINA18", "SANGER", "ILLUMINA13", "ILLUMINA15"]


@pytest.mark.parametrize("preset", PRESETS)
def test_luts_bit_equal(preset):
    got, want = getattr(q, preset), getattr(jq, preset)
    assert got.decode_lut.tobytes() == want.decode_lut.tobytes()
    assert got.encode_lut.tobytes() == want.encode_lut.tobytes()
    assert q.by_name(want.name) is got
    phred = np.arange(got.min_input, got.max_input + 1, dtype=np.uint8)
    np.testing.assert_array_equal(got.encode(got.decode(phred)),
                                  want.encode(want.decode(phred)))


def _phred(n: int, seed: int, lo: int = 33) -> np.ndarray:
    """Phred bytes, mostly high, with '#' / '!' ("incorrect") sprinkled."""
    rng = np.random.default_rng(seed)
    b = (lo + np.minimum(rng.geometric(0.08, n) + 1, 41)).astype(np.uint8)
    b[rng.random(n) < 0.02] = ord("#")
    b[rng.random(n) < 0.005] = lo
    return b


@pytest.mark.parametrize("k", [1, 5, 21, 32, 63])
def test_window_quality(k):
    for codec, lo in ((q.ILLUMINA18, 33), (q.ILLUMINA15, 64)):
        b = _phred(6000, k, lo)
        want = np.asarray(jq.window_quality(
            jnp.asarray(b), k, getattr(jq, codec.name.upper())))
        got = q.window_quality(torch.from_numpy(b), k, codec)
        assert got.dtype == torch.float32
        got = got.numpy()
        np.testing.assert_array_equal(got == 0, want == 0)
        assert (want == 0).any() and (want > 0).any()
        np.testing.assert_allclose(got, want, rtol=1e-6)


@pytest.mark.parametrize("canonical", [True, False])
def test_extract_tuples_with_quality(canonical):
    """Per-window ids ride through extraction and the window quality equals
    the JAX package's on the valid windows."""
    n, k = 3000, 21
    rng = np.random.default_rng(9)
    codes = rng.integers(0, 4, n).astype(np.uint8)
    valid = rng.random(n) > 0.01
    seg = (np.arange(n) // 150).astype(np.int32)
    hi = rng.integers(0, 2**32, n, dtype=np.uint32)
    lo = rng.integers(0, 2**32, n, dtype=np.uint32)
    qual = _phred(n, 4)
    jt = jax_extract(JaxBases(
        jnp.asarray(codes), jnp.asarray(valid), jnp.ones(n, bool),
        jnp.asarray(seg), jnp.asarray(hi), jnp.asarray(lo),
        jnp.asarray(qual)), kt.KmerSpec(k, kt.DNA), canonical=canonical,
        with_quality=True)
    pt = extract_tuples(DeviceBases(
        torch.from_numpy(codes), torch.from_numpy(valid),
        torch.ones(n, dtype=torch.bool), torch.from_numpy(seg),
        torch.from_numpy(hi.view(np.int32)),
        torch.from_numpy(lo.view(np.int32)), torch.from_numpy(qual)), kp.KmerSpec(k, kp.DNA), canonical=canonical,
        with_quality=True)
    v = np.asarray(jt.valid)
    np.testing.assert_array_equal(pt.valid.numpy(), v)
    np.testing.assert_array_equal(pt.words.numpy().view(np.uint32)[v],
                                  np.asarray(jt.words)[v])
    np.testing.assert_array_equal(pt.id_hi.numpy().view(np.uint32), hi)
    np.testing.assert_array_equal(pt.id_lo.numpy().view(np.uint32), lo)
    jq_, pq = np.asarray(jt.qual)[v], pt.qual.numpy()[v]
    np.testing.assert_array_equal(pq == 0, jq_ == 0)
    np.testing.assert_allclose(pq, jq_, rtol=1e-6)
