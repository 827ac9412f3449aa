"""K1's plain version (kmerind_tpu_torch.ops.packing.extract_canonical, and
the kernel wrapper's CPU path) against the JAX package: the Pallas kernel
extract_canonical_pallas in interpret mode (valid window prefix, as
tests/test_packing.py compares it) and the XLA path packing.extract_canonical
(every row — the port mirrors its zero-fill tail exactly).  Integer outputs:
exact equality."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

import kmerind_tpu.alphabets as jal
import kmerind_tpu_torch.alphabets as tal
from kmerind_tpu import KmerSpec as JSpec
from kmerind_tpu.ops import packing as jpacking
from kmerind_tpu.ops.pallas_kernels import extract_canonical_pallas
from kmerind_tpu_torch import KmerSpec as TSpec
from kmerind_tpu_torch.ops import bitops, kernels, packing

from torch_parity import words_np, words_t

ALPHABETS = ["DNA", "RNA", "DNA5", "DNA6", "RNA6", "DNA16", "DNA_IUPAC",
             "ASCII"]
KS = [5, 15, 16, 21, 31, 32, 63]


def _codes(alpha, k, n=1500):
    rng = np.random.default_rng(k * 131 + alpha.size)
    return rng.integers(0, alpha.size, n).astype(np.uint8)


@pytest.mark.parametrize("k", KS)
@pytest.mark.parametrize("name", ALPHABETS)
def test_extract_canonical_matches_jax(name, k):
    jspec = JSpec(k, jal.by_name(name))
    tspec = TSpec(k, tal.by_name(name))
    codes = _codes(tspec.alphabet, k)
    t = torch.from_numpy(codes)
    got_w, got_rc = kernels.extract_canonical(t, tspec)  # CPU: plain path
    plain_w, plain_rc = packing.extract_canonical(t, tspec)
    assert torch.equal(got_w, plain_w) and torch.equal(got_rc, plain_rc)
    got_w, got_rc = words_np(got_w), got_rc.numpy()

    xla_w, xla_rc = jpacking.extract_canonical(jnp.asarray(codes), jspec)
    np.testing.assert_array_equal(got_w, np.asarray(xla_w))
    np.testing.assert_array_equal(got_rc, np.asarray(xla_rc))

    pl_w, pl_rc = extract_canonical_pallas(jnp.asarray(codes), jspec,
                                           interpret=True)
    nv = codes.shape[0] - k + 1
    np.testing.assert_array_equal(got_w[:nv], np.asarray(pl_w)[:nv])
    np.testing.assert_array_equal(got_rc[:nv], np.asarray(pl_rc)[:nv])


@pytest.mark.parametrize("name,k", [("DNA", 21), ("DNA6", 11), ("ASCII", 5),
                                    ("DNA16", 31)])
def test_forward_revcomp_and_window_valid_match_jax(name, k):
    """extract_kmers / extract_revcomp / bitops.revcomp / window_valid, the
    pieces of the 'single' transform and of query canonicalisation."""
    jspec = JSpec(k, jal.by_name(name))
    tspec = TSpec(k, tal.by_name(name))
    codes = _codes(tspec.alphabet, k, 700)
    t = torch.from_numpy(codes)
    fwd = packing.extract_kmers(t, tspec)
    np.testing.assert_array_equal(
        words_np(fwd), np.asarray(jpacking.extract_kmers(jnp.asarray(codes),
                                                         jspec)))
    rc = packing.extract_revcomp(t, tspec)
    np.testing.assert_array_equal(
        words_np(rc), np.asarray(jpacking.extract_revcomp(jnp.asarray(codes),
                                                          jspec)))
    nv = codes.shape[0] - k + 1
    np.testing.assert_array_equal(
        words_np(bitops.revcomp(fwd[:nv], tspec)), words_np(rc[:nv]))

    rng = np.random.default_rng(k)
    valid = rng.random(700) > 0.05
    seg = np.cumsum(rng.random(700) < 0.02).astype(np.int32)
    want = jpacking.window_valid(jnp.asarray(valid), jnp.asarray(seg), k)
    got = packing.window_valid(torch.from_numpy(valid), torch.from_numpy(seg),
                               k)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_lex_less_unsigned_order():
    """Words compare as unsigned: 0xFFFFFFFF (int32 -1) is the largest."""
    a = np.array([[1, 2], [1, 2], [1, 2], [0xFFFFFFFF, 0]], np.uint32)
    b = np.array([[1, 3], [1, 2], [0, 9], [1, 0]], np.uint32)
    got = packing.lex_less(words_t(a), words_t(b))
    np.testing.assert_array_equal(
        got.numpy(), np.asarray(jpacking.lex_less(jnp.asarray(a),
                                                  jnp.asarray(b))))
    assert got.tolist() == [True, False, False, False]
