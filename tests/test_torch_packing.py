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
    _check_canonical_against_jax(name, k)


# where the K1 wrapper switches kernels (k * bits: 64 | 65..128 | > 128),
# beyond the KS grid above
@pytest.mark.parametrize("name,k", [("DNA", 64), ("DNA", 65), ("DNA16", 33),
                                    ("ASCII", 17)])
def test_extract_canonical_matches_jax_at_state_limits(name, k):
    _check_canonical_against_jax(name, k)


@pytest.mark.parametrize("name,k,want", [
    ("DNA", 1, "rolling64"), ("DNA", 32, "rolling64"),
    ("DNA", 33, "rolling128"), ("DNA", 64, "rolling128"),
    ("DNA", 65, "wide"), ("DNA", 512, "wide"), ("DNA", 1024, "wide"),
    ("DNA6", 21, "rolling64"), ("DNA6", 22, "rolling128"),
    ("DNA6", 42, "rolling128"), ("DNA6", 43, "wide"),
    ("DNA16", 16, "rolling64"), ("DNA16", 17, "rolling128"),
    ("DNA16", 32, "rolling128"), ("DNA16", 33, "wide"),
    ("ASCII", 8, "rolling64"), ("ASCII", 9, "rolling128"),
    ("ASCII", 16, "rolling128"), ("ASCII", 17, "wide")])
def test_k1_kernel_by_width(name, k, want):
    """The K1 wrapper's kernel follows k * bits alone."""
    assert kernels.k1_kernel(TSpec(k, tal.by_name(name))) == want


@pytest.mark.parametrize("name,k", [("DNA", 513), ("DNA", 1024),
                                    ("ASCII", 513)])
def test_extract_canonical_past_the_pallas_kernel_matches_jax(name, k):
    """k > 512, past the Pallas kernel (`pallas_supported`): the port's
    plain version against the JAX package's XLA path, every row."""
    jspec = JSpec(k, jal.by_name(name))
    tspec = TSpec(k, tal.by_name(name))
    codes = _codes(tspec.alphabet, k, n=k + 300)
    t = torch.from_numpy(codes)
    got_w, got_rc = kernels.extract_canonical(t, tspec)  # CPU: plain path
    xla_w, xla_rc = jpacking.extract_canonical(jnp.asarray(codes), jspec)
    np.testing.assert_array_equal(words_np(got_w), np.asarray(xla_w))
    np.testing.assert_array_equal(got_rc.numpy(), np.asarray(xla_rc))


def test_k1_launch_counts_by_kernel():
    """One counter per K1 kernel, in the wrapper's dispatch order; the
    reset clears them with the per-wrapper counts."""
    assert tuple(kernels.K1_LAUNCHES) == ("rolling64", "rolling128", "wide")
    kernels.K1_LAUNCHES["wide"] += 3
    kernels.LAUNCHES["extract_canonical"] += 3
    kernels.reset_launches()
    assert not any(kernels.K1_LAUNCHES.values())
    assert not any(kernels.LAUNCHES.values())


def test_k1_launch_args_built_once():
    """The complement table and launch arguments are built once per spec
    and hold the alphabet's complement (identity past the alphabet)."""
    spec = TSpec(21, tal.by_name("DNA6"))
    args = kernels._k1_launch_args(spec)
    assert kernels._k1_launch_args(TSpec(21, tal.by_name("DNA6"))) is args
    lut, addr, k, bits, cpw, nwords, kernel = args
    assert addr == lut.ctypes.data
    assert (k, bits, cpw, nwords) == (21, 3, 10, 3)
    assert kernel == 0
    np.testing.assert_array_equal(lut[:8], spec.alphabet.to_complement)
    np.testing.assert_array_equal(lut[8:], np.arange(8, 256))


def _check_canonical_against_jax(name, k):
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
