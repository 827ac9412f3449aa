"""The port's owner exchange (``parallel/distribute.py``) and sample sort
against the JAX package's, which run here as shard_map programs on the
conftest's 8-device CPU mesh.  The port holds the same p shards stacked on
one device.  Integer outputs: exact equality of the received buckets, the
returned replies and the overflow counts."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from jax.sharding import PartitionSpec as P

from kmerind_tpu.parallel import distribute as jdist
from kmerind_tpu.parallel.mesh import SHARD_AXIS, make_mesh
from kmerind_tpu.parallel.sample_sort import make_sample_sort_step
from kmerind_tpu_torch.parallel import distribute as dist
from kmerind_tpu_torch.parallel.sample_sort import sample_sort

from torch_parity import words_np, words_t


def _jax_exchange(vals, owners, valid, p, cap):
    """JAX distribute -> reply (value + 1 where live) -> undistribute."""

    def body(v, o, va):
        (rv,), rvalid, route = jdist.distribute(
            (v[0],), o[0], va[0], p, cap, SHARD_AXIS)
        reply = jnp.where(rvalid, rv + 1, 0)
        (back,) = jdist.undistribute((reply,), route, p, cap, SHARD_AXIS)
        return rv[None], rvalid[None], back[None], route.overflow[None]

    f = jax.jit(jax.shard_map(
        body, mesh=make_mesh(p), in_specs=(P(SHARD_AXIS),) * 3,
        out_specs=(P(SHARD_AXIS),) * 4))
    return [np.asarray(x) for x in f(jnp.asarray(vals), jnp.asarray(owners),
                                     jnp.asarray(valid))]


def _port_exchange(vals, owners, valid, p, cap, fill=0):
    (rv,), rvalid, route = dist.distribute(
        (words_t(vals),), torch.from_numpy(owners), torch.from_numpy(valid),
        p, cap)
    reply = torch.where(rvalid, rv + 1, 0)
    (back,) = dist.undistribute((reply,), route, p, cap, fill=fill)
    return words_np(rv), rvalid.numpy(), words_np(back), route.overflow


@pytest.mark.parametrize("p,n,cap", [(1, 64, 64), (2, 64, 64), (8, 64, 16),
                                     (8, 100, 8)])
def test_distribute_roundtrip_matches_jax(p, n, cap):
    """Same received buckets (layout included), same replies back, same
    overflow; (8, 100, 8) overflows and drops rows in both packages."""
    rng = np.random.default_rng(p * 1000 + n + cap)
    vals = rng.integers(0, 1 << 30, size=(p, n)).astype(np.uint32)
    owners = rng.integers(0, p, size=(p, n)).astype(np.int32)
    valid = rng.random((p, n)) < 0.9
    j_rv, j_rvalid, j_back, j_ovf = _jax_exchange(vals, owners, valid, p, cap)
    rv, rvalid, back, ovf = _port_exchange(vals, owners, valid, p, cap)
    np.testing.assert_array_equal(rvalid, j_rvalid)
    np.testing.assert_array_equal(np.where(rvalid, rv, 0),
                                  np.where(j_rvalid, j_rv, 0))
    np.testing.assert_array_equal(back, j_back)
    assert ovf == int(j_ovf.max())
    if ovf == 0:
        np.testing.assert_array_equal(back[valid], vals[valid] + 1)


@pytest.mark.parametrize("p", [2, 4, 8])
def test_overflow_count_matches_jax(p):
    """Everything to owner 0: the bucket excess is n - cap in both."""
    n, cap = 32, 4
    vals = np.arange(p * n, dtype=np.uint32).reshape(p, n)
    owners = np.zeros((p, n), np.int32)
    valid = np.ones((p, n), bool)
    *_, j_ovf = _jax_exchange(vals, owners, valid, p, cap)
    *_, ovf = _port_exchange(vals, owners, valid, p, cap)
    assert ovf == int(j_ovf.max()) == n - cap


@pytest.mark.parametrize("p", [1, 4])
def test_undistribute_fills_invalid_routes(p):
    """Elements that took no part in the exchange (invalid, or dropped by
    a full bucket) get `fill` back — at one shard too."""
    n, cap = 40, 16 if p > 1 else None
    rng = np.random.default_rng(p)
    vals = rng.integers(0, 1 << 30, size=(p, n)).astype(np.uint32)
    owners = rng.integers(0, p, size=(p, n)).astype(np.int32)
    valid = rng.random((p, n)) < 0.6
    _, _, back, ovf = _port_exchange(vals, owners, valid, p, cap, fill=-7)
    assert ovf == 0
    np.testing.assert_array_equal(back.view(np.int32)[~valid], -7)
    np.testing.assert_array_equal(back[valid], vals[valid] + 1)


@pytest.mark.parametrize("p", [2, 4])
def test_bucket_by_owner_matches_jax(p):
    rng = np.random.default_rng(p + 17)
    n, cap = 200, 40
    owners = rng.integers(0, p, n).astype(np.int32)
    valid = rng.random(n) < 0.8
    j_slot, j_counts, j_ovf = jax.jit(
        jdist.bucket_by_owner, static_argnums=(2, 3))(
        jnp.asarray(owners), jnp.asarray(valid), p, cap)
    slot, counts, ovf = dist.bucket_by_owner(
        torch.from_numpy(owners), torch.from_numpy(valid), p, cap)
    np.testing.assert_array_equal(slot.numpy()[valid],
                                  np.asarray(j_slot)[valid])
    np.testing.assert_array_equal(counts.numpy(), np.asarray(j_counts))
    assert int(ovf) == int(j_ovf)


def test_sample_sort_matches_jax():
    """p = 4: the same globally sorted shards, rows and validity, the
    buckets' padding rows included."""
    p, n, w = 4, 256, 2
    rng = np.random.default_rng(p)
    words = rng.integers(0, 1 << 31, size=(p, n, w)).astype(np.uint32)
    valid = rng.random((p, n)) < 0.9
    cap = 2 * n
    j_words, j_valid, j_ovf = map(np.asarray, make_sample_sort_step(
        make_mesh(p), p, cap)(jnp.asarray(words), jnp.asarray(valid)))
    s_words, s_valid, ovf = sample_sort(words_t(words),
                                        torch.from_numpy(valid), cap)
    assert ovf == int(j_ovf.max()) == 0
    np.testing.assert_array_equal(s_valid.numpy(), j_valid)
    np.testing.assert_array_equal(words_np(s_words), j_words)
    flat = words_np(s_words)[s_valid.numpy()]
    ints = (flat[:, 0].astype(np.uint64) << np.uint64(32)) | flat[:, 1]
    assert (np.diff(ints.astype(np.int64)) >= 0).all()
    assert flat.shape[0] == valid.sum()
