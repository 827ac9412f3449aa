"""Port run store (kmerind_tpu_torch.index.store) and K3's plain version
against the JAX package: the Pallas prefix sum in interpret mode, run
totals, query aux + lookups (tbits 16 and 20), merges and compaction.
Integer outputs: exact equality (merge outputs with weights as per-key
multisets, the JAX bitonic merge leaving ties in no set order)."""

import collections

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from kmerind_tpu.index import store as jst
from kmerind_tpu.ops.pallas_kernels import prefix_sum_pallas
from kmerind_tpu_torch.index import store as tst
from kmerind_tpu_torch.ops import kernels

from torch_parity import sorted_key_cols, words_np, words_t


@pytest.mark.parametrize("hi", [2, 101])
def test_prefix_sum_matches_pallas(hi):
    """~300k int32 values: two Pallas blocks of 2^18."""
    x = np.random.default_rng(hi).integers(0, hi, 300_001).astype(np.int32)
    want = np.asarray(prefix_sum_pallas(jnp.asarray(x), interpret=True))
    got = kernels.prefix_sum_i32(torch.from_numpy(x))  # CPU: plain path
    np.testing.assert_array_equal(got.numpy(), want)
    np.testing.assert_array_equal(
        tst._cumsum_i32(torch.from_numpy(x)).numpy(), want)


def test_prefix_sum_wraps_like_int32():
    x = np.full(5, 2**30, np.int32)
    got = kernels.prefix_sum_i32(torch.from_numpy(x)).numpy()
    np.testing.assert_array_equal(got, np.cumsum(x, dtype=np.int32))


def _stores(seed, w=2, cap=6000, n_sentinel=300, zero_frac=0.2):
    rng = np.random.default_rng(seed)
    keys = sorted_key_cols(rng, w, cap, hi_values=3000, n_sentinel=n_sentinel)
    keys[1:, : cap - n_sentinel] %= 7        # long runs of equal keys
    live = cap - n_sentinel
    order = np.lexsort(keys[::-1, :live])
    keys[:, :live] = keys[:, :live][:, order]
    weights = rng.integers(1, 6, cap).astype(np.int32)
    weights[rng.random(cap) < zero_frac] = 0  # erased-style dead rows
    weights[live:] = 0
    csum = np.concatenate([[0], np.cumsum(weights)]).astype(np.int32)
    j = jst.RunCountStore(keys=jnp.asarray(keys), weights=jnp.asarray(weights),
                          csum=jnp.asarray(csum))
    t = tst.RunCountStore(keys=words_t(keys),
                          weights=torch.from_numpy(weights),
                          csum=torch.from_numpy(csum))
    return keys, j, t


def test_run_totals_and_distinct_match_jax():
    _, j, t = _stores(1)
    for got, want in zip(tst.run_totals(t), jst.run_totals(j)):
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    assert int(tst.run_distinct(t)) == int(jst.run_distinct(j))


@pytest.mark.parametrize("tbits", [16, 20])
def test_query_aux_and_lookup_match_jax(tbits):
    keys, j, t = _stores(2)
    rng = np.random.default_rng(tbits)
    q = np.concatenate([keys[:, rng.integers(0, keys.shape[1], 500)].T,
                        rng.integers(0, 3000, (200, 2)).astype(np.uint32)])
    ext, bstart = tst.run_query_aux(t, tbits)
    jext, jbstart = jst.run_query_aux(j, tbits)
    np.testing.assert_array_equal(words_np(ext), np.asarray(jext))
    np.testing.assert_array_equal(bstart.numpy(), np.asarray(jbstart))
    got = tst.run_lookup_aux(ext, bstart, words_t(q)).numpy()
    # the JAX store-level lookup is the reference at any tbits (its
    # prebuilt-table lookup hard-codes tbits=16)
    np.testing.assert_array_equal(got, np.asarray(jst.run_lookup(j, q)))
    if tbits == 16:
        np.testing.assert_array_equal(
            got, np.asarray(jst.run_lookup_aux(jext, jbstart, q)))
    assert (got > 0).sum() > 100


@pytest.mark.parametrize("new_cap", [8192, 64])
def test_run_compact_matches_jax(new_cap):
    _, j, t = _stores(3)
    got, got_ovf = tst.run_compact(t, new_cap)
    want, want_ovf = jst.run_compact(j, new_cap)
    assert got_ovf == int(want_ovf)
    np.testing.assert_array_equal(words_np(got.keys), np.asarray(want.keys))
    np.testing.assert_array_equal(got.weights.numpy(),
                                  np.asarray(want.weights))
    np.testing.assert_array_equal(got.csum.numpy(), np.asarray(want.csum))


def _by_key(store_keys, weights):
    c = collections.Counter()
    for i, key in enumerate(map(tuple, store_keys.T.tolist())):
        c[key] += int(weights[i])
    return c


def test_run_merge_and_unit_merge_match_jax():
    """Weighted merge (K2 with the weights as payload + K3 rebuild) and the
    keys-only unit merge with closed-form csum."""
    ka, ja, ta = _stores(4, cap=3000, n_sentinel=100)
    kb, jb, tb = _stores(5, cap=1000, n_sentinel=10)
    got = tst.run_merge(ta, tb.keys, tb.weights)
    want = jst.run_merge(ja, jb.keys, jb.weights)
    np.testing.assert_array_equal(words_np(got.keys), np.asarray(want.keys))
    assert _by_key(words_np(got.keys), got.weights.numpy()) == \
        _by_key(np.asarray(want.keys), np.asarray(want.weights))
    assert int(got.csum[-1]) == int(want.csum[-1])
    np.testing.assert_array_equal(
        got.csum.numpy(),
        np.concatenate([[0], np.cumsum(got.weights.numpy())]))

    def unit(keys0_live, keys, mod):
        return mod.run_from_sorted_unit(keys, keys0_live)

    sent = jnp.uint32(0xFFFFFFFF)
    ua = unit((ta.keys[0] != -1).to(torch.int32), ta.keys, tst)
    ub = unit((tb.keys[0] != -1).to(torch.int32), tb.keys, tst)
    jua = unit((ja.keys[0] != sent).astype(jnp.int32), ja.keys, jst)
    jub = unit((jb.keys[0] != sent).astype(jnp.int32), jb.keys, jst)
    for g, w in ((ua, jua), (tst.run_merge_unit(ua, ub),
                             jst.run_merge_unit(jua, jub))):
        np.testing.assert_array_equal(words_np(g.keys), np.asarray(w.keys))
        np.testing.assert_array_equal(g.weights.numpy(),
                                      np.asarray(w.weights))
        np.testing.assert_array_equal(g.csum.numpy(), np.asarray(w.csum))
