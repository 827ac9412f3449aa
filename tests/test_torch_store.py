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


def _count_store(rng, cap=5000, size=3700):
    keys = np.unique(rng.integers(0, 2**32, (2 * size, 2), dtype=np.uint32),
                     axis=0)[:size]
    full = np.full((cap, 2), 0xFFFFFFFF, np.uint32)
    full[:size] = keys
    counts = np.zeros(cap, np.int32)
    counts[:size] = rng.integers(1, 1000, size)
    return full, counts, size


def test_count_store_lookup_and_erase_match_jax():
    """CountStore (the sorted index's shard): lookups, then an erase of
    present, absent, duplicated and invalid query rows."""
    rng = np.random.default_rng(4)
    keys, counts, size = _count_store(rng)
    j = jst.CountStore(jnp.asarray(keys), jnp.asarray(counts),
                       jnp.asarray(size, jnp.int32))
    t = tst.CountStore(words_t(keys), torch.from_numpy(counts),
                       torch.tensor(size, dtype=torch.int32))
    q = np.concatenate([keys[rng.integers(0, size, 400)],
                        rng.integers(0, 2**32, (100, 2), dtype=np.uint32),
                        keys[size:size + 5]])
    np.testing.assert_array_equal(
        tst.count_lookup(t, words_t(q)).numpy(),
        np.asarray(jst.count_lookup(j, jnp.asarray(q))))
    qvalid = rng.random(q.shape[0]) < 0.8
    jn, jcount = jst.count_erase(j, jnp.asarray(q), jnp.asarray(qvalid))
    tn, tcount = tst.count_erase(t, words_t(q), torch.from_numpy(qvalid))
    assert int(tcount) == int(jcount) > 0
    np.testing.assert_array_equal(words_np(tn.keys), np.asarray(jn.keys))
    np.testing.assert_array_equal(tn.counts.numpy(), np.asarray(jn.counts))
    assert int(tn.size) == int(jn.size)


def _lookup_runs(nruns):
    """(JAX stores, port aux tables, their key columns) of `nruns` runs of
    the `_stores` fixture shapes (long runs of equal keys, dead rows,
    sentinel tails), then query rows: keys of every run, absent keys, the
    sentinel key."""
    js, exts, bstarts, keys = [], [], [], []
    for r in range(nruns):
        k, j, t = _stores(10 + r, cap=6000 - 700 * r, n_sentinel=50 * r + 1)
        ext, bstart = tst.run_query_aux(t)
        js.append(j)
        exts.append(ext)
        bstarts.append(bstart)
        keys.append(k)
    rng = np.random.default_rng(nruns)
    q = np.concatenate([k[:, rng.integers(0, k.shape[1], 300)].T
                        for k in keys]
                       + [rng.integers(0, 3000, (200, 2)).astype(np.uint32),
                          np.full((3, 2), 0xFFFFFFFF, np.uint32)])
    return js, exts, bstarts, q


@pytest.mark.parametrize("nruns", [1, 3])
@pytest.mark.parametrize("saturate", [None, 4])
def test_run_count_lookup_plain_is_the_per_run_sum(nruns, saturate):
    """The plain count lookup over several runs equals the old per-run sum
    of `run_lookup_aux` (clamped, masked) and the JAX runs' lookups summed;
    on CPU tensors the wrapper is the plain version."""
    js, exts, bstarts, q = _lookup_runs(nruns)
    rng = np.random.default_rng(7)
    valid = torch.from_numpy(rng.random(q.shape[0]) < 0.9)
    qt = words_t(q)
    got = kernels.run_count_lookup_plain(exts, bstarts, qt, valid, saturate)
    old = sum(tst.run_lookup_aux(e, b, qt) for e, b in zip(exts, bstarts))
    if saturate is not None:
        old = old.clamp(max=saturate)
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(),
                                  torch.where(valid, old, 0).numpy())
    want = sum(np.asarray(jst.run_lookup(j, q)) for j in js)
    if saturate is not None:
        want = np.minimum(want, saturate)
    np.testing.assert_array_equal(got.numpy(),
                                  np.where(valid.numpy(), want, 0))
    assert (got > 0).sum() > 100 and (got == 0).sum() > 100
    launches = dict(kernels.LAUNCHES)
    np.testing.assert_array_equal(
        kernels.run_count_lookup(exts, bstarts, qt, valid, saturate).numpy(),
        got.numpy())
    assert kernels.LAUNCHES == launches


def test_run_count_lookup_on_cpu_takes_no_kernel(monkeypatch):
    """CPU tensors never reach the kernel library; no runs and no rows give
    zeros."""
    def no_lib():
        raise AssertionError("the kernel library was loaded for CPU tensors")
    monkeypatch.setattr(kernels, "_cuda_lib", no_lib)
    _, exts, bstarts, q = _lookup_runs(2)
    qt = words_t(q)
    valid = torch.ones(q.shape[0], dtype=torch.bool)
    assert kernels.run_count_lookup(exts, bstarts, qt, valid).shape == \
        (q.shape[0],)
    assert torch.equal(kernels.run_count_lookup([], [], qt, valid),
                       torch.zeros(q.shape[0], dtype=torch.int32))
    empty = kernels.run_count_lookup(exts, bstarts, qt[:0], valid[:0], 3)
    assert empty.shape == (0,) and empty.dtype == torch.int32


def test_run_count_lookup_rejects_bad_input():
    _, exts, bstarts, q = _lookup_runs(1)
    qt = words_t(q)
    valid = torch.ones(q.shape[0], dtype=torch.bool)
    lookup = kernels.run_count_lookup
    with pytest.raises(TypeError):                  # int64 queries
        lookup(exts, bstarts, qt.to(torch.int64), valid)
    with pytest.raises(TypeError):                  # uint8 valid
        lookup(exts, bstarts, qt, valid.to(torch.uint8))
    with pytest.raises(TypeError):                  # int64 bucket table
        lookup(exts, [bstarts[0].to(torch.int64)], qt, valid)
    with pytest.raises(ValueError):                 # a query of 3 words
        lookup(exts, bstarts, torch.zeros((4, 3), dtype=torch.int32),
               valid[:4])
    with pytest.raises(ValueError):                 # valid of another length
        lookup(exts, bstarts, qt, valid[:-1])
    with pytest.raises(ValueError):                 # flat queries
        lookup(exts, bstarts, qt[:, 0], valid)
    with pytest.raises(ValueError):                 # 2^16 bucket entries
        lookup(exts, [bstarts[0][:-1]], qt, valid)
    with pytest.raises(ValueError):                 # a table short of a run
        lookup(exts, [], qt, valid)
    with pytest.raises(ValueError):                 # a table on another device
        lookup(exts, [bstarts[0].to("meta")], qt, valid)
    with pytest.raises(ValueError):                 # neither CPU nor CUDA
        lookup([e.to("meta") for e in exts],
               [b.to("meta") for b in bstarts], qt.to("meta"),
               valid.to("meta"))


def test_run_vec_lookup_plain_sums_the_runs_in_order():
    """The node lookup's plain version (the CPU path) adds each run's
    counter differences wrapping as int32 and its float64 quality
    differences in run order from 0.0, bit for bit: on tables whose prefix
    differences round (any int32 counters, float64 prefix sums of values
    of both signs), where another order would give other bits."""
    rng = np.random.default_rng(5)
    tables, keys = [], []
    for r in range(4):
        k, _, t = _stores(20 + r, cap=3000 - 500 * r, n_sentinel=40 * r + 1)
        ext, bstart = tst._runlen_aux(t.keys)
        cap = ext.shape[1]
        bsum = torch.from_numpy(rng.integers(-2**31, 2**31, (9, cap))
                                .astype(np.int32))
        qcsum = torch.from_numpy(np.cumsum(rng.normal(size=cap) * 1e3))
        tables.append((ext, bstart, bsum, qcsum))
        keys.append(k)
    q = words_t(np.concatenate(
        [k[:, rng.integers(0, k.shape[1], 400)].T for k in keys]
        + [rng.integers(0, 3000, (100, 2)).astype(np.uint32)]))
    valid = torch.from_numpy(rng.random(q.shape[0]) < 0.9)
    counts, qsum = kernels.run_vec_lookup(tables, q, valid, 7)
    parts = [tst.run_vec_lookup_aux(*t, q) for t in tables]
    want_c = torch.zeros((q.shape[0], 9), dtype=torch.int32)
    want_q = torch.zeros(q.shape[0], dtype=torch.float64)
    for c, s in parts:
        want_c, want_q = want_c + c, want_q + s
    assert torch.equal(counts, torch.where(valid[:, None],
                                           want_c.clamp(max=7), 0))
    assert torch.equal(qsum.view(torch.int64),
                       torch.where(valid, want_q, 0.0).view(torch.int64))
    backwards = sum((s for _, s in parts[::-1]),
                    torch.zeros(q.shape[0], dtype=torch.float64))
    assert not torch.equal(backwards.view(torch.int64),
                           want_q.view(torch.int64))
