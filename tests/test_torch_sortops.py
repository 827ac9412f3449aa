"""Port sort / merge / search (kmerind_tpu_torch.ops.sortops and K2's plain
version, the kernel wrapper's CPU path) against the JAX package.

Integer outputs: exact equality.  Merges that carry payloads are compared
as per-key multisets, because the JAX bitonic merge leaves equal keys in no
set order; their keys must match exactly."""

import collections

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from kmerind_tpu.ops import pallas_kernels as pk
from kmerind_tpu.ops import sortops as jsort
from kmerind_tpu_torch.ops import kernels, sortops

from torch_parity import sorted_key_cols, words_np, words_t


@pytest.mark.parametrize("w", [1, 2, 3])
@pytest.mark.parametrize("sentinel_ok", [True, False])
def test_sort_rows_matches_jax(w, sentinel_ok):
    rng = np.random.default_rng(w * 7 + sentinel_ok)
    n = 3001
    words = rng.integers(0, 2**32, (n, w), dtype=np.uint32)
    words[:, 0] = rng.integers(0, 5, n)      # ties on word 0
    words[::97] = 0xFFFFFFFF                  # real all-ones rows
    if sentinel_ok:
        words[:, 0] &= 0x7FFFFFFF             # sentinel-safe keys
    valid = rng.random(n) > 0.2
    pay = rng.integers(-5, 5, n).astype(np.int32)
    jw, (jp,), jv = jsort.sort_rows(
        jnp.asarray(words), (jnp.asarray(pay),), jnp.asarray(valid),
        is_stable=True, sentinel_ok=sentinel_ok)
    tw, (tp,), tv = sortops.sort_rows(
        words_t(words), (torch.from_numpy(pay),), torch.from_numpy(valid),
        is_stable=True, sentinel_ok=sentinel_ok)
    np.testing.assert_array_equal(words_np(tw), np.asarray(jw))
    np.testing.assert_array_equal(tp.numpy(), np.asarray(jp))
    np.testing.assert_array_equal(tv.numpy(), np.asarray(jv))
    tc, _, _ = sortops.sort_rows(words_t(words), (), torch.from_numpy(valid),
                                 sentinel_ok=sentinel_ok, as_cols=True)
    np.testing.assert_array_equal(words_np(tc), np.asarray(jw).T)


def _runs(rng, w, na, nb, npay, sent_a=0, sent_b=0):
    a = sorted_key_cols(rng, w, na, n_sentinel=sent_a)
    b = sorted_key_cols(rng, w, nb, n_sentinel=sent_b)
    pa = [rng.integers(1, 100, na).astype(np.int32) for _ in range(npay)]
    pb = [rng.integers(1, 100, nb).astype(np.int32) for _ in range(npay)]
    for p in pa:
        p[na - sent_a:] = 0
    for p in pb:
        p[nb - sent_b:] = 0
    return a, pa, b, pb


def _port_merge(a, pa, b, pb):
    keys, pays = kernels.merge_runs_cols(
        words_t(a), tuple(torch.from_numpy(p) for p in pa),
        words_t(b), tuple(torch.from_numpy(p) for p in pb))
    skeys, spays = sortops.merge_sorted_runs_cols(
        words_t(a), tuple(torch.from_numpy(p) for p in pa),
        words_t(b), tuple(torch.from_numpy(p) for p in pb))
    assert torch.equal(keys, skeys)
    assert all(torch.equal(x, y) for x, y in zip(pays, spays))
    return words_np(keys), [p.numpy() for p in pays]


def _assert_merge_equal(got_k, got_p, want_k, want_p):
    np.testing.assert_array_equal(got_k, want_k)
    rows = lambda k, ps: collections.Counter(  # noqa: E731
        zip(*(k[j].tolist() for j in range(k.shape[0])),
            *(p.tolist() for p in ps)))
    assert rows(got_k, got_p) == rows(want_k, want_p)


def _expected_merge(a, pa, b, pb):
    """numpy oracle: sorted multiset union, sentinel rows with payload 0
    padding to next_pow2(na + nb)."""
    w, na = a.shape
    nb = b.shape[1]
    n = 1 << max(1, (na + nb - 1).bit_length())
    pad = n - na - nb
    k = np.concatenate([a, b, np.full((w, pad), 0xFFFFFFFF, np.uint32)], 1)
    ps = [np.concatenate([x, y, np.zeros(pad, np.int32)])
          for x, y in zip(pa, pb)]
    order = np.lexsort(k[::-1])
    return k[:, order], [p[order] for p in ps]


@pytest.mark.parametrize("w,npay,na,nb", [
    (1, 0, 1000, 999), (1, 3, 37, 1200), (2, 0, 8212, 8212),
    (2, 1, 3000, 1), (2, 2, 0, 513), (3, 3, 2047, 2049), (3, 1, 600, 100),
    (6, 4, 700, 333), (9, 6, 1000, 1048), (33, 4, 300, 212), (33, 6, 5, 600),
])
def test_merge_matches_jax_xla(w, npay, na, nb):
    """Any lengths (not powers of two), nb < na and nb > na, empty runs,
    sentinel tails, key widths past the 9 words K2's kernel keeps in
    registers, 4 and 6 payloads: the port equals the JAX merge (XLA
    bitonic path) and the numpy oracle."""
    rng = np.random.default_rng(w * 1000 + npay * 10 + na % 7)
    a, pa, b, pb = _runs(rng, w, na, nb, npay, sent_a=min(na, 5),
                         sent_b=min(nb, 3))
    got_k, got_p = _port_merge(a, pa, b, pb)
    jk, jp = jsort.merge_sorted_runs_cols(
        jnp.asarray(a), tuple(jnp.asarray(p) for p in pa),
        jnp.asarray(b), tuple(jnp.asarray(p) for p in pb))
    _assert_merge_equal(got_k, got_p, np.asarray(jk),
                        [np.asarray(p) for p in jp])
    want_k, want_p = _expected_merge(a, pa, b, pb)
    _assert_merge_equal(got_k, got_p, want_k, want_p)


@pytest.mark.parametrize("w,npay,nblocks,nbb", [
    (1, 0, 4, 2), (2, 1, 8, 4), (3, 3, 16, 1),
])
def test_merge_matches_pallas_two_operand(monkeypatch, w, npay, nblocks,
                                          nbb):
    """Against the Pallas two-operand bitonic merge in interpret mode, with
    its block shrunk as tests/test_runlength_pallas.py does."""
    small = 1 << 10
    monkeypatch.setattr(pk, "_MG_BLOCK", small)
    monkeypatch.setattr(pk, "_mg_block_for", lambda ncols: small)
    na, nb = (nblocks // 2) * small, nbb * small
    rng = np.random.default_rng(nblocks * 31 + nbb + w)
    a, pa, b, pb = _runs(rng, w, na, nb, npay)
    jk, jp = pk._bitonic_merge_pallas_cols_2op(
        jnp.asarray(a), tuple(jnp.asarray(p) for p in pa),
        jnp.asarray(b), tuple(jnp.asarray(p) for p in pb), True)
    got_k, got_p = _port_merge(a, pa, b, pb)
    _assert_merge_equal(got_k, got_p, np.asarray(jk),
                        [np.asarray(p) for p in jp])


@pytest.mark.parametrize("tbits", [8, 16, 20])
def test_prefix_starts_and_prebuilt_lower_bound(tbits):
    """Bucket table equals the JAX one; the seeded lower_bound equals the
    JAX full binary search (lower_bound_cols) for any table width — the
    JAX prebuilt search hard-codes tbits=16."""
    rng = np.random.default_rng(tbits)
    keys = sorted_key_cols(rng, 2, 5000, hi_values=2**32, n_sentinel=100)
    keys[0, 1000:1300] = keys[0, 1000]       # one crowded bucket
    keys[1, 1000:1300].sort()
    queries = np.concatenate([
        keys[:, rng.integers(0, 5000, 300)].T,
        rng.integers(0, 2**32, (300, 2), dtype=np.uint32)])
    jstarts = jsort._prefix_starts(jnp.asarray(keys[0]), tbits)
    tstarts = sortops._prefix_starts(words_t(keys[0]), tbits)
    np.testing.assert_array_equal(tstarts.numpy(), np.asarray(jstarts))
    want = jsort.lower_bound_cols(jnp.asarray(keys), 5000,
                                  jnp.asarray(queries))
    got = sortops.lower_bound_cols_prebuilt(words_t(keys), 2, tstarts,
                                            words_t(queries))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    if tbits == 16:
        jp = jsort.lower_bound_cols_prebuilt(jnp.asarray(keys), 2, jstarts,
                                             jnp.asarray(queries))
        np.testing.assert_array_equal(got.numpy(), np.asarray(jp))


@pytest.mark.parametrize("w,npay,na,nb", [
    (1, 0, 1000, 999), (2, 1, 3000, 1), (2, 2, 0, 513), (3, 3, 2047, 2049),
    (8, 1, 1500, 2500)])
def test_merge_sorted_runs_row_major_matches_jax(w, npay, na, nb):
    """K2′'s plain version (sortops.merge_sorted_runs on CPU tensors)
    against the JAX row-major merge, per key multiset."""
    rng = np.random.default_rng(w * 100 + npay + nb % 11)
    a, pa, b, pb = _runs(rng, w, na, nb, npay, sent_b=min(nb, 3))
    keys, pays = sortops.merge_sorted_runs(
        words_t(a.T), tuple(torch.from_numpy(p) for p in pa),
        words_t(b.T), tuple(torch.from_numpy(p) for p in pb))
    jk, jp = jsort.merge_sorted_runs(
        jnp.asarray(a.T), tuple(jnp.asarray(p) for p in pa),
        jnp.asarray(b.T), tuple(jnp.asarray(p) for p in pb))
    _assert_merge_equal(words_np(keys).T, [p.numpy() for p in pays],
                        np.asarray(jk).T, [np.asarray(p) for p in jp])


def _sorted_rows(rng, n, w, nkeys, tv, sentinel_tail=True):
    keys = rng.integers(0, 2**32, (nkeys, w), dtype=np.uint32)
    rows = keys[rng.integers(0, nkeys, n)]
    rows[:tv] = rows[:tv][np.lexsort(rows[:tv].T[::-1])]
    if sentinel_tail:
        rows[tv:] = 0xFFFFFFFF
    return rows, np.arange(n) < tv


@pytest.mark.parametrize("n,w,nkeys,tv", [
    (1, 1, 1, 1), (3000, 2, 40, 2500), (3000, 3, 900, 3000), (500, 2, 5, 0)])
def test_segment_reduce_matches_jax(n, w, nkeys, tv):
    """Sums, minima and maxima over key runs (1-d and [n, d] values, the
    extremes of signed values), the stable compaction and the run totals
    equal the JAX package's."""
    rng = np.random.default_rng(n + w + tv)
    rows, valid = _sorted_rows(rng, n, w, nkeys, tv)
    vals = rng.integers(0, 2**20, (n, 2)).astype(np.int32)
    for v in (vals[:, 0], vals):
        ju, jr, jn = jsort.segment_reduce_sorted(
            jnp.asarray(rows), jnp.asarray(valid), jnp.asarray(v))
        tu, tr, tn = sortops.segment_reduce_sorted(
            words_t(rows), torch.from_numpy(valid), torch.from_numpy(v))
        np.testing.assert_array_equal(words_np(tu), np.asarray(ju))
        np.testing.assert_array_equal(tr.numpy(), np.asarray(jr))
        assert int(tn) == int(jn)
    ju, (jp,), js, jn, jt = jsort.compact_runs(
        jnp.asarray(rows), jnp.asarray(valid), (jnp.asarray(vals[:, 1]),))
    tu, (tp,), ts, tn, tt = sortops.compact_runs(
        words_t(rows), torch.from_numpy(valid),
        (torch.from_numpy(vals[:, 1]),))
    np.testing.assert_array_equal(words_np(tu), np.asarray(ju))
    np.testing.assert_array_equal(tp.numpy(), np.asarray(jp))
    np.testing.assert_array_equal(ts.numpy(), np.asarray(js))
    assert (int(tn), int(tt)) == (int(jn), int(jt))
    np.testing.assert_array_equal(
        sortops.run_weight_totals(words_t(rows), torch.from_numpy(valid),
                                  torch.from_numpy(vals[:, 0])).numpy(),
        np.asarray(jsort.run_weight_totals(
            jnp.asarray(rows), jnp.asarray(valid), jnp.asarray(vals[:, 0]))))
    signed = vals - (1 << 19)
    for reduce in ("min", "max"):
        for v in (signed[:, 0], signed):
            ju, jr, jn = jsort.segment_reduce_sorted(
                jnp.asarray(rows), jnp.asarray(valid), jnp.asarray(v), reduce)
            tu, tr, tn = sortops.segment_reduce_sorted(
                words_t(rows), torch.from_numpy(valid), torch.from_numpy(v),
                reduce)
            np.testing.assert_array_equal(words_np(tu), np.asarray(ju))
            np.testing.assert_array_equal(tr.numpy(), np.asarray(jr))
            assert int(tn) == int(jn)


def test_run_weight_totals_wrap_like_int32():
    rows = np.zeros((3, 1), np.uint32)
    vals = np.full(3, 2**30 + 7, np.int32)
    got = sortops.run_weight_totals(words_t(rows), torch.ones(3, dtype=bool),
                                    torch.from_numpy(vals))
    want = jsort.run_weight_totals(jnp.asarray(rows), jnp.ones(3, bool),
                                   jnp.asarray(vals))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


@pytest.mark.parametrize("size", [0, 1, 2999, 3000])
def test_lower_bound_bucketed_matches_jax(size):
    rng = np.random.default_rng(size)
    rows, _ = _sorted_rows(rng, 4000, 2, 3500, size)
    rows[:size, 0] >>= 8                    # crowded word-0 buckets
    rows[:size] = rows[:size][np.lexsort(rows[:size].T[::-1])]
    queries = np.concatenate([
        rows[rng.integers(0, max(size, 1), 300)],
        rng.integers(0, 2**32, (300, 2), dtype=np.uint32)])
    want = jsort.lower_bound_bucketed(jnp.asarray(rows), size,
                                      jnp.asarray(queries))
    got = sortops.lower_bound_bucketed(words_t(rows), size, words_t(queries))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    np.testing.assert_array_equal(
        sortops.rows_equal_at(words_t(rows), got, words_t(queries),
                              size).numpy(),
        np.asarray(jsort.rows_equal_at(jnp.asarray(rows), want,
                                       jnp.asarray(queries), size)))
