"""The port's multimap store (kmerind_tpu_torch.index.store, MultiStore)
against the JAX package's on the same stores and batches, made from a
numpy seed: inserts, K2 merge flushes with 2 and 3 payloads (and the
flagged merge, whose keys may equal the all-ones sentinel), range lookups
with and without cached aux metadata, gathers, erase and the distinct-key
count.  A merge leaves ties in no set order, so stores are compared as the
sorted key sequence plus the multiset of (key, id, quality) pairs; lookups
on one store are compared exactly."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from kmerind_tpu.index import store as jst
from kmerind_tpu_torch.index import store as tst

from torch_parity import words_t

SENT = np.uint32(0xFFFFFFFF)


def _rows(rng, n, w, distinct, full_word=False):
    """uint32[n, w] keys drawn from `distinct` values (many repeats); with
    full_word some rows are all-ones (a k = 16 / 32 key equal to the
    sentinel)."""
    pool = rng.integers(0, 2**32 if full_word else 2**31, (distinct, w),
                        dtype=np.uint32)
    if full_word:
        pool[0] = SENT
    return pool[rng.integers(0, distinct, n)]


def _batch(rng, n, w, distinct=300, full_word=False):
    words = _rows(rng, n, w, distinct, full_word)
    hi = rng.integers(0, 2**32, n, dtype=np.uint32)
    lo = rng.integers(0, 2**32, n, dtype=np.uint32)
    q = rng.random(n).astype(np.float32)
    q[rng.random(n) < 0.1] = 0.0
    valid = rng.random(n) > 0.15
    return words, hi, lo, q, valid


def _jax_store(rng, cap, w, n_live, full_word=False, with_q=True):
    """A JAX MultiStore of n_live pairs (built by its own multi_insert)."""
    words, hi, lo, q, _ = _batch(rng, n_live, w, full_word=full_word)
    s, ovf = jst.multi_insert(
        jst.empty_multi_store(cap, w), jnp.asarray(words), jnp.asarray(hi),
        jnp.asarray(lo), jnp.ones(n_live, bool),
        jnp.asarray(q) if with_q else None)
    assert int(ovf) == 0
    return s


def _port_store(js) -> tst.MultiStore:
    keys = np.array(js.keys)                  # writable copies
    return tst.MultiStore(
        keys=words_t(keys.T), val_hi=words_t(np.array(js.val_hi)),
        val_lo=words_t(np.array(js.val_lo)),
        val_q=torch.from_numpy(np.array(js.val_q)),
        size=torch.tensor(int(js.size), dtype=torch.int32))


def _pairs_jax(js):
    n = int(js.size)
    keys = np.asarray(js.keys)
    return _pairs(keys, n, np.asarray(js.val_hi), np.asarray(js.val_lo),
                  np.asarray(js.val_q))


def _pairs_port(ts):
    n = int(ts.size)
    keys = ts.keys.numpy().view(np.uint32).T
    return _pairs(keys, n, ts.val_hi.numpy().view(np.uint32),
                  ts.val_lo.numpy().view(np.uint32), ts.val_q.numpy())


def _pairs(keys, n, hi, lo, q):
    """(sorted key rows as a list, sorted pair multiset, dead rows all
    sentinel?)"""
    live = [tuple(r) for r in keys[:n].tolist()]
    pairs = sorted(zip(live, hi[:n].tolist(), lo[:n].tolist(),
                       q[:n].view(np.uint32).tolist()))
    return live, pairs, bool((keys[n:] == SENT).all())


def _assert_same_store(ts, js):
    assert int(ts.size) == int(js.size)
    assert ts.capacity == js.capacity
    assert _pairs_port(ts) == _pairs_jax(js)


def _args(words, hi, lo, q, valid, with_q, port):
    if port:
        return (words_t(words), words_t(hi), words_t(lo),
                torch.from_numpy(valid),
                torch.from_numpy(q) if with_q else None)
    return (jnp.asarray(words), jnp.asarray(hi), jnp.asarray(lo),
            jnp.asarray(valid), jnp.asarray(q) if with_q else None)


@pytest.mark.parametrize("w", [1, 2])
@pytest.mark.parametrize("with_q", [False, True])
def test_multi_insert_matches_jax(w, with_q):
    """A stable sort on both sides: the stores are equal row for row."""
    rng = np.random.default_rng(w + 10 * with_q)
    js = _jax_store(rng, 4096, w, 1500)
    batch = _batch(rng, 1200, w)
    jn, jo = jst.multi_insert(js, *_args(*batch, with_q, False))
    tn, to = tst.multi_insert(_port_store(js), *_args(*batch, with_q, True))
    assert int(to) == int(jo) == 0
    _assert_same_store(tn, jn)
    n = int(jn.size)
    np.testing.assert_array_equal(tn.keys.numpy().view(np.uint32).T[:n],
                                  np.asarray(jn.keys)[:n])
    np.testing.assert_array_equal(tn.val_lo.numpy().view(np.uint32)[:n],
                                  np.asarray(jn.val_lo)[:n])


@pytest.mark.parametrize("w", [1, 2, 3])
@pytest.mark.parametrize("with_q", [False, True])
def test_multi_merge_flush_matches_jax(w, with_q):
    """K2 with 2 payloads (the id halves), or 3 with the quality bits."""
    rng = np.random.default_rng(20 + w + 10 * with_q)
    js = _jax_store(rng, 8192, w, 3000, with_q=with_q)
    batch = _batch(rng, 2500, w)
    jn, jo = jst.multi_merge_flush(js, *_args(*batch, with_q, False))
    tn, to = tst.multi_merge_flush(_port_store(js),
                                   *_args(*batch, with_q, True))
    assert int(to) == int(jo) == 0
    _assert_same_store(tn, jn)
    if not with_q:
        assert not tn.val_q.any()


@pytest.mark.parametrize("w", [1, 2, 4])
@pytest.mark.parametrize("with_q", [False, True])
def test_multi_merge_flush_flagged_matches_jax(w, with_q):
    """Full-word keys (k = 16 / 32 / 64 DNA), some bit-equal to the
    sentinel: the liveness flag rides K2 as a leading key column (w + 1
    key columns, up to 5)."""
    rng = np.random.default_rng(40 + w + 10 * with_q)
    js = _jax_store(rng, 8192, w, 3000, full_word=True, with_q=with_q)
    batch = _batch(rng, 2500, w, full_word=True)
    assert (batch[0] == SENT).all(axis=1)[batch[4]].any()
    jn, jo = jst.multi_merge_flush_flagged(js, *_args(*batch, with_q, False))
    tn, to = tst.multi_merge_flush_flagged(_port_store(js),
                                           *_args(*batch, with_q, True))
    assert int(to) == int(jo) == 0
    _assert_same_store(tn, jn)


@pytest.mark.parametrize("flagged", [False, True])
def test_merge_flush_overflow_matches_jax(flagged):
    """A batch that does not fit: the same overflow, the store cut at its
    capacity (the smallest keys kept)."""
    rng = np.random.default_rng(60 + flagged)
    js = _jax_store(rng, 2048, 2, 1500, full_word=flagged)
    batch = _batch(rng, 1500, 2, full_word=flagged)
    jfn = jst.multi_merge_flush_flagged if flagged else jst.multi_merge_flush
    tfn = tst.multi_merge_flush_flagged if flagged else tst.multi_merge_flush
    jn, jo = jfn(js, *_args(*batch, True, False))
    tn, to = tfn(_port_store(js), *_args(*batch, True, True))
    assert int(to) == int(jo) > 0
    assert int(tn.size) == int(jn.size) == 2048
    assert _pairs_port(tn)[0] == _pairs_jax(jn)[0]


def _queries(rng, js, m, w, full_word=False):
    n = int(js.size)
    keys = np.asarray(js.keys)
    present = keys[rng.integers(0, n, m // 2)]
    absent = _rows(rng, m - m // 2, w, 5000, full_word)
    return np.concatenate([present, absent])


@pytest.mark.parametrize("w,full_word", [(1, False), (2, False), (2, True)])
def test_lookup_ranges_count_and_aux_match_jax(w, full_word):
    """Ranges from the per-call scans and from cached aux metadata; the
    JAX package's join branch (m * 8 >= cap) gives the same answers as the
    port's bucket-seeded search."""
    rng = np.random.default_rng(70 + w + full_word)
    js = _jax_store(rng, 4096, w, 2500, full_word=full_word)
    ts = _port_store(js)
    for m in (100, 900):                      # JAX: search, then join
        q = _queries(rng, js, m, w, full_word)
        jlo, jhi = jst.multi_lookup_ranges(js, jnp.asarray(q))
        tlo, thi = tst.multi_lookup_ranges(ts, words_t(q))
        np.testing.assert_array_equal(tlo.numpy(), np.asarray(jlo))
        np.testing.assert_array_equal(thi.numpy(), np.asarray(jhi))
        assert (np.asarray(jhi) > np.asarray(jlo)).sum() >= m // 2
        np.testing.assert_array_equal(
            tst.multi_count(ts, words_t(q)).numpy(),
            np.asarray(jst.multi_count(js, jnp.asarray(q))))
    for tbits in (8, 16):
        jext, jb = jst.multi_query_aux(js, tbits)
        text, tb = tst.multi_query_aux(ts, tbits)
        np.testing.assert_array_equal(text.numpy().view(np.uint32).T,
                                      np.asarray(jext))
        np.testing.assert_array_equal(tb.numpy(), np.asarray(jb))
        jr = jst.multi_lookup_ranges_aux(js, jext, jb, jnp.asarray(q))
        tr = tst.multi_lookup_ranges_aux(ts, text, tb, words_t(q))
        for a, b in zip(tr, jr):
            np.testing.assert_array_equal(a.numpy(), np.asarray(b))


def test_multi_gather_matches_jax():
    rng = np.random.default_rng(80)
    js = _jax_store(rng, 4096, 2, 2500)
    ts = _port_store(js)
    q = _queries(rng, js, 300, 2)
    jlo, jhi = jst.multi_lookup_ranges(js, jnp.asarray(q))
    lo, hi = tst.multi_lookup_ranges(ts, words_t(q))
    for width in (1, 4, 16):
        want = jst.multi_gather(js, jlo, jhi, width)
        got = tst.multi_gather(ts, lo, hi, width)
        mask = np.asarray(want[3])
        np.testing.assert_array_equal(got[3].numpy(), mask)
        for g, wv in zip(got[:3], want[:3]):
            g = g.numpy().view(np.uint32)
            np.testing.assert_array_equal(g[mask],
                                          np.asarray(wv).view(np.uint32)[mask])


@pytest.mark.parametrize("cached", [False, True])
def test_multi_erase_and_distinct_match_jax(cached):
    rng = np.random.default_rng(90 + cached)
    js = _jax_store(rng, 4096, 2, 2500)
    ts = _port_store(js)
    q = _queries(rng, js, 200, 2)
    qvalid = rng.random(200) > 0.2
    jn, jerased = jst.multi_erase(js, jnp.asarray(q), jnp.asarray(qvalid))
    aux = tst.multi_query_aux(ts) if cached else None
    tn, terased = tst.multi_erase(ts, words_t(q), torch.from_numpy(qvalid),
                                  aux)
    assert int(terased) == int(jerased) > 0
    _assert_same_store(tn, jn)
    keys = np.asarray(jn.keys)[:int(jn.size)]
    assert int(tst.multi_distinct(tn)) == len({tuple(r) for r in keys})


def test_grow_and_stack():
    rng = np.random.default_rng(95)
    ts = _port_store(_jax_store(rng, 1024, 2, 700))
    big = tst.multi_grow(ts, 4096)
    assert big.capacity == 4096 and int(big.size) == 700
    assert _pairs_port(big) == _pairs_port(ts)
    st2 = tst.stack_multi_stores([big, big])
    assert st2.keys.shape == (2, 2, 4096)
    assert _pairs_port(st2.shard(1)) == _pairs_port(ts)
