"""The port's one-run bitonic merges against the JAX package's.

On the CPU the card kernels' wrappers (`kernels.bitonic_merge_rows` /
`bitonic_merge_cols`) run their plain versions, the half-cleaner network;
`sortops.bitonic_merge` / `bitonic_merge_cols` run it directly, and
`sortops._merge_bitonic` is the card's routing (payloads widened to the
kernels' int32 columns and narrowed back).  All of them are held against
the TPU kernels themselves — `bitonic_merge_pallas` and
`bitonic_merge_pallas_cols` in interpret mode, their merge block shrunk as
tests/test_torch_sortops.py does — and against the JAX package's network
(its `sortops.bitonic_merge` / `bitonic_merge_cols`) over every payload
dtype it takes.

Inputs come from numpy with a seed: key widths 1, 2, 3 and 9, 0-3
payloads, the descent after the first row, at the middle, before the last
row or nowhere (already sorted), many tied keys and all-ones sentinel rows
at the peak.  Keys must match bitwise; payloads exactly per run of equal
keys, since the Pallas network leaves ties in its own order (against the
JAX network the port's network matches bit for bit, payloads included).
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from kmerind_tpu.ops import pallas_kernels as pk
from kmerind_tpu.ops import sortops as jsort
from kmerind_tpu_torch.ops import kernels
from kmerind_tpu_torch.ops import sortops as tsort

from torch_parity import sorted_key_cols, words_np, words_t

SPLITS = {"1": lambda n: 1, "n/2": lambda n: n // 2, "n-1": lambda n: n - 1,
          "n": lambda n: n}


def _bitonic(rng, n, w, n_asc, n_sentinel=0):
    """uint32[n, w]: n_asc ascending rows, then n - n_asc descending, drawn
    with repeats from a pool of few distinct keys whose top row is all
    ones; `n_sentinel` rows of each side (where it has them) are that
    sentinel, a plateau at the peak."""
    pool = sorted_key_cols(rng, w, max(n // 8, 2), n_sentinel=1).T
    top = pool.shape[0] - 1
    ia = np.sort(rng.integers(0, top + 1, n_asc))
    ib = np.sort(rng.integers(0, top + 1, n - n_asc))
    ia[n_asc - min(n_sentinel, n_asc):] = top
    ib[n - n_asc - min(n_sentinel, n - n_asc):] = top
    return np.concatenate([pool[ia], pool[ib][::-1]])


def _pays(rng, n, npay):
    return [rng.integers(-50, 50, n).astype(np.int32) for _ in range(npay)]


def _bits(a: np.ndarray) -> np.ndarray:
    """The payload's bit patterns as integers (bool, float16, bfloat16
    compare as their bits)."""
    return a.view({1: np.uint8, 2: np.int16, 4: np.int32}[a.itemsize])


def _runs(keys: np.ndarray, pays) -> dict:
    """{key row: sorted payload rows} of a merge output [n, w]."""
    cols = [_bits(np.asarray(p)).tolist() for p in pays]
    runs: dict = {}
    for i, k in enumerate(map(tuple, keys.tolist())):
        runs.setdefault(k, []).append(tuple(c[i] for c in cols))
    return {k: sorted(v) for k, v in runs.items()}


def _port_results(keys, pays):
    """{path: (keys [n, w] numpy, payloads numpy)} of every port path on
    CPU tensors."""
    tk = words_t(keys)
    tp = tuple(torch.from_numpy(p) for p in pays)
    out = {}
    k, p = kernels.bitonic_merge_rows(tk, tp)
    out["kernels.bitonic_merge_rows"] = (words_np(k), p)
    k, p = kernels.bitonic_merge_cols(words_t(keys.T), tp)
    out["kernels.bitonic_merge_cols"] = (words_np(k).T, p)
    k, p = tsort.bitonic_merge(tk, tp)
    out["sortops.bitonic_merge"] = (words_np(k), p)
    k, p = tsort.bitonic_merge_cols(words_t(keys.T), tp)
    out["sortops.bitonic_merge_cols"] = (words_np(k).T, p)
    for row_major in (True, False):
        src = keys if row_major else keys.T
        k, p = tsort._merge_bitonic(words_t(src), tp, row_major)
        k = words_np(k) if row_major else words_np(k).T
        out[f"sortops._merge_bitonic row_major={row_major}"] = (k, p)
    return {name: (k, [q.numpy() for q in p]) for name, (k, p) in
            out.items()}


@pytest.mark.parametrize("w,npay,split,n,n_sentinel", [
    (1, 0, "1", 2048, 0), (2, 1, "n/2", 2048, 0), (3, 3, "n-1", 4096, 0),
    (9, 2, "n", 2048, 0), (2, 0, "n/2", 4096, 300), (1, 3, "n/2", 2048, 100),
])
def test_matches_pallas_interpret(monkeypatch, w, npay, split, n,
                                  n_sentinel):
    """Every port path against both TPU kernels in interpret mode."""
    small = 1 << 10
    monkeypatch.setattr(pk, "_MG_BLOCK", small)
    monkeypatch.setattr(pk, "_mg_block_for", lambda ncols: small)
    rng = np.random.default_rng(w * 100 + npay * 10 + n_sentinel)
    keys = _bitonic(rng, n, w, SPLITS[split](n), n_sentinel)
    pays = _pays(rng, n, npay)
    jp = tuple(jnp.asarray(p) for p in pays)
    jk_rows, jp_rows = pk.bitonic_merge_pallas(jnp.asarray(keys), jp,
                                               interpret=True)
    jk_cols, jp_cols = pk.bitonic_merge_pallas_cols(jnp.asarray(keys.T), jp,
                                                    interpret=True)
    want_k = np.asarray(jk_rows)
    np.testing.assert_array_equal(np.asarray(jk_cols).T, want_k)
    want = _runs(want_k, jp_rows)
    assert _runs(want_k, jp_cols) == want
    assert np.array_equal(want_k, np.sort(keys.view(np.dtype(
        [("", np.uint32)] * w)).ravel()).view(np.uint32).reshape(n, w))
    for name, (k, p) in _port_results(keys, pays).items():
        np.testing.assert_array_equal(k, want_k, err_msg=name)
        assert _runs(k, p) == want, name


@pytest.mark.parametrize("split", list(SPLITS))
@pytest.mark.parametrize("w", [1, 2, 3, 9])
def test_matches_jax_network(w, split):
    """Every port path against the JAX network (rows and columns) at n =
    256: keys and payloads bit for bit; 0-3 payloads, each width taking
    every count once over the four splits."""
    n = 256
    npay = ([1, 2, 3, 9].index(w) + list(SPLITS).index(split)) % 4
    rng = np.random.default_rng(7 * w + npay)
    keys = _bitonic(rng, n, w, SPLITS[split](n), n_sentinel=5)
    pays = _pays(rng, n, npay)
    jp = tuple(jnp.asarray(p) for p in pays)
    jk, jpay = jsort.bitonic_merge(jnp.asarray(keys), jp)
    ck, cpay = jsort.bitonic_merge_cols(jnp.asarray(keys.T), jp)
    want_k = np.asarray(jk)
    np.testing.assert_array_equal(np.asarray(ck).T, want_k)
    for name, (k, p) in _port_results(keys, pays).items():
        np.testing.assert_array_equal(k, want_k, err_msg=name)
        for got, a, b in zip(p, jpay, cpay):
            np.testing.assert_array_equal(got, np.asarray(a), err_msg=name)
            np.testing.assert_array_equal(got, np.asarray(b), err_msg=name)


def _payload(rng, n, name):
    """(numpy payload for JAX, the same bits as a torch tensor)."""
    if name == "bool":
        a = rng.random(n) < 0.5
        return a, torch.from_numpy(a)
    if name == "bfloat16":
        a = np.asarray(rng.standard_normal(n) * 100, dtype=jnp.bfloat16)
        return a, torch.from_numpy(a.view(np.int16)).view(torch.bfloat16)
    if name in ("float16", "float32"):
        a = (rng.standard_normal(n) * 100).astype(name)
        return a, torch.from_numpy(a)
    info = np.iinfo(name)
    a = rng.integers(info.min, info.max, n, endpoint=True).astype(name)
    return a, torch.from_numpy(a)


@pytest.mark.parametrize("name", ["uint8", "int8", "bool", "int16",
                                  "float16", "bfloat16", "int32", "float32"])
def test_payload_dtypes_through_card_routing(name):
    """The card path's routing (`_merge_bitonic`: 8- and 16-bit payloads
    widened to int32 columns and narrowed back, 32-bit ones as their bits)
    against `jsort.bitonic_merge` on a payload of each dtype the JAX
    function takes, beside an int32 one: keys bitwise, payloads per key
    run, the dtype kept."""
    rng = np.random.default_rng(len(name))
    n = 512
    keys = _bitonic(rng, n, 2, 200, n_sentinel=3)
    pay, tpay = _payload(rng, n, name)
    other = rng.integers(-9, 9, n).astype(np.int32)
    jk, jp = jsort.bitonic_merge(jnp.asarray(keys),
                                 (jnp.asarray(pay), jnp.asarray(other)))
    jk, jp = np.asarray(jk), [np.asarray(p) for p in jp]
    assert jp[0].dtype == pay.dtype
    for row_major in (True, False):
        src = keys if row_major else keys.T
        k, (p, q) = tsort._merge_bitonic(
            words_t(src), (tpay, torch.from_numpy(other)), row_major)
        k = words_np(k) if row_major else words_np(k).T
        assert p.dtype == tpay.dtype and q.dtype == torch.int32
        np.testing.assert_array_equal(k, jk)
        bits = p.view({1: torch.uint8, 2: torch.int16, 4: torch.int32}[
            p.element_size()]).numpy()
        assert _runs(k, [bits, q.numpy()]) == _runs(jk, jp)


@pytest.mark.parametrize("dtype", [torch.int64, torch.float64])
def test_64_bit_payloads_raise_on_card_routing(dtype):
    """The JAX package runs without x64: a 64-bit payload has no JAX
    counterpart, and the card path refuses it."""
    keys = words_t(_bitonic(np.random.default_rng(1), 64, 2, 30))
    with pytest.raises(TypeError, match="8, 16 or 32 bits"):
        tsort._merge_bitonic(keys, (torch.zeros(64, dtype=dtype),), True)


def test_layouts_agree_and_length_check():
    """The rows and columns wrappers give the same run on the CPU; a run
    whose length is not a power of two is refused."""
    keys = words_t(_bitonic(np.random.default_rng(2), 64, 2, 30))
    got, _ = kernels.bitonic_merge_rows(keys)
    want, _ = kernels.bitonic_merge_cols(keys.t().contiguous())
    assert torch.equal(got, want.t())
    with pytest.raises(ValueError, match="power-of-two"):
        tsort.bitonic_merge_cols(keys[:48].t())
