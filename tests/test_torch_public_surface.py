"""The rest of the JAX package's public surface in the port: the search,
join and bitonic functions of ops/sortops.py, `packing.sliding_packs`,
`farmhash.hash64_bytes`, `kmer_parsers.batch_to_arrays`,
`ReadBatch.shard_with_halo`, the subpackage re-exports, `num_shards` and
`store` on every index family, and an `__all__` parity check over every
module of the two packages.

Every function is held against its JAX counterpart on seeded numpy inputs,
exactly; the bitonic merges' device path (one merge of the prefix with the
reversed suffix, run here through the kernels' plain versions) per key
run, as it orders equal keys differently from the network."""

import importlib
import pkgutil

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import kmerind_tpu
import kmerind_tpu_torch
from kmerind_tpu.io import batch as jbatch
from kmerind_tpu.io import kmer_parsers as jparsers
from kmerind_tpu.ops import farmhash as jfarm
from kmerind_tpu.ops import packing as jpacking
from kmerind_tpu.ops import sortops as jsort
from kmerind_tpu_torch import (DNA, BimoleculeCountIndex, CountIndex,
                               DeBruijnGraph, KmerSpec, KmerValueIndex,
                               PositionIndex, PositionQualityIndex,
                               QualityDeBruijnGraph, SortedCountIndex,
                               SortedKmerValueIndex, SortedPositionIndex,
                               SortedPositionQualityIndex)
from kmerind_tpu_torch.index import store as st
from kmerind_tpu_torch.io import batch as tbatch
from kmerind_tpu_torch.io import kmer_parsers as tparsers
from kmerind_tpu_torch.ops import farmhash as tfarm
from kmerind_tpu_torch.ops import packing as tpacking
from kmerind_tpu_torch.ops import sortops as tsort

from torch_parity import words_np, words_t

# ------------------------------------------------------------ sortops
_FACTORY = "a jit step factory (the port's steps are plain *_step functions)"
_DO_NOT_PORT = "on ROADMAP's \"Do not port\" list: no caller in the package"
#: JAX names with no port counterpart, and why (ROADMAP lists them too)
EXCLUDED = {
    "kmerind_tpu.ops.pallas_kernels": "the TPU Pallas kernels: their CUDA "
    "counterparts are kmerind_tpu_torch.ops.kernels (KERNELS)",
    "kmerind_tpu.utils.compile_cache": "JAX's persistent compile cache",
    "kmerind_tpu.utils.packed_string": _DO_NOT_PORT,
    "kmerind_tpu.parallel.SHARD_AXIS": "a JAX mesh axis name",
    "kmerind_tpu.parallel.mesh.SHARD_AXIS": "a JAX mesh axis name",
    "kmerind_tpu.parallel.mesh.DCN_AXIS": "a JAX mesh axis name",
    "kmerind_tpu.parallel.mesh.ICI_AXIS": "a JAX mesh axis name",
    "kmerind_tpu.parallel.mesh.axes_of": "JAX mesh axes of a sharding",
    "kmerind_tpu.parallel.mesh.shard_axis_sharding": "a JAX NamedSharding",
    "kmerind_tpu.parallel.sample_sort.make_sample_sort_step": _FACTORY,
    **{f"kmerind_tpu.index.distributed.{n}": _FACTORY for n in (
        "make_insert_step", "make_count_query_step", "make_erase_step",
        "make_multi_insert_step", "make_multi_count_step")},
    **{f"kmerind_tpu.index.sorted_dist.{n}": _FACTORY for n in (
        "make_count_flush_step", "make_count_query_step",
        "make_count_erase_step", "make_multi_flush_step",
        "make_multi_count_step", "make_multi_find_step",
        "make_multi_erase_step")},
    **{f"kmerind_tpu.index.store.{n}": _DO_NOT_PORT for n in (
        "BimolStore", "empty_bimol_store", "bimol_insert")},
    "kmerind_tpu.index.store.count_insert": "reached only through the jit "
    "factories make_insert_step / make_merge_step",
    "kmerind_tpu.index.store.run_lookup": "reached only through the jit "
    "factories; the port's count queries take the cached aux "
    "(run_lookup_aux)",
    "kmerind_tpu.index.store.run_erase": "reached only through "
    "make_run_erase_step; the port erases with run_erase_cover",
    "kmerind_tpu.index.store.run_bimol_lookup": "reached only through "
    "make_run_bimol_find_step; the port's Bimolecule finds take "
    "run_bimol_find_aux",
    "kmerind_tpu.index.store.run_bimol_erase": "reached only through "
    "make_run_bimol_erase_step; the port erases with run_erase_cover",
    **{f"kmerind_tpu.index.store.run_vecq_{n}": f"the quality store's "
       f"twin of run_vec_{n}, which takes both store kinds in the port"
       for n in ("lookup", "distinct", "compact")},
}


def _sorted_rows(rng, n, w, size):
    """uint32[n, w] rows sorted over the first `size`, sentinel after;
    many ties on word 0 and some top-bit words."""
    keys = rng.integers(0, 2**32, (n, w), dtype=np.uint32)
    keys[:, 0] >>= rng.integers(8, 32, n).astype(np.uint32)
    keys[::5, 0] |= np.uint32(0x80000000)
    keys = keys[np.lexsort(keys.T[::-1])]
    keys[size:] = 0xFFFFFFFF
    return keys


def _queries(rng, keys, size, w):
    return np.concatenate([keys[rng.integers(0, size, 300)],
                           rng.integers(0, 2**32, (200, w), dtype=np.uint32)])


@pytest.mark.parametrize("w", [1, 2, 3])
@pytest.mark.parametrize("fn", ["lower_bound", "upper_bound"])
def test_bounds_match_jax(fn, w):
    rng = np.random.default_rng(w)
    n, size = 1000, 900
    keys = _sorted_rows(rng, n, w, size)
    q = _queries(rng, keys, size, w)
    want = np.asarray(getattr(jsort, fn)(jnp.asarray(keys), size,
                                         jnp.asarray(q)))
    got = getattr(tsort, fn)(words_t(keys), size, words_t(q))
    np.testing.assert_array_equal(got.numpy(), want)
    want = np.asarray(getattr(jsort, fn + "_cols")(
        jnp.asarray(keys.T), size, jnp.asarray(q)))
    got = getattr(tsort, fn + "_cols")(words_t(keys.T), size, words_t(q))
    np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("tbits", [8, 16])
def test_lower_bound_cols_bucketed_matches_jax(tbits):
    rng = np.random.default_rng(tbits)
    keys = _sorted_rows(rng, 2000, 2, 1800)
    q = _queries(rng, keys, 1800, 2)
    want = jsort.lower_bound_cols_bucketed(jnp.asarray(keys.T), 1800,
                                           jnp.asarray(q), tbits=tbits)
    got = tsort.lower_bound_cols_bucketed(words_t(keys.T), 1800, words_t(q),
                                          tbits=tbits)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


@pytest.mark.parametrize("w", [1, 2])
def test_unique_counts_matches_jax(w):
    rng = np.random.default_rng(10 + w)
    keys = _sorted_rows(rng, 1500, w, 1400)
    keys[:1400] = keys[np.sort(rng.integers(0, 300, 1400))]
    valid = np.arange(1500) < 1400
    ju, jc, jn = jsort.unique_counts(jnp.asarray(keys), jnp.asarray(valid))
    tu, tc, tn = tsort.unique_counts(words_t(keys), torch.from_numpy(valid))
    np.testing.assert_array_equal(words_np(tu), np.asarray(ju))
    np.testing.assert_array_equal(tc.numpy(), np.asarray(jc))
    assert int(tn) == int(jn)


def _unique_store(rng, n, w, size):
    keys = np.unique(_sorted_rows(rng, n, w, n)[:size], axis=0)
    out = np.full((n, w), 0xFFFFFFFF, np.uint32)
    out[:keys.shape[0]] = keys
    return out, keys.shape[0]


@pytest.mark.parametrize("w", [1, 2])
def test_lookup_joins_match_jax(w):
    rng = np.random.default_rng(20 + w)
    n = 1200
    keys, size = _unique_store(rng, n, w, 1000)
    keys[size - 1] = 0xFFFFFFFF     # a real all-ones key before the tail
    q = _queries(rng, keys, size, w)
    q[:5] = 0xFFFFFFFF
    vals = rng.integers(-1000, 1000, n).astype(np.int32)
    fvals = rng.random(n).astype(np.float32)
    want = jsort.lookup_join(jnp.asarray(keys), size, jnp.asarray(vals),
                             jnp.asarray(q))
    got = tsort.lookup_join(words_t(keys), size, torch.from_numpy(vals),
                            words_t(q))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    (jv, jf), jfound = jsort.lookup_join_vals(
        jnp.asarray(keys), size, (jnp.asarray(vals), jnp.asarray(fvals)),
        jnp.asarray(q))
    (tv, tf), tfound = tsort.lookup_join_vals(
        words_t(keys), size, (torch.from_numpy(vals),
                              torch.from_numpy(fvals)), words_t(q))
    np.testing.assert_array_equal(tv.numpy(), np.asarray(jv))
    np.testing.assert_array_equal(tf.numpy(), np.asarray(jf))
    np.testing.assert_array_equal(tfound.numpy(), np.asarray(jfound))


@pytest.mark.parametrize("w", [1, 2, 3])
def test_lookup_join_ranges_and_runs_match_jax(w):
    rng = np.random.default_rng(30 + w)
    n, size = 1500, 1300
    keys = _sorted_rows(rng, n, w, size)
    q = _queries(rng, keys, size, w)
    jlo, jhi = jsort.lookup_join_ranges(jnp.asarray(keys), size,
                                        jnp.asarray(q))
    tlo, thi = tsort.lookup_join_ranges(words_t(keys), size, words_t(q))
    np.testing.assert_array_equal(tlo.numpy(), np.asarray(jlo))
    np.testing.assert_array_equal(thi.numpy(), np.asarray(jhi))
    wts = rng.integers(0, 7, n).astype(np.int32)
    wts[size:] = 0
    csum = np.concatenate([[0], np.cumsum(wts)]).astype(np.int32)
    want = jsort.lookup_join_runs(jnp.asarray(keys), jnp.asarray(csum),
                                  jnp.asarray(q))
    got = tsort.lookup_join_runs(words_t(keys), torch.from_numpy(csum),
                                 words_t(q))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    want = jsort.lookup_join_runs_cols(jnp.asarray(keys.T),
                                       jnp.asarray(csum), jnp.asarray(q))
    got = tsort.lookup_join_runs_cols(words_t(keys.T),
                                      torch.from_numpy(csum), words_t(q))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def _bitonic(rng, n, w, n_asc):
    """uint32[n, w] rows ascending for n_asc rows, then descending, with
    ties inside and across the halves, and int32 payloads."""
    pool = _sorted_rows(rng, 4 * n, w, 4 * n)[: 4 * n]
    pool = np.unique(pool[rng.integers(0, 4 * n, n // 3)], axis=0)
    asc = pool[np.sort(rng.integers(0, pool.shape[0], n_asc))]
    dsc = pool[np.sort(rng.integers(0, pool.shape[0], n - n_asc))][::-1]
    return (np.concatenate([asc, dsc]),
            rng.integers(-50, 50, n).astype(np.int32))


def _key_runs(keys, pay):
    """{key row: sorted payloads} of a merge output."""
    runs: dict = {}
    for k, p in zip(map(tuple, keys.tolist()), pay.tolist()):
        runs.setdefault(k, []).append(p)
    return {k: sorted(v) for k, v in runs.items()}


@pytest.mark.parametrize("w", [1, 2, 3])
@pytest.mark.parametrize("n_asc", [1, 300, 1024])
def test_bitonic_merges_match_jax(w, n_asc):
    rng = np.random.default_rng(40 + w + n_asc)
    keys, pay = _bitonic(rng, 1024, w, n_asc)
    jk, (jp,) = jsort.bitonic_merge(jnp.asarray(keys), (jnp.asarray(pay),))
    jk, jp = np.asarray(jk), np.asarray(jp)
    # the CPU path is the network itself: bit for bit, ties included
    tk, (tp,) = tsort.bitonic_merge(words_t(keys), (torch.from_numpy(pay),))
    np.testing.assert_array_equal(words_np(tk), jk)
    np.testing.assert_array_equal(tp.numpy(), jp)
    ck, (cp,) = tsort.bitonic_merge_cols(words_t(keys.T),
                                         (torch.from_numpy(pay),))
    np.testing.assert_array_equal(words_np(ck), jk.T)
    np.testing.assert_array_equal(cp.numpy(), jp)
    # the card's path (K2′ / K2 after the split) through the plain merges
    for row_major in (True, False):
        src = keys if row_major else keys.T
        mk, (mp,) = tsort._merge_bitonic(
            words_t(src), (torch.from_numpy(pay),), row_major)
        mk = words_np(mk) if row_major else words_np(mk).T
        np.testing.assert_array_equal(mk, jk)
        assert _key_runs(mk, mp.numpy()) == _key_runs(jk, jp)


def test_bitonic_merge_float_payload_and_length_check():
    rng = np.random.default_rng(5)
    keys, _ = _bitonic(rng, 256, 2, 100)
    q = rng.random(256).astype(np.float32)
    jk, (jq,) = jsort.bitonic_merge(jnp.asarray(keys), (jnp.asarray(q),))
    mk, (mq,) = tsort._merge_bitonic(words_t(keys), (torch.from_numpy(q),),
                                     True)
    assert mq.dtype == torch.float32
    assert _key_runs(words_np(mk), mq.numpy()) == _key_runs(
        np.asarray(jk), np.asarray(jq))
    with pytest.raises(ValueError, match="power-of-two"):
        tsort.bitonic_merge(words_t(keys[:100]))


# ---------------------------------------------- packing, farmhash, io
@pytest.mark.parametrize("m,bits", [(1, 2), (5, 2), (16, 2), (8, 4),
                                    (3, 8), (4, 8)])
def test_sliding_packs_matches_jax(m, bits):
    rng = np.random.default_rng(m * 10 + bits)
    codes = rng.integers(0, 1 << bits, 777).astype(np.uint8)
    want = np.asarray(jpacking.sliding_packs(jnp.asarray(codes), m, bits))
    got = tpacking.sliding_packs(torch.from_numpy(codes), m, bits)
    np.testing.assert_array_equal(words_np(got), want)
    with pytest.raises(ValueError):
        tpacking.sliding_packs(torch.from_numpy(codes), 17, 2)


def test_hash64_bytes_matches_jax():
    rng = np.random.default_rng(3)
    for n in list(range(1, 65)):
        data = rng.integers(0, 256, n, dtype=np.uint8).tobytes()
        for seed in (0, 42):
            assert tfarm.hash64_bytes(data, seed) == jfarm.hash64_bytes(
                data, seed), (n, seed)
    for bad in (b"", bytes(65)):
        with pytest.raises(ValueError):
            tfarm.hash64_bytes(bad)


def _batch(mod, rng, n=1000):
    """A ReadBatch of the package `mod` (both take the same columns)."""
    r = 7
    seg = np.sort(rng.integers(0, r, n)).astype(np.int32)
    return mod.ReadBatch(
        codes=rng.integers(0, 4, n).astype(np.uint8),
        valid=rng.random(n) > 0.05, owned=np.ones(n, bool), seg_id=seg,
        offset_in_record=rng.integers(0, 300, n).astype(np.uint32),
        global_pos=np.arange(n, dtype=np.uint64) * 3 + (1 << 41),
        qual=rng.integers(33, 75, n).astype(np.uint8),
        record_start=np.arange(r, dtype=np.uint64) * (1 << 38),
        seq_index=np.arange(r, dtype=np.uint32) + 5,
        file_id=np.full(r, 3, np.uint16), alphabet=DNA)


@pytest.mark.parametrize("id_kind", [None, "short", "long"])
def test_batch_to_arrays_matches_jax(id_kind):
    tb = _batch(tbatch, np.random.default_rng(8))
    jb = _batch(jbatch, np.random.default_rng(8))
    got = tparsers.batch_to_arrays(tb, id_kind, device="cpu")
    want = jparsers.batch_to_arrays(jb, id_kind)
    for f in ("codes", "valid", "owned", "seg_id", "qual"):
        np.testing.assert_array_equal(getattr(got, f).numpy(),
                                      np.asarray(getattr(want, f)), f)
    for f in ("id_hi", "id_lo"):
        np.testing.assert_array_equal(words_np(getattr(got, f)),
                                      np.asarray(getattr(want, f)), f)


@pytest.mark.parametrize("nshards,halo,halo_left", [(1, 20, 0), (3, 20, 0),
                                                    (4, 21, 1), (7, 0, 0)])
def test_shard_with_halo_matches_jax(nshards, halo, halo_left):
    tb = _batch(tbatch, np.random.default_rng(9), 997)
    jb = _batch(jbatch, np.random.default_rng(9), 997)
    got, gown = tb.shard_with_halo(nshards, halo, halo_left)
    want, wown = jb.shard_with_halo(nshards, halo, halo_left)
    assert gown == wown and len(got) == len(want)
    for g, w in zip(got, want):
        for f in ("codes", "valid", "owned", "seg_id", "offset_in_record",
                  "global_pos", "qual", "record_start", "seq_index",
                  "file_id"):
            np.testing.assert_array_equal(getattr(g, f), getattr(w, f), f)
    # every window start owned by exactly one shard
    assert sum(int(g.owned.sum()) for g in got) == 997


# ---------------------------------------------- index surface, exports
SPEC = KmerSpec(21, DNA)
FAMILIES = [CountIndex, BimoleculeCountIndex, PositionIndex,
            PositionQualityIndex, KmerValueIndex, SortedCountIndex,
            SortedPositionIndex, SortedPositionQualityIndex,
            SortedKmerValueIndex, DeBruijnGraph, QualityDeBruijnGraph]


@pytest.mark.parametrize("cls", FAMILIES, ids=lambda c: c.__name__)
@pytest.mark.parametrize("nparts", [1, 3])
def test_num_shards_on_every_family(cls, nparts):
    assert cls(SPEC, device="cpu", nparts=nparts).num_shards == nparts


def _reads(n_reads=40, seed=0):
    rng = np.random.default_rng(seed)
    return ["".join("ACGT"[c] for c in rng.integers(0, 4, 60))
            for _ in range(n_reads)]


def _fasta(tmp_path, reads, name="r.fa"):
    path = tmp_path / name
    path.write_text("".join(f">r{i}\n{s}\n" for i, s in enumerate(reads)))
    return path


@pytest.mark.parametrize("cls", [CountIndex, DeBruijnGraph,
                                 QualityDeBruijnGraph],
                         ids=lambda c: c.__name__)
def test_store_property_is_the_run_list(cls, tmp_path):
    src = cls(SPEC, device="cpu", nparts=2)
    src.build(_fasta(tmp_path, _reads()))
    want = src.to_dict()
    assert src.store is src.runs
    dst = cls(SPEC, device="cpu", nparts=2)
    dst.store = src.store
    assert dst.to_dict() == want
    dst = cls(SPEC, device="cpu", nparts=2)
    dst.store = src.runs[0] if len(src.runs) == 1 else src.runs
    assert dst.to_dict() == want


def test_bimolecule_store_is_one_run(tmp_path):
    src = BimoleculeCountIndex(SPEC, device="cpu", nparts=2)
    src.build(_fasta(tmp_path, _reads()))
    want = src.to_dict()
    assert isinstance(src.store, st.RunBimolStore)
    dst = BimoleculeCountIndex(SPEC, device="cpu", nparts=2)
    dst.store = src.store
    assert dst.to_dict() == want


def test_count_store_capacity():
    s = st.empty_count_store(64, 2, "cpu")
    assert s.capacity == 64
    assert st.stack_count_stores([s, s]).capacity == 64
    idx = SortedCountIndex(SPEC, device="cpu", nparts=2)
    assert idx.store.capacity == idx.capacity


def test_subpackage_exports():
    from kmerind_tpu_torch.io import (DeviceBases, KmerTuples,  # noqa: F401
                                      batch_to_arrays, block_partition,
                                      extract_tuples, fasta_header_table,
                                      find_fasta_record_start,
                                      find_record_start, parse_fasta,
                                      parse_fastq, read_bytes)
    from kmerind_tpu_torch.parallel import make_mesh
    from kmerind_tpu_torch.utils import (MemUsage, PhaseTimer,  # noqa: F401
                                         load_index, save_index)
    from kmerind_tpu_torch.utils import checkpoint
    assert save_index is checkpoint.save_index
    assert make_mesh(2, "cpu").nparts == 2
    assert kmerind_tpu_torch.__version__ == kmerind_tpu.__version__


def _modules(pkg):
    yield pkg.__name__
    for info in pkgutil.walk_packages(pkg.__path__, pkg.__name__ + "."):
        yield info.name


def test_every_jax_export_has_a_port_counterpart():
    missing = []
    for name in _modules(kmerind_tpu):
        mod = importlib.import_module(name)
        if name in EXCLUDED:
            continue
        port_name = "kmerind_tpu_torch" + name[len("kmerind_tpu"):]
        port = importlib.import_module(port_name)
        for attr in getattr(mod, "__all__", ()):
            if f"{name}.{attr}" not in EXCLUDED and not hasattr(port, attr):
                missing.append(f"{name}.{attr}")
    assert missing == []


def test_exclusions_are_still_missing():
    """Each excluded name lacks a port counterpart and has a reason: a name
    ported later must leave the list."""
    for key, reason in EXCLUDED.items():
        assert reason
        try:
            importlib.import_module(key)
            mod_name, attr = key, None
        except ImportError:
            mod_name, attr = key.rsplit(".", 1)
        port_name = "kmerind_tpu_torch" + mod_name[len("kmerind_tpu"):]
        try:
            port = importlib.import_module(port_name)
        except ImportError:
            assert attr is None, key
            continue
        assert attr is not None and not hasattr(port, attr), key


def test_every_port_export_is_defined():
    for name in _modules(kmerind_tpu_torch):
        mod = importlib.import_module(name)
        for attr in getattr(mod, "__all__", ()):
            assert hasattr(mod, attr), f"{name}.{attr}"
