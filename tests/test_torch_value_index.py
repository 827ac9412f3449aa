"""The port's unique-key k-mer -> uint64 value maps (kmerind_tpu_torch.
index.value_api: KmerValueIndex, SortedKmerValueIndex) against the JAX
package's, under the three reductions "first", "min" and "max".

Each scenario builds from a seeded FASTQ (mixed read lengths, both
strands, 'N's, reads crossing the chunk boundaries; each window's short
position id is its value), then takes explicit inserts with the same key
twice inside one call and again in a later call, values on both sides of
2^63 (min / max compare unsigned), and runs find, find_if, count_if,
erase, erase_if, filter and the npz files both ways.  Each JAX scenario
runs once on the conftest's 8-device CPU mesh (functools.lru_cache) and
is held against the port at 1 and 4 shards.  Values and keys are
integers: exact equality throughout.

The JAX SortedKmerValueIndex under "first" keeps an arbitrary one of the
rows that tie on its priority column — every row of one insert call, and
every file window whose position id shares its high 32 bits (its sort is
unstable) — so the port's sorted map is held there against the JAX hash
map, whose "first" is the documented rule (the earliest position of a
file build, then the earliest insert); `test_sorted_first_known_divergence`
records the difference (ROADMAP queue 3)."""

import functools

import jax
import numpy as np
import pytest

import kmerind_tpu as kt
import kmerind_tpu_torch as kp
from kmerind_tpu.index.value_api import KmerValueIndex as JaxKV
from kmerind_tpu.index.value_api import SortedKmerValueIndex as JaxSortedKV
from kmerind_tpu.io import read_file as jax_read_file
from kmerind_tpu_torch.index.convert import value_index_from_state
from kmerind_tpu_torch.io import read_file as port_read_file

from test_torch_bimolecule import write_mixed

CHUNK = 1200
K = 21
CLASSES = {"hash": (JaxKV, kp.KmerValueIndex),
           "sorted": (JaxSortedKV, kp.SortedKmerValueIndex)}


@pytest.fixture(scope="module")
def reads(tmp_path_factory):
    d = tmp_path_factory.mktemp("torch_value_index")
    return d, tuple(write_mixed(d / "a.fastq", seed=13))


def _inputs(seqs):
    """Explicit insert calls (duplicates inside and across them, present
    and new keys), queries and the keys to erase."""
    rng = np.random.default_rng(4)
    wins = []
    for r in seqs:
        if len(r) >= K:
            i = int(rng.integers(len(r) - K + 1))
            wins.append(r[i:i + K].replace("N", "A"))
    new = ["".join(rng.choice(list("ACGT"), K)) for _ in range(40)]
    kms = new + wins[:10]
    vals = rng.integers(0, 2**63, 2 * len(kms), dtype=np.uint64)
    vals[::3] |= np.uint64(1 << 63)
    calls = [(kms[:45] + kms[:10], vals[:55]),
             (kms[30:] + kms[40:45], vals[55:80])]
    queries = wins[:60] + new + ["".join(rng.choice(list("ACGT"), K))
                                 for _ in range(20)]
    return dict(calls=calls, queries=queries, gone=wins[20:40] + new[:5])


def _odd_lo(k, h, lo):
    return (lo & 1) == 1


def _low_half_odd(k, h, lo):       # values below 2^63 (see the note above)
    return ((lo & 1) == 1) & ((h >> 31) == 0)


def _top_bit(k, h, lo):
    return (h >> 31) == 1


def _keep(k, h, lo):
    return (lo & 3) != 0


def _run(idx, inp, path):
    """The scenario's operations on an index of either package: the answer
    of each, keyed by name."""
    out = dict(built=idx.to_dict())
    for words, vals in inp["calls"]:
        idx.insert(words, vals)
    out.update(inserted=idx.to_dict(), find=idx.find(inp["queries"]),
               find_if=idx.find_if(_odd_lo, inp["queries"]),
               count_if=sorted(idx.count_if(_low_half_odd)),
               count_if_q=idx.count_if(_odd_lo, inp["queries"]),
               size=idx.size())
    out["erased"] = idx.erase(inp["gone"])
    out["erase_if"] = idx.erase_if(_top_bit)
    out["filtered"] = idx.filter(_keep)
    out.update(after=idx.to_dict(), exists=idx.exists(inp["queries"]))
    idx.save(path)
    return out


def _build(cls, path, p=None, reduce="first", jax_side=True):
    if jax_side:
        idx = cls(kt.KmerSpec(K, kt.DNA), reduce=reduce)
        batch = jax_read_file(path, kt.DNA)
        if cls is JaxSortedKV:
            # one chunk per call: the JAX sorted indexes' multi-chunk
            # insert_batch loses k-mers on the CPU backend (ROADMAP queue 3)
            for chunk in batch.iter_chunks(CHUNK, K - 1):
                idx.insert_batch(chunk)
                jax.block_until_ready(idx._pending[-1])
        else:
            idx.insert_batch(batch, chunk_bases=CHUNK)
        return idx
    idx = cls(kp.KmerSpec(K, kp.DNA), device="cpu", nparts=p, reduce=reduce)
    return idx.insert_batch(port_read_file(path, kp.DNA), chunk_bases=CHUNK)


@functools.lru_cache
def _jax_scenario(d, seqs, family, reduce):
    jcls = CLASSES[family][0]
    if family == "sorted" and reduce == "first":
        jcls = JaxKV                # the documented rule (module note)
    idx = _build(jcls, d / "a.fastq", reduce=reduce)
    out = _run(idx, _inputs(seqs), d / f"jax_{family}_{reduce}.npz")
    s = idx.store
    out["state"] = tuple(np.asarray(x) for x in (s.keys, s.val_hi, s.val_lo,
                                                 s.size))
    out["splitters"] = (None if jcls is JaxKV
                        else np.asarray(idx.splitters))
    return out


def _same(got, want):
    for key in ("built", "inserted", "count_if", "size", "erased",
                "erase_if", "filtered", "after"):
        assert got[key] == want[key], key
    for key in ("find", "find_if"):
        for g, w in zip(got[key], want[key]):
            np.testing.assert_array_equal(g, w, err_msg=key)
    for key in ("count_if_q", "exists"):
        np.testing.assert_array_equal(got[key], want[key], err_msg=key)


@pytest.mark.parametrize("p", [1, 4])
@pytest.mark.parametrize("reduce", ["first", "min", "max"])
@pytest.mark.parametrize("family", ["hash", "sorted"])
def test_value_index_matches_jax(reads, tmp_path, family, reduce, p):
    """Build, inserts, find / find_if / count_if, erase / erase_if /
    filter: every answer and the contents after each step equal the JAX
    index's; the npz file each package saved loads in the other with the
    same contents, and `convert.value_index_from_state` carries the JAX
    store over."""
    d, seqs = reads
    want = _jax_scenario(d, seqs, family, reduce)
    jcls, pcls = CLASSES[family]
    idx = _build(pcls, d / "a.fastq", p, reduce, jax_side=False)
    got = _run(idx, _inputs(seqs), tmp_path / "port.npz")
    _same(got, want)
    # the JAX scenario's file is "kv" when its rule came from the hash map
    ref_pcls = (kp.KmerValueIndex if want["splitters"] is None else pcls)
    back = ref_pcls.load(d / f"jax_{family}_{reduce}.npz", "cpu", nparts=p)
    assert back.nparts == p and back.reduce == reduce
    assert back.to_dict() == want["after"]
    if p > 1:
        # the port's file does not depend on p; the JAX side loads it once
        return
    assert jcls.load(tmp_path / "port.npz").to_dict() == want["after"]
    conv = value_index_from_state(*want["state"], want["splitters"],
                                  spec=kp.KmerSpec(K, kp.DNA), device="cpu",
                                  reduce=reduce)
    assert conv.to_dict() == want["after"]
    q = _inputs(seqs)["queries"]
    for g, w in zip(conv.find(q), idx.find(q)):
        np.testing.assert_array_equal(g, w)


def test_sorted_first_known_divergence(reads):
    """The JAX sorted value map under "first" keeps, among rows that tie on
    its priority — a file's windows in one 2^16-base record range, one
    insert call's rows — whichever its unstable sort leaves first; the
    port's keeps the earliest (position id, then row), as the hash maps of
    both packages do.  ROADMAP queue 3 records the difference."""
    d, seqs = reads
    jidx = _build(JaxSortedKV, d / "a.fastq")
    port = _build(kp.SortedKmerValueIndex, d / "a.fastq", 4, jax_side=False)
    rule = _build(JaxKV, d / "a.fastq").to_dict()
    assert port.to_dict() == rule
    assert jidx.to_dict() != rule


def test_value_index_surface_details():
    """Unsigned order and values: "max" keeps 2^63 + 1 over 2^62, "min" the
    reverse, to_dict and count_if return the unsigned value (the JAX
    map's count_if does not: a known divergence); count /
    exists / unique_size; reduce and id_kind are checked; IndexConfig
    builds either class."""
    spec = kp.KmerSpec(K, kp.DNA)
    km = ["ACGT" * 5 + "A"] * 2
    big, small = (1 << 63) + 1, 1 << 62
    for reduce, want in (("max", big), ("min", small), ("first", small)):
        for cls in (kp.KmerValueIndex, kp.SortedKmerValueIndex):
            idx = cls(spec, device="cpu", nparts=2, reduce=reduce)
            idx.insert(km, [small, big])
            assert list(idx.to_dict().values()) == [want]
            assert idx.count_if(lambda k, h, lo: h >= 0)[0][1] == want
            np.testing.assert_array_equal(idx.count(km + ["C" * K]),
                                          [1, 1, 0])
            assert idx.unique_size() == 1 and not idx.empty()
    # the JAX map's count_if returns such a value as a negative int64
    # (ROADMAP queue 3); its to_dict, like the port's, the unsigned value
    jidx = JaxKV(kt.KmerSpec(K, kt.DNA), reduce="max")
    jidx.insert(km, np.array([small, big], np.uint64))
    assert jidx.count_if(lambda k, h, lo: h >= 0)[0][1] == big - (1 << 64)
    assert list(jidx.to_dict().values()) == [big]
    with pytest.raises(ValueError):
        kp.KmerValueIndex(spec, device="cpu", reduce="sum")
    with pytest.raises(ValueError):
        kp.SortedKmerValueIndex(spec, device="cpu", id_kind="medium")
    cfg = kp.IndexConfig(index="value", reduce="max", id_kind="long",
                         devices=3)
    idx = cfg.make_index("cpu")
    assert type(idx) is kp.KmerValueIndex and idx.nparts == 3
    assert (idx.reduce, idx.id_kind) == ("max", "long")
