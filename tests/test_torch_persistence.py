"""Persistence of the port's indexes: npz files in the JAX package's
formats (kind "count", "position", "sorted_position") written by either
package load in the other at another shard count with equal to_dict();
the port's sharded checkpoints (utils/checkpoint.py: per-shard torch.save
files and a JSON config) restore every family at 1 and 4 shards; and
IndexConfig builds every family the port has and names the ROADMAP item of
those it lacks.  The JAX indexes run on the conftest's 8-device CPU mesh.
Counts, keys and ids: exact; qualities: rtol 1e-5."""

import dataclasses
import json

import jax
import numpy as np
import pytest

import kmerind_tpu as kt
import kmerind_tpu_torch as kp
from kmerind_tpu.config import IndexConfig as JaxIndexConfig
from kmerind_tpu.index import api as japi
from kmerind_tpu.index import sorted_api as jsapi
from kmerind_tpu.io import read_file as jax_read_file
from kmerind_tpu.parallel.mesh import make_mesh
from kmerind_tpu_torch.io import read_file as port_read_file
from kmerind_tpu_torch.utils.checkpoint import load_index, save_index

from torch_parity import write_reads

CHUNK = 3000


@pytest.fixture(scope="module")
def reads(tmp_path_factory):
    path = tmp_path_factory.mktemp("torch_persistence") / "reads.fastq"
    write_reads(path, 100, 100, 1500, seed=41, n_rate=0.005,
                varied_quality=True)
    return path


def _same_contents(got, want, with_quality):
    assert got.keys() == want.keys()
    for key, pairs in want.items():
        if not with_quality:
            assert got[key] == pairs
            continue
        assert [i for i, _ in got[key]] == [i for i, _ in pairs]
        np.testing.assert_allclose([x for _, x in got[key]],
                                   [x for _, x in pairs], rtol=1e-5)


@pytest.mark.parametrize("saturate", [None, 4])
def test_count_npz_across_packages(reads, tmp_path, saturate):
    """A JAX CountIndex's npz loads in the port at 1 and 4 shards, a port
    npz in the JAX package; the saturate ceiling travels with the file."""
    jidx = japi.CountIndex(kt.KmerSpec(21, kt.DNA), saturate=saturate)
    jidx.insert_batch(jax_read_file(reads, kt.DNA), chunk_bases=CHUNK)
    want = jidx.to_dict()
    jidx.save(tmp_path / "jax.npz")
    for p in (1, 4):
        pidx = kp.CountIndex.load(tmp_path / "jax.npz", "cpu", nparts=p)
        assert pidx.nparts == p and pidx.saturate == saturate
        assert pidx.to_dict() == want
    pidx.insert_counts(["A" * 21], [7])
    pidx.save(tmp_path / "port.npz")
    back = japi.CountIndex.load(tmp_path / "port.npz", mesh=make_mesh(8))
    assert back.saturate == saturate and back.to_dict() == pidx.to_dict()
    with pytest.raises(ValueError, match="'count' index"):
        kp.SortedCountIndex.load(tmp_path / "port.npz", "cpu")


MULTI = {
    "hash": (japi.PositionIndex, kp.PositionIndex),
    "sorted_q": (jsapi.SortedPositionQualityIndex,
                 kp.SortedPositionQualityIndex),
}


@pytest.mark.parametrize("family", ["hash", "sorted_q"])
def test_multimap_npz_across_packages(reads, tmp_path, family):
    """The multimaps' npz ("position" for the hash family with its hash
    name, "sorted_position" for the range family; with and without
    quality) both ways, at 4 and 2 shards."""
    jcls, pcls = MULTI[family]
    jidx = jcls(kt.KmerSpec(21, kt.DNA), mesh=make_mesh(8), canonical=True,
                id_kind="short")
    for chunk in jax_read_file(reads, kt.DNA).iter_chunks(CHUNK, 20):
        jidx.insert_batch(chunk)
        jax.block_until_ready(jidx._pending[-1])
    want = jidx.to_dict()
    jidx.save(tmp_path / "jax.npz")
    pidx = pcls.load(tmp_path / "jax.npz", "cpu", nparts=4)
    assert pidx.nparts == 4 and pidx.canonical
    _same_contents(pidx.to_dict(), want, pidx.with_quality)
    first = next(iter(want))
    assert pidx.erase([first]) == len(want[first])
    pidx.save(tmp_path / "port.npz")
    back = jcls.load(tmp_path / "port.npz", mesh=make_mesh(2))
    _same_contents(back.to_dict(), pidx.to_dict(), pidx.with_quality)
    assert back.size() == pidx.size() == jidx.size() - len(want[first])


FAMILIES = [
    ("count", kp.CountIndex, {"saturate": 5, "hash_name": "farm"}),
    ("sorted_count", kp.SortedCountIndex, {"saturate": 5}),
    ("position", kp.PositionIndex, {"id_kind": "long"}),
    ("posqual", kp.PositionQualityIndex, {}),
    ("sorted_position", kp.SortedPositionIndex, {}),
    ("sorted_posqual", kp.SortedPositionQualityIndex, {}),
]


@pytest.mark.parametrize("p", [1, 4])
@pytest.mark.parametrize("name,cls,kw", FAMILIES,
                         ids=[f[0] for f in FAMILIES])
def test_checkpoint_round_trip(reads, tmp_path, name, cls, kw, p):
    """save_index -> load_index gives the same class, config and contents
    at the same shard count, and answers the same; another shard count is
    refused."""
    idx = cls(kp.KmerSpec(21, kp.DNA), device="cpu", nparts=p, **kw)
    idx.insert_batch(port_read_file(reads, kp.DNA), chunk_bases=CHUNK)
    save_index(idx, tmp_path / "ck")
    meta = json.loads((tmp_path / "ck" / "kmerind_meta.json").read_text())
    assert meta["nparts"] == p
    assert set(meta["config"]) <= {f.name for f in
                                   dataclasses.fields(JaxIndexConfig)}
    back = load_index(tmp_path / "ck", "cpu")
    assert type(back) is cls and back.nparts == p
    for attr, value in kw.items():
        assert getattr(back, attr) == value
    if name.endswith("posqual") or name.endswith("position"):
        _same_contents(back.to_dict(), idx.to_dict(), idx.with_quality)
    else:
        assert back.to_dict() == idx.to_dict()
        np.testing.assert_array_equal(back.histogram(), idx.histogram())
    q = [idx.spec.to_string(idx.spec.from_int(v))
         for v in list(idx.to_dict())[:50]]
    np.testing.assert_array_equal(back.count(q), idx.count(q))
    with pytest.raises(ValueError, match="shards"):
        load_index(tmp_path / "ck", "cpu", nparts=p + 1)


def test_checkpoint_refuses_foreign_meta(tmp_path):
    """A directory whose meta file is not the port's (e.g. a JAX Orbax
    checkpoint's) is refused, pointing to the npz path."""
    (tmp_path / "kmerind_meta.json").write_text(json.dumps(
        {"config": {"k": 21}, "nparts": 1, "format": 2}))
    with pytest.raises(ValueError, match="npz"):
        load_index(tmp_path, "cpu")


@pytest.mark.parametrize("cfg,cls", [
    ({}, kp.CountIndex),
    ({"index": "position", "strands": "single"}, kp.PositionIndex),
    ({"index": "posqual", "quality_codec": "Sanger"},
     kp.PositionQualityIndex),
    ({"distribution": "range", "saturate": 9}, kp.SortedCountIndex),
    ({"distribution": "range", "index": "position"}, kp.SortedPositionIndex),
    ({"distribution": "range", "index": "posqual", "devices": 3},
     kp.SortedPositionQualityIndex),
])
def test_index_config_builds_the_port_families(cfg, cls):
    """The JAX package's IndexConfig fields build the port's index of the
    same family and settings."""
    assert ([f.name for f in dataclasses.fields(kp.IndexConfig)]
            == [f.name for f in dataclasses.fields(JaxIndexConfig)])
    idx = kp.IndexConfig(fill_factor=2.0, **cfg).make_index("cpu")
    assert type(idx) is cls and idx.fill_factor == 2.0
    assert idx.nparts == cfg.get("devices", 1)
    assert idx.canonical == (cfg.get("strands") != "single")
    if "saturate" in cfg:
        assert idx.saturate == cfg["saturate"]
    if "quality_codec" in cfg:
        assert idx.codec.name == cfg["quality_codec"]


@pytest.mark.parametrize("cfg,item", [
    ({"index": "debruijn"}, "item 14"),
    ({"strands": "bimolecule"}, "item 12"),
    ({"index": "value"}, "item 13"),
    ({"strands": "lex_greater"}, "item 3"),
])
def test_index_config_names_missing_families(cfg, item):
    with pytest.raises(NotImplementedError, match=item):
        kp.IndexConfig(**cfg).make_index("cpu")
    with pytest.raises(ValueError):
        kp.IndexConfig(distribution="ring").make_index("cpu")
