"""Sharded checkpoint / resume of the port's indexes.

The npz `save` / `load` of every index gathers the whole store to the host
and re-inserts it on load, so it works across shard counts (and across the
two packages: their npz formats are the same).  `save_index` writes each
shard's store as its own `torch.save` file, copied off the device one
shard at a time, beside a JSON file of the index's config (the
`IndexConfig` fields the JAX package's ``utils/checkpoint.py`` writes) and
its shard count; `load_index` builds the index from that config and puts
the shards back on the device as they were.  A run-list index (a count
index or a de Bruijn graph, `index.api._RunListIndex`) consolidates to one
run first (`_checkpoint_prepare`; the graph also builds its counter table,
a Bimolecule index merges its pending runs), a lazy index flushes.  The
config of a `QualityDeBruijnGraph` is a de Bruijn one (the JAX package's
`IndexConfig` has no quality graph), and the meta file marks it.

Under a mesh of several ranks both are collectives: each rank writes and
reads only its own shards' files (the JAX package's ``save_index``, where
every process writes its own shards), rank 0 the splitters and the meta
file once every shard is on disk.

Restoring needs the shard count the checkpoint was written with, as in the
JAX package.  The two packages' checkpoints are not interchangeable (the
JAX package writes an Orbax store); only their npz files are.
"""

from __future__ import annotations

import dataclasses
import json
import pathlib

import torch

from .. import quality
from ..config import IndexConfig
from ..debruijn import DeBruijnGraph, QualityDeBruijnGraph
from ..index import api as hx
from ..index import sorted_api as sx
from ..index import store as st
from ..index import value_api as vx

__all__ = ["save_index", "load_index", "saved_nparts"]

_META = "kmerind_meta.json"
_PACKAGE = "kmerind_tpu_torch"


def _config_of(idx) -> dict:
    """IndexConfig fields that rebuild `idx` empty."""
    def sat():
        return idx.saturate if idx.saturate is not None else 0

    cfg: dict = {"k": idx.spec.k, "alphabet": idx.spec.alphabet.name,
                 "canonical": idx.canonical}
    if isinstance(idx, DeBruijnGraph):
        cfg.update(index="debruijn", hash_name=idx.hash_name, saturate=sat())
        if isinstance(idx, QualityDeBruijnGraph):
            cfg["quality_codec"] = idx.codec.name
    elif isinstance(idx, hx.BimoleculeCountIndex):
        cfg.update(index="count", strands="bimolecule",
                   hash_name=idx.hash_name, saturate=sat())
    elif isinstance(idx, hx.CountIndex):
        cfg.update(index="count", hash_name=idx.hash_name, saturate=sat())
    elif isinstance(idx, vx.KmerValueIndex):
        cfg.update(index="value", hash_name=idx.hash_name,
                   reduce=idx.reduce, id_kind=idx.id_kind)
    elif isinstance(idx, vx.SortedKmerValueIndex):
        cfg.update(index="value", distribution="range", reduce=idx.reduce,
                   id_kind=idx.id_kind)
    elif isinstance(idx, hx.PositionIndex):
        cfg.update(index="posqual" if idx.with_quality else "position",
                   hash_name=idx.hash_name, id_kind=idx.id_kind)
    elif isinstance(idx, sx.SortedCountIndex):
        cfg.update(index="count", distribution="range", saturate=sat())
    elif isinstance(idx, sx.SortedPositionIndex):
        cfg.update(index="posqual" if idx.with_quality else "position",
                   distribution="range", id_kind=idx.id_kind)
    else:
        raise TypeError(f"unsupported index type {type(idx).__name__}")
    if cfg["index"] == "posqual":
        cfg["quality_codec"] = idx.codec.name
    return cfg


def _store_of(idx):
    """The stacked store a checkpoint holds: a run-list index's one run."""
    return idx.runs[0] if isinstance(idx, hx._RunListIndex) else idx.store


def save_index(idx, path) -> None:
    """Write a sharded checkpoint of `idx` into directory `path`: one
    ``shard_<s>.pt`` per shard (and ``splitters.pt`` for the sorted
    family), then ``kmerind_meta.json`` — written last, so a complete meta
    file means a complete checkpoint."""
    idx._checkpoint_prepare()
    path = pathlib.Path(path)
    path.mkdir(parents=True, exist_ok=True)
    store = _store_of(idx)
    lo, _ = idx.mesh.shard_range
    for s in range(idx.mesh.p_local):
        torch.save({f.name: getattr(store, f.name)[s].to("cpu", copy=True)
                    for f in dataclasses.fields(store)},
                   path / f"shard_{lo + s}.pt")
    idx.mesh.barrier()
    if idx.mesh.rank == 0:
        if getattr(idx, "splitters", None) is not None:
            torch.save(idx.splitters.to("cpu", copy=True),
                       path / "splitters.pt")
        meta = {"package": _PACKAGE, "format": 1, "config": _config_of(idx),
                "nparts": idx.nparts,
                "quality_graph": isinstance(idx, QualityDeBruijnGraph)}
        (path / _META).write_text(json.dumps(meta))
    idx.mesh.barrier()


def saved_nparts(path) -> int:
    """The shard count of a `save_index` checkpoint."""
    return json.loads((pathlib.Path(path) / _META).read_text())["nparts"]


def load_index(path, device="cuda", nparts: int | None = None, mesh=None):
    """Rebuild an index from `save_index` output on `device` — or over
    `mesh`, each rank reading its own shards' files (a collective).
    `nparts`, if given, must equal the checkpoint's shard count, and so
    must the mesh's (use the npz save / load to change it)."""
    path = pathlib.Path(path)
    meta = json.loads((path / _META).read_text())
    if meta.get("package") != _PACKAGE:
        raise ValueError(f"{path} is not a {_PACKAGE} checkpoint (the JAX "
                         "package's Orbax checkpoints do not load here; its "
                         "npz files do)")
    p = meta["nparts"]
    if mesh is not None:
        nparts = mesh.nparts
    if nparts is not None and nparts != p:
        raise ValueError(
            f"checkpoint has {p} shards, not {nparts}; use the npz save / "
            "load to change the shard count (it re-inserts and re-shards)")
    cfg = dict(meta["config"])
    if cfg.get("saturate", 0) == 0:
        cfg.pop("saturate", None)
    if meta.get("quality_graph"):
        c = IndexConfig(**cfg)
        idx = QualityDeBruijnGraph(c.spec(), device, canonical=c.canonical,
                                   nparts=p, hash_name=c.hash_name,
                                   saturate=c.saturate,
                                   codec=quality.by_name(c.quality_codec),
                                   mesh=mesh)
    else:
        idx = IndexConfig(**cfg).make_index(device=device, nparts=p,
                                            mesh=mesh)
    lo, hi = idx.mesh.shard_range
    shards = [torch.load(path / f"shard_{s}.pt", map_location=idx.device,
                         weights_only=True) for s in range(lo, hi)]
    store = type(_store_of(idx))(**{
        name: st.stack([sh[name] for sh in shards]) for name in shards[0]})
    if isinstance(idx, hx._RunListIndex):
        return idx.adopt_runs([store])
    idx.store = store
    if (path / "splitters.pt").exists():
        idx.splitters = torch.load(path / "splitters.pt",
                                   map_location=idx.device, weights_only=True)
    if isinstance(store, st.MultiStore):
        idx._has_q |= bool(idx.mesh.all_max(int((store.val_q != 0).any())))
    return idx
