"""State carried across from the JAX package's indexes.

* A JAX count index's runs -> a port CountIndex.  The JAX package shards
  its count index over a mesh: each run is a ``RunCountStore`` with a
  leading shard axis.  Sharding does not change counts (every key lives on
  one shard), so one port run per (JAX run, shard) holds the same rows and
  answers the same queries in one shard.
* A JAX SortedCountIndex's store and splitters -> a port SortedCountIndex
  of as many shards, stacked on one device: the same rows on the same
  shards, routed by the same splitters.
* A JAX PositionIndex / PositionQualityIndex / SortedPositionIndex state
  -> the port's index of the same kind and as many shards: the same pairs
  on the same shards, routed by the same owner hash (digest-equal, see
  ``ops/hashing.py``) or the same splitters.
* A JAX DeBruijnGraph / QualityDeBruijnGraph's run -> the port's graph of
  as many shards: the same rows, weights included, on the same shards.
* A JAX BimoleculeCountIndex's store -> the port's of as many shards: the
  same rows with their occurrence ids and strands, so every stored
  orientation carries over.
* A JAX KmerValueIndex / SortedKmerValueIndex's store (and splitters) ->
  the port's value map of as many shards, the same entries on the same
  shards.

Every function takes the state as numpy arrays.
"""

from __future__ import annotations

import numpy as np
import torch

from ..debruijn import DeBruijnGraph, QualityDeBruijnGraph
from ..kmer import KmerSpec
from ..ops.keys import from_numpy_u32
from . import distributed as dx
from .api import (BimoleculeCountIndex, CountIndex, PositionIndex,
                  PositionQualityIndex)
from .sorted_api import (SortedCountIndex, SortedPositionIndex,
                         SortedPositionQualityIndex)
from .store import (CountStore, KVStore, MultiStore, RunCountStore,
                    stack_run_stores)
from .value_api import KmerValueIndex, SortedKmerValueIndex

__all__ = ["count_index_from_runs", "sorted_count_index_from_state",
           "position_index_from_state", "sorted_position_index_from_state",
           "debruijn_graph_from_state", "bimolecule_index_from_state",
           "value_index_from_state"]


def count_index_from_runs(runs, spec: KmerSpec, device="cuda",
                          canonical=True, max_runs: int = 8) -> CountIndex:
    """Port CountIndex (one shard) holding the rows of a JAX count index's
    runs.

    runs: iterable of (keys uint32[p, w, cap], weights int32[p, cap],
    csum int32[p, cap + 1]) numpy arrays — ``np.asarray`` of each JAX
    run's fields.  Every shard of every run becomes one port run; the
    `max_runs` LSM bound then merges the smallest until it holds."""
    stores = []
    for keys, weights, csum in runs:
        keys = np.asarray(keys, dtype=np.uint32)
        for s in range(keys.shape[0]):
            stores.append(stack_run_stores([RunCountStore(
                keys=from_numpy_u32(keys[s], device),
                weights=torch.from_numpy(
                    np.array(weights[s], np.int32)).to(device),
                csum=torch.from_numpy(
                    np.array(csum[s], np.int32)).to(device))]))
    idx = CountIndex(spec, device=device, canonical=canonical,
                     max_runs=max_runs)
    return idx.adopt_runs(stores)


def sorted_count_index_from_state(keys, counts, sizes, splitters,
                                  spec: KmerSpec, device="cuda",
                                  canonical=True, saturate: int | None = None
                                  ) -> SortedCountIndex:
    """Port SortedCountIndex holding a flushed JAX SortedCountIndex's state:
    keys uint32[p, cap, w], counts int32[p, cap], sizes int32[p] (the
    ``store`` fields) and splitters uint32[p, p-1, w] (one replicated row
    per shard), as numpy arrays."""
    keys = np.asarray(keys, dtype=np.uint32)
    idx = SortedCountIndex(spec, device, canonical=canonical,
                           saturate=saturate, nparts=keys.shape[0])
    idx.store = CountStore(
        keys=from_numpy_u32(keys, device),
        counts=torch.from_numpy(np.array(counts, np.int32)).to(device),
        size=torch.from_numpy(np.array(sizes, np.int32)).to(device))
    idx.splitters = from_numpy_u32(np.asarray(splitters)[0], device)
    return idx


def _multi_store(keys, val_hi, val_lo, val_q, sizes, device) -> MultiStore:
    """A stacked port MultiStore from a JAX MultiStore's fields (keys
    uint32[p, cap, w] row-major -> [p, w, cap]); rows past each shard's
    size become sentinels with zero payloads."""
    keys = np.asarray(keys, dtype=np.uint32)
    sizes = np.asarray(sizes, np.int32)
    live = np.arange(keys.shape[1])[None, :] < sizes[:, None]
    cols = np.where(live[:, None, :], keys.transpose(0, 2, 1), 0xFFFFFFFF)
    put = lambda a, dt: torch.from_numpy(  # noqa: E731
        np.where(live, np.asarray(a), 0).astype(dt)).to(device)
    store = MultiStore(
        keys=from_numpy_u32(cols, device),
        val_hi=put(np.asarray(val_hi, np.uint32).view(np.int32), np.int32),
        val_lo=put(np.asarray(val_lo, np.uint32).view(np.int32), np.int32),
        val_q=put(val_q, np.float32),
        size=torch.from_numpy(sizes.copy()).to(device))
    return store


def position_index_from_state(keys, val_hi, val_lo, val_q, sizes,
                              spec: KmerSpec, device="cuda", canonical=False,
                              with_quality: bool = False,
                              hash_name: str = "murmur",
                              id_kind: str = "short") -> PositionIndex:
    """Port PositionIndex (PositionQualityIndex with `with_quality`) of p
    shards holding a JAX PositionIndex's store: keys uint32[p, cap, w],
    val_hi / val_lo uint32[p, cap], val_q float32[p, cap], sizes int32[p]
    (``np.asarray`` of the ``store`` fields after a flush).  The JAX index
    must use the same `hash_name`."""
    cls = PositionQualityIndex if with_quality else PositionIndex
    idx = cls(spec, device, canonical=canonical, nparts=len(sizes),
              hash_name=hash_name, id_kind=id_kind)
    idx.store = _multi_store(keys, val_hi, val_lo, val_q, sizes, idx.device)
    idx._has_q = with_quality or bool(idx.store.val_q.any())
    return idx


def sorted_position_index_from_state(keys, val_hi, val_lo, val_q, sizes,
                                     splitters, spec: KmerSpec,
                                     device="cuda", canonical=False,
                                     with_quality: bool = False,
                                     id_kind: str = "short"
                                     ) -> SortedPositionIndex:
    """Port SortedPositionIndex (SortedPositionQualityIndex with
    `with_quality`) holding a flushed JAX SortedPositionIndex's store (as
    `position_index_from_state`) and splitters uint32[p, p-1, w]."""
    cls = SortedPositionQualityIndex if with_quality else SortedPositionIndex
    idx = cls(spec, device, canonical=canonical, nparts=len(sizes),
              id_kind=id_kind)
    idx.store = _multi_store(keys, val_hi, val_lo, val_q, sizes, idx.device)
    idx._has_q = with_quality or bool(idx.store.val_q.any())
    idx.splitters = from_numpy_u32(np.asarray(splitters)[0], idx.device)
    return idx


def debruijn_graph_from_state(keys, ebytes, weights, qsums=None, *,
                              spec: KmerSpec, device="cuda", canonical=True,
                              hash_name: str = "murmur",
                              saturate: int | None = None):
    """Port DeBruijnGraph (QualityDeBruijnGraph when `qsums` is given) of p
    shards holding the rows of one JAX graph run: keys uint32[p, w, cap]
    (sorted per shard, sentinel padded), ebytes int32[p, cap], weights
    int32[p, cap], qsums float32[p, cap] — ``np.asarray`` of a run's fields
    (``g.runs[0]`` after a consolidating call such as ``size()``).  Each
    shard's rows stay on their shard as one weighted run (the JAX graph
    must use the same `hash_name`), its counter table built at once."""
    keys = np.asarray(keys, dtype=np.uint32)
    cls = DeBruijnGraph if qsums is None else QualityDeBruijnGraph
    g = cls(spec, device, canonical=canonical, nparts=keys.shape[0],
            hash_name=hash_name, saturate=saturate)

    def put(a, dt):
        return torch.from_numpy(np.array(a, dt)).to(g.device)

    run = dx.run_vec_adopt_step(
        from_numpy_u32(keys, g.device), put(ebytes, np.int32),
        put(weights, np.int32),
        None if qsums is None else put(qsums, np.float32))
    return g.adopt_runs([run])


def bimolecule_index_from_state(keys, weights, rep_hi, rep_lo, rep_strand,
                                *, spec: KmerSpec, device="cuda",
                                hash_name: str = "murmur",
                                saturate: int | None = None
                                ) -> BimoleculeCountIndex:
    """Port BimoleculeCountIndex of p shards holding a JAX
    BimoleculeCountIndex's store: keys uint32[p, w, cap] (sorted per shard,
    sentinel padded), weights int32[p, cap], rep_hi / rep_lo / rep_strand
    uint32[p, cap] — ``np.asarray`` of the ``store`` fields after a
    consolidating call such as ``size()``.  Each shard's rows stay on their
    shard (the JAX index must use the same `hash_name`), the prefix sums
    rebuilt (K3)."""
    keys = np.asarray(keys, dtype=np.uint32)
    idx = BimoleculeCountIndex(spec, device, nparts=keys.shape[0],
                               hash_name=hash_name, saturate=saturate)
    run = dx.run_bimol_adopt_step(
        from_numpy_u32(keys, idx.device),
        torch.from_numpy(np.array(weights, np.int32)).to(idx.device),
        *(from_numpy_u32(np.asarray(a), idx.device)
          for a in (rep_hi, rep_lo, rep_strand)))
    return idx.adopt_runs([run])


def value_index_from_state(keys, val_hi, val_lo, sizes, splitters=None, *,
                           spec: KmerSpec, device="cuda", canonical=True,
                           reduce: str = "first", hash_name: str = "murmur",
                           id_kind: str = "short"):
    """Port value map of p shards holding a JAX value map's store: keys
    uint32[p, cap, w], val_hi / val_lo uint32[p, cap], sizes int32[p] (the
    ``store`` fields); with `splitters` (uint32[p, p-1, w], one replicated
    row per shard: a flushed SortedKmerValueIndex) a SortedKmerValueIndex
    routed by them, else a KmerValueIndex (the JAX index must use the same
    `hash_name`).  Rows past each shard's size become sentinels."""
    keys = np.asarray(keys, dtype=np.uint32)
    sizes = np.asarray(sizes, np.int32)
    p = keys.shape[0]
    if splitters is None:
        idx = KmerValueIndex(spec, device, canonical=canonical, nparts=p,
                             hash_name=hash_name, reduce=reduce,
                             id_kind=id_kind)
    else:
        idx = SortedKmerValueIndex(spec, device, canonical=canonical,
                                   nparts=p, reduce=reduce, id_kind=id_kind)
        idx.splitters = from_numpy_u32(np.asarray(splitters)[0], idx.device)
    live = np.arange(keys.shape[1])[None, :] < sizes[:, None]
    put = lambda a, fill: from_numpy_u32(  # noqa: E731
        np.where(live, np.asarray(a, np.uint32), fill), idx.device)
    idx.store = KVStore(
        keys=from_numpy_u32(np.where(live[..., None], keys, 0xFFFFFFFF),
                            idx.device),
        val_hi=put(val_hi, 0), val_lo=put(val_lo, 0),
        size=torch.from_numpy(sizes.copy()).to(idx.device))
    return idx
