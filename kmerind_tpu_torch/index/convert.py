"""State carried across from the JAX package's indexes.

* A JAX count index's runs -> a port CountIndex.  The JAX package shards
  its count index over a mesh: each run is a ``RunCountStore`` with a
  leading shard axis.  Sharding does not change counts (every key lives on
  one shard), so one port run per (JAX run, shard) holds the same rows and
  answers the same queries on one device.
* A JAX SortedCountIndex's store and splitters -> a port SortedCountIndex
  of as many shards, stacked on one device: the same rows on the same
  shards, routed by the same splitters.
"""

from __future__ import annotations

import numpy as np
import torch

from ..kmer import KmerSpec
from ..ops.keys import from_numpy_u32
from .api import CountIndex
from .sorted_api import SortedCountIndex
from .store import CountStore, RunCountStore

__all__ = ["count_index_from_runs", "sorted_count_index_from_state"]


def count_index_from_runs(runs, spec: KmerSpec, device, canonical=True,
                          max_runs: int = 8) -> CountIndex:
    """Port CountIndex holding the rows of a JAX count index's runs.

    runs: iterable of (keys uint32[p, w, cap], weights int32[p, cap],
    csum int32[p, cap + 1]) numpy arrays — ``np.asarray`` of each JAX
    run's fields.  Every shard of every run becomes one port run; the
    `max_runs` LSM bound then merges the smallest until it holds."""
    stores = []
    for keys, weights, csum in runs:
        keys = np.asarray(keys, dtype=np.uint32)
        for s in range(keys.shape[0]):
            stores.append(RunCountStore(
                keys=from_numpy_u32(keys[s], device),
                weights=torch.from_numpy(
                    np.array(weights[s], np.int32)).to(device),
                csum=torch.from_numpy(np.array(csum[s], np.int32)).to(device)))
    idx = CountIndex(spec, device=device, canonical=canonical,
                     max_runs=max_runs)
    return idx.adopt_runs(stores)


def sorted_count_index_from_state(keys, counts, sizes, splitters,
                                  spec: KmerSpec, device, canonical=True,
                                  saturate: int | None = None
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
