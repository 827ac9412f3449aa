"""State carried across: a JAX count index's runs -> a port CountIndex.

The JAX package shards its count index over a mesh: each run is a
``RunCountStore`` with a leading shard axis.  Sharding does not change
counts (every key lives on one shard), so one port run per (JAX run,
shard) holds the same rows and answers the same queries on one device.
"""

from __future__ import annotations

import numpy as np
import torch

from ..kmer import KmerSpec
from ..ops.keys import from_numpy_u32
from .api import CountIndex
from .store import RunCountStore

__all__ = ["count_index_from_runs"]


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
