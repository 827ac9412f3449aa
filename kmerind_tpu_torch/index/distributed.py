"""Per-shard index steps of the run-layout count map.

The port of the count-map steps of ``kmerind_tpu.index.distributed``: each
``make_*_step`` factory there returns a jitted ``shard_map`` program; here
each step is a plain function over one shard's tensors (``*_step``, same
stem), single-shard (`owners_for` with ``nparts == 1``).  The index classes
in ``api.py`` hold the run list and orchestrate.
"""

from __future__ import annotations

import torch

from ..io.kmer_parsers import DeviceBases, extract_tuples
from ..ops import sortops
from ..ops.keys import SENTINEL
from ..parallel import distribute as dist
from . import store as st

__all__ = ["owners_for", "run_ingest_step", "run_adopt_step",
           "run_stats_step", "run_compact_step", "run_aux_step",
           "runs_count_query_step", "run_merge_pair_step"]


def owners_for(words: torch.Tensor, nparts: int) -> torch.Tensor | None:
    """Destination shard per key row (KeyToRank); None with one shard,
    where every row is owned by shard 0."""
    if nparts == 1:
        return None
    raise NotImplementedError(
        "owner hashing for nparts > 1 is not ported yet: "
        "ROADMAP queue 1, item 4 (hashing)")


def run_ingest_step(bases: DeviceBases, spec, canonical, nparts: int = 1):
    """Per-base tensors -> (sorted_words int32[w, n], weights int32[n]):
    extraction + owner exchange + local sort.  The output is a sorted UNIT
    run: weight 1 per live row, sentinel keys with weight 0 after them."""
    tup = extract_tuples(bases, spec, canonical=canonical)
    owner = owners_for(tup.words, nparts)
    (rw,), rvalid, _ = dist.distribute((tup.words,), owner, tup.valid, nparts)
    s_words, _, s_valid = sortops.sort_rows(
        rw, (), rvalid, is_stable=False, sentinel_ok=spec.sentinel_safe,
        as_cols=True)
    if not spec.sentinel_safe:
        # flag-mode tails keep their key bits: force the sentinel so the
        # run invariant (sorted including padding) holds
        s_words = torch.where(s_valid[None, :], s_words, SENTINEL)
    return s_words, s_valid.to(torch.int32)


def run_adopt_step(words: torch.Tensor, weights: torch.Tensor,
                   unit: bool = False) -> st.RunCountStore:
    """Adopt a sorted weighted run as a store; unit=True (file-ingest
    output) takes the closed-form csum, no prefix sum."""
    if unit:
        return st.run_from_sorted_unit(words, weights)
    return st.run_from_sorted(words, weights)


def run_stats_step(store: st.RunCountStore) -> int:
    """Distinct live keys of the shard (the size surface)."""
    return int(st.run_distinct(store))


def run_compact_step(store: st.RunCountStore, new_cap: int):
    """(compacted store, overflow) — see store.run_compact."""
    return st.run_compact(store, new_cap)


def run_aux_step(store: st.RunCountStore):
    """One run's query-aux metadata (store.run_query_aux)."""
    return st.run_query_aux(store)


def runs_count_query_step(queries: torch.Tensor, aux,
                          nparts: int = 1) -> torch.Tensor:
    """Count query over a list of runs through their cached aux metadata:
    route once, look up in each run, sum, reply.  int32[m]."""
    owner = owners_for(queries, nparts)
    (rq,), _, route = dist.distribute((queries,), owner, None, nparts)
    total = None
    for ext, bstart in aux:
        part = st.run_lookup_aux(ext, bstart, rq)
        total = part if total is None else total + part
    (back,) = dist.undistribute((total,), route, nparts)
    return back


def run_merge_pair_step(a: st.RunCountStore, b: st.RunCountStore,
                        unit: bool = False) -> st.RunCountStore:
    """Merge two run stores (the LSM level merge): keys-only with
    closed-form weights for two UNIT runs, else weighted."""
    if unit:
        return st.run_merge_unit(a, b)
    return st.run_merge(a, b.keys, b.weights)
