"""Per-shard index steps of the hash-partitioned indexes: the run-layout
count map and the multimap.

The port of ``kmerind_tpu.index.distributed``: each ``make_*_step``
factory there returns a jitted ``shard_map`` program; here each step is a
plain function (``*_step``, same stem) over stacked [p, ...] shard tensors
on one device, looping over the shards between exchanges
(``parallel/distribute.py``).  Every key is owned by shard
``owner_from_hash(hash(key), p)`` (KeyToRank,
distributed_densehash_map.hpp:148-171); inserts and queries ship tuples to
their owners, run the local store op, and queries route the replies back in
the original order.  Steps that exchange return the exchange's overflow
(the largest bucket excess; the caller retries with larger buckets).  The
index classes in ``api.py`` hold the stores and orchestrate.
"""

from __future__ import annotations

import torch

from ..io.kmer_parsers import DeviceBases, extract_tuples
from ..ops import hashing, sortops
from ..ops.keys import SENTINEL
from ..parallel import distribute as dist
from ..quality import ILLUMINA18
from . import store as st

__all__ = ["owners_for", "run_ingest_step", "run_insert_step",
           "run_adopt_step", "run_stats_step", "run_compact_step",
           "run_aux_step", "runs_count_query_step", "runs_erase_step",
           "run_filter_step", "run_select_step", "run_histogram_step",
           "run_merge_pair_step", "count_filter_step", "count_select_step",
           "histogram_step",
           "multi_insert_step", "multi_aux_step", "multi_ingest_step",
           "multi_merge_step", "unique_size_step", "concat_pending",
           "multi_count_routed", "multi_find_routed", "multi_erase_routed",
           "multi_filter_step", "multi_select_step"]


def owners_for(words: torch.Tensor, nparts: int, hash_name: str = "murmur",
               seed: int = 42) -> torch.Tensor | None:
    """Destination shard per key row [..., w] (KeyToRank): the owner map of
    the named hash (``ops/hashing.py``).  None with one shard, where every
    row is owned by shard 0."""
    if nparts == 1:
        return None
    return hashing.owner_from_hash(
        hashing.HASHES[hash_name](words, seed), nparts)


# ------------------------------------------------------- run-layout count map
def run_ingest_step(bases: DeviceBases, spec, canonical, nparts: int = 1,
                    capacity: int | None = None, hash_name: str = "murmur"):
    """Per-base tensors [p, L] -> (sorted_words int32[p, w, n],
    weights int32[p, n], overflow): extraction, owner exchange, local sort.
    Each shard's output is a sorted UNIT run: weight 1 per live row,
    sentinel keys with weight 0 after them."""
    tups = [extract_tuples(bases.shard(s), spec, canonical=canonical)
            for s in range(bases.codes.shape[0])]
    words = st.stack([t.words for t in tups])
    owner = owners_for(words, nparts, hash_name)
    (rw,), rvalid, route = dist.distribute(
        (words,), owner, st.stack([t.valid for t in tups]), nparts, capacity)
    cols, weights = [], []
    for s in range(nparts):
        s_words, _, s_valid = sortops.sort_rows(
            rw[s], (), rvalid[s], is_stable=False,
            sentinel_ok=spec.sentinel_safe, as_cols=True)
        if not spec.sentinel_safe:
            # flag-mode tails keep their key bits: force the sentinel so the
            # run invariant (sorted including padding) holds
            s_words = torch.where(s_valid[None, :], s_words, SENTINEL)
        cols.append(s_words)
        weights.append(s_valid.to(torch.int32))
    return st.stack(cols), st.stack(weights), route.overflow


def run_insert_step(words, weights, valid, nparts: int,
                    capacity: int | None, hash_name: str = "murmur"):
    """Explicit (key, weight) rows [p, m, w] / [p, m] (valid [p, m]): route
    each to its owner, then one sort per shard with the weights as its
    payload.  Returns (sorted_words int32[p, w, n], weights int32[p, n],
    overflow): a weighted run per shard, sentinel keys of weight 0 after
    the valid rows."""
    owner = owners_for(words, nparts, hash_name)
    (rw, rwt), rvalid, route = dist.distribute((words, weights), owner,
                                               valid, nparts, capacity)
    cols, wts = [], []
    for s in range(nparts):
        s_words, (s_wt,), s_valid = sortops.sort_rows(
            rw[s], (rwt[s],), rvalid[s], is_stable=False, as_cols=True)
        cols.append(torch.where(s_valid[None, :], s_words, SENTINEL))
        wts.append(torch.where(s_valid, s_wt, 0))
    return st.stack(cols), st.stack(wts), route.overflow


def run_adopt_step(words: torch.Tensor, weights: torch.Tensor,
                   unit: bool = False) -> st.RunCountStore:
    """Adopt a sorted weighted run per shard (words [p, w, n], weights
    [p, n]) as a stacked store; unit=True (file-ingest output) takes the
    closed-form csum, no prefix sum."""
    adopt = st.run_from_sorted_unit if unit else st.run_from_sorted
    return st.stack_run_stores([adopt(words[s], weights[s])
                                for s in range(words.shape[0])])


def run_stats_step(store: st.RunCountStore) -> list[int]:
    """Distinct live keys per shard (the size surface)."""
    return [int(st.run_distinct(store.shard(s)))
            for s in range(store.keys.shape[0])]


def _shards(store):
    return [store.shard(s) for s in range(store.keys.shape[0])]


def run_compact_step(store: st.RunCountStore, new_cap: int,
                     saturate: int | None = None):
    """(compacted stacked store, the largest shard overflow) — see
    store.run_compact."""
    out = [st.run_compact(sh, new_cap, saturate) for sh in _shards(store)]
    return (st.stack_run_stores([o[0] for o in out]),
            max(o[1] for o in out))


def run_filter_step(store: st.RunCountStore, keep_pred,
                    saturate: int | None = None):
    """erase_if / filter over every shard of one run (store.run_filter):
    (new stacked store, distinct keys removed)."""
    out = [st.run_filter(sh, keep_pred, saturate) for sh in _shards(store)]
    return (st.stack_run_stores([o[0] for o in out]),
            int(sum(o[1] for o in out)))


def run_select_step(store: st.RunCountStore, pred,
                    saturate: int | None = None) -> list:
    """Per shard, (keys int32[t, w], counts) of the entries satisfying
    pred (store.run_select)."""
    return [st.run_select(sh, pred, saturate) for sh in _shards(store)]


def run_histogram_step(store: st.RunCountStore, nbins: int,
                       saturate: int | None = None) -> torch.Tensor:
    """int64[nbins] spectrum over all shards: every key lives on one shard,
    so the shards' spectra sum."""
    return sum(st.run_histogram(sh, nbins, saturate) for sh in _shards(store))


def run_aux_step(store: st.RunCountStore) -> list:
    """Each shard's query-aux metadata of one run (store.run_query_aux)."""
    return [st.run_query_aux(store.shard(s))
            for s in range(store.keys.shape[0])]


def runs_count_query_step(queries: torch.Tensor, qvalid: torch.Tensor, aux,
                          nparts: int = 1, capacity: int | None = None,
                          hash_name: str = "murmur",
                          saturate: int | None = None):
    """Count query over a list of runs through their cached aux metadata
    (per run, per shard): route once, look up in each run, sum (clamped at
    `saturate`), reply.  queries [p, m, w], qvalid [p, m].  Returns (counts
    int32[p, m], overflow)."""
    owner = owners_for(queries, nparts, hash_name)
    (rq,), rvalid, route = dist.distribute((queries,), owner, qvalid, nparts,
                                           capacity)
    local = []
    for s in range(nparts):
        total = sum(st.run_lookup_aux(ext, bstart, rq[s])
                    for ext, bstart in (run[s] for run in aux))
        if saturate is not None:
            total = total.clamp(max=saturate)
        local.append(torch.where(rvalid[s], total, 0))
    (back,) = dist.undistribute((st.stack(local),), route, nparts, capacity)
    return back, route.overflow


def runs_erase_step(runs, aux, queries: torch.Tensor, qvalid: torch.Tensor,
                    nparts: int = 1, capacity: int | None = None,
                    hash_name: str = "murmur"):
    """Erase over a list of runs: route the query rows [p, m, w] (qvalid
    [p, m]) to their owners, zero every matching row of every run
    (store.run_erase_cover, one K3 rebuild a run) and count the DISTINCT
    keys that had a positive count: a key queried twice, or present in
    several runs, counts once.  aux: each run's cached per-shard aux.
    Returns (new runs, keys erased, overflow)."""
    owner = owners_for(queries, nparts, hash_name)
    (rq,), rvalid, route = dist.distribute((queries,), owner, qvalid, nparts,
                                           capacity)
    shards, nerased = [], 0
    for s in range(nparts):
        total = sum(st.run_lookup_aux(ext, bstart, rq[s])
                    for ext, bstart in (run[s] for run in aux))
        had = rvalid[s] & (total > 0)
        shards.append([st.run_erase_cover(run.shard(s), *run_aux[s], rq[s],
                                          rvalid[s])
                       for run, run_aux in zip(runs, aux)])
        s_words, _, s_had = sortops.sort_rows(rq[s], (), had,
                                              is_stable=False)
        nerased += sortops.compact_runs(s_words, s_had)[3]
    new_runs = [st.stack_run_stores([shards[s][r] for s in range(nparts)])
                for r in range(len(runs))]
    return new_runs, int(nerased), route.overflow


def run_merge_pair_step(a: st.RunCountStore, b: st.RunCountStore,
                        unit: bool = False) -> st.RunCountStore:
    """Merge two run stores shard by shard (the LSM level merge):
    keys-only with closed-form weights for two UNIT runs, else weighted."""
    out = []
    for s in range(a.keys.shape[0]):
        sa, sb = a.shard(s), b.shard(s)
        out.append(st.run_merge_unit(sa, sb) if unit
                   else st.run_merge(sa, sb.keys, sb.weights))
    return st.stack_run_stores(out)


# ------------------------------------------------- unique-key count store
def count_filter_step(store: st.CountStore, keep_pred):
    """erase_if / filter over a CountStore's shards: entries whose (key,
    count) fails keep_pred(keys int64[cap, w], counts int32[cap]) ->
    bool[cap] are removed.  Returns (new stacked store, entries
    removed)."""
    out = [st.count_filter(sh, keep_pred) for sh in _shards(store)]
    return (st.stack_count_stores([o[0] for o in out]),
            int(sum(o[1] for o in out)))


def count_select_step(store: st.CountStore, pred) -> list:
    """Per shard, (keys int32[t, w], counts int32[t]) of the live entries
    satisfying pred (store.count_select), in key order."""
    return [st.count_select(sh, pred) for sh in _shards(store)]


def histogram_step(store: st.CountStore, nbins: int) -> torch.Tensor:
    """int64[nbins] spectrum of a CountStore over all shards."""
    return sum(st.count_histogram(sh, nbins) for sh in _shards(store))


# ----------------------------------------------------------------- multimap
def multi_ingest_step(bases: DeviceBases, spec, canonical, nparts: int,
                      capacity: int | None, hash_name: str = "murmur",
                      with_quality: bool = False, codec=ILLUMINA18):
    """Per-base tensors [p, L] -> (words [p, n, w], id_hi [p, n],
    id_lo [p, n], qual float32[p, n] or None, valid [p, n], overflow):
    extraction and the owner exchange of (k-mer, id[, quality]) tuples
    without the store merge — the lazy half of the position-index insert.
    qual is None without `with_quality`."""
    tups = [extract_tuples(bases.shard(s), spec, canonical=canonical,
                           with_quality=with_quality, codec=codec)
            for s in range(bases.codes.shape[0])]
    cols = [st.stack([getattr(t, f) for t in tups])
            for f in ("words", "id_hi", "id_lo")]
    if with_quality:
        cols.append(st.stack([t.qual for t in tups]))
    owner = owners_for(cols[0], nparts, hash_name)
    out, rvalid, route = dist.distribute(
        tuple(cols), owner, st.stack([t.valid for t in tups]), nparts,
        capacity)
    rq = out[3] if with_quality else None
    return out[0], out[1], out[2], rq, rvalid, route.overflow


def multi_merge_step(store: st.MultiStore, words, hi, lo, q, valid,
                     sentinel_ok: bool):
    """Deferred merge of owner-resident tuples into each shard's store:
    words [p, n, w], hi / lo / valid [p, n], q float32[p, n] or None (the
    store carries no quality).  Every shard flushes through the K2 merge
    (any key width), flagged where keys may equal the sentinel.  Returns
    (new stacked store, the largest shard overflow)."""
    flush = (st.multi_merge_flush if sentinel_ok
             else st.multi_merge_flush_flagged)
    out = [flush(store.shard(s), words[s], hi[s], lo[s], valid[s],
                 None if q is None else q[s])
           for s in range(words.shape[0])]
    return (st.stack_multi_stores([o[0] for o in out]),
            max(int(o[1]) for o in out))


def multi_insert_step(store: st.MultiStore, words, hi, lo, q, valid,
                      nparts: int, capacity: int | None,
                      hash_name: str = "murmur"):
    """Explicit (key, id, quality) inserts [p, m, ...]: route to owners,
    then one stable sort per shard (store.multi_insert).  Returns
    (new store, route overflow, store overflow)."""
    owner = owners_for(words, nparts, hash_name)
    (rw, rhi, rlo, rq), rvalid, route = dist.distribute(
        (words, hi, lo, q), owner, valid, nparts, capacity)
    out = [st.multi_insert(store.shard(s), rw[s], rhi[s], rlo[s], rvalid[s],
                           rq[s]) for s in range(nparts)]
    return (st.stack_multi_stores([o[0] for o in out]), route.overflow,
            max(int(o[1]) for o in out))


def multi_aux_step(store: st.MultiStore) -> list:
    """Each shard's query-aux metadata (store.multi_query_aux)."""
    return [st.multi_query_aux(store.shard(s))
            for s in range(store.keys.shape[0])]


def _ranges(store, aux, rq, rvalid, nparts):
    """Per shard (lo, hi) of the received queries; invalid slots get the
    empty range."""
    out = []
    for s in range(nparts):
        lo, hi = st.multi_lookup_ranges_aux(store.shard(s), *aux[s], rq[s])
        out.append((lo, torch.where(rvalid[s], hi, lo)))
    return out


def multi_count_routed(store, aux, queries, qvalid, owner, nparts, capacity):
    """Multiplicity per query [p, m] under a given owner map: (counts
    int64[p, m], overflow)."""
    (rq,), rvalid, route = dist.distribute((queries,), owner, qvalid, nparts,
                                           capacity)
    local = st.stack([hi - lo for lo, hi in
                      _ranges(store, aux, rq, rvalid, nparts)])
    (back,) = dist.undistribute((local,), route, nparts, capacity)
    return back, route.overflow


def multi_find_routed(store, aux, queries, qvalid, owner, nparts, capacity,
                      max_per_query: int):
    """Payload lists per query [p, m] under a given owner map: (id_hi,
    id_lo, qual, mask — each [p, m, max_per_query] — counts int64[p, m]
    (the TRUE multiplicity, so callers detect truncation), overflow)."""
    (rq,), rvalid, route = dist.distribute((queries,), owner, qvalid, nparts,
                                           capacity)
    parts, counts = [], []
    for s, (lo, hi) in enumerate(_ranges(store, aux, rq, rvalid, nparts)):
        parts.append(st.multi_gather(store.shard(s), lo, hi, max_per_query))
        counts.append(hi - lo)
    back = dist.undistribute(
        tuple(st.stack([p[i] for p in parts]) for i in range(4))
        + (st.stack(counts),), route, nparts, capacity)
    return (*back, route.overflow)


def multi_erase_routed(store, aux, keys, valid, owner, nparts, capacity,
                       pred=None):
    """Erase every pair of the key rows [p, m, w] under a given owner map
    (the hash's or the splitters'), or with `pred` only the pairs that
    satisfy it (the keyed erase_if, store.multi_erase): (new store, pairs
    erased, overflow)."""
    (rk,), rvalid, route = dist.distribute((keys,), owner, valid, nparts,
                                           capacity)
    out = [st.multi_erase(store.shard(s), rk[s], rvalid[s], aux[s], pred)
           for s in range(nparts)]
    return (st.stack_multi_stores([o[0] for o in out]),
            sum(int(o[1]) for o in out), route.overflow)


def multi_filter_step(store: st.MultiStore, keep_pred):
    """erase_if / filter over every pair: pairs failing keep_pred(keys
    int64[cap, w], id_hi int64[cap], id_lo int64[cap], qual float32[cap])
    -> bool[cap] are removed.  Returns (new stacked store, pairs
    removed)."""
    out = [st.multi_filter(sh, keep_pred) for sh in _shards(store)]
    return (st.stack_multi_stores([o[0] for o in out]),
            int(sum(o[1] for o in out)))


def multi_select_step(store: st.MultiStore, pred) -> list:
    """Per shard, (keys int32[t, w], matches int64[t]) of the keys with at
    least one pair satisfying pred (store.multi_select)."""
    return [st.multi_select(sh, pred) for sh in _shards(store)]


def unique_size_step(store: st.MultiStore) -> int:
    """Distinct keys over all shards (map_base::unique_size): each key
    lives on one shard, so per-shard counts sum."""
    return sum(int(st.multi_distinct(store.shard(s)))
               for s in range(store.keys.shape[0]))


def concat_pending(parts, with_q: bool):
    """Concatenate pending (words, hi, lo, q, valid) [p, n_i, ...] tuples
    along the row axis.  q: None unless `with_q`; zeros for a part that
    carries none."""
    cat = lambda i: torch.cat([t[i] for t in parts], dim=1)  # noqa: E731
    q = None
    if with_q:
        q = torch.cat([t[4].new_zeros(t[4].shape, dtype=torch.float32)
                       if t[3] is None else t[3] for t in parts], dim=1)
    return cat(0), cat(1), cat(2), q, cat(4)
