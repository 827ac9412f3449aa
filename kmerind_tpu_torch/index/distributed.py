"""Per-shard index steps of the hash-partitioned indexes: the run-layout
count map (and its Bimolecule twin), the multimap, the de Bruijn graphs'
node stores and the unique-key value map.

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
from ..ops import hashing, kernels, packing, sortops
from ..ops.keys import SENTINEL
from ..parallel import distribute as dist
from ..quality import ILLUMINA18, window_quality
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
           "multi_filter_step", "multi_select_step",
           "debruijn_ingest_step", "run_vec_load_step", "run_vec_adopt_step",
           "run_vec_merge_pair_step", "run_vec_table_step",
           "run_vec_stats_step", "run_vec_compact_step", "run_vec_aux_step",
           "runs_vec_query_step", "run_vec_export_step",
           "bimol_ingest_step", "bimol_tuples_step", "run_bimol_adopt_step",
           "run_bimol_merge_pair_step", "run_bimol_compact_step",
           "run_bimol_strands_step", "run_bimol_find_step",
           "run_bimol_export_step", "kv_insert_step", "kv_ingest_step",
           "kv_find_routed", "kv_erase_routed", "kv_filter_step",
           "kv_select_step"]


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
    """erase_if / filter over every shard of one run (store.run_filter; a
    Bimolecule run keeps its representatives): (new stacked store,
    distinct keys removed)."""
    out = [st.run_filter(sh, keep_pred, saturate) for sh in _shards(store)]
    return (st.stack_stores([o[0] for o in out]),
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
    new_runs = [st.stack_stores([shards[s][r] for s in range(nparts)])
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


# ------------------------------------------------------ de Bruijn node stores
def _sorted_edge_runs(rw, pays, rvalid, spec, nparts: int):
    """Each shard's routed (key, payload columns) rows ([p, n, ...]) sorted
    into an adoptable run: (key columns [p, w, n], sentinel keys after the
    valid rows; the payloads [p, n] in the same order, 0 on the dead rows;
    the valid flags [p, n])."""
    cols, out, valid = [], [[] for _ in pays], []
    for s in range(nparts):
        c, s_pays, s_valid = sortops.sort_rows(
            rw[s], tuple(p[s] for p in pays), rvalid[s], is_stable=False,
            sentinel_ok=spec.sentinel_safe, as_cols=True)
        if not spec.sentinel_safe:
            c = torch.where(s_valid[None, :], c, SENTINEL)
        cols.append(c)
        valid.append(s_valid)
        for o, x in zip(out, s_pays):
            o.append(torch.where(s_valid, x, 0))
    return st.stack(cols), [st.stack(o) for o in out], st.stack(valid)


def debruijn_ingest_step(bases: DeviceBases, spec, canonical: bool,
                         nparts: int, capacity: int | None,
                         hash_name: str = "murmur", raw: bool = True,
                         codec=None):
    """De Bruijn ingest of per-base tensors [p, L] (the JAX package's
    ``make_debruijn_run_ingest_step`` and its quality twin): per shard,
    the k-mer codes (raw=True: the k-mer alphabet's LUT gathered over the
    raw ASCII bytes, so 'N' reads as code 0 under DNA and the window stays
    valid), K1 (`kernels.extract_canonical`; the forward k-mers when not
    canonical), `window_valid & owned`, the edge bytes (DNA16 nibbles of
    the raw bytes, 'N' -> 0xF) reverse-complemented where K1 took the
    reverse strand and, with a `codec` (the quality graph), each window's
    quality; then the owner exchange with the edge byte (and the quality
    bits) as payload columns and one sort per shard.

    Returns (key columns int32[p, w, n], edge bytes int32[p, n], weights
    int32[p, n], quality sums float32[p, n] or None, overflow): a sorted
    UNIT run per shard."""
    # imported here: the debruijn package imports the index modules
    from ..debruijn.edges import edge_bytes_for_windows, revcomp_edge_byte
    lut = (torch.tensor(spec.alphabet.from_ascii, device=bases.codes.device)
           if raw else None)
    words, edges, quals, wvalid = [], [], [], []
    for s in range(bases.codes.shape[0]):
        b = bases.shard(s)
        kcodes = lut[b.codes.to(torch.int64)] if raw else b.codes
        if canonical:
            w, was_rc = kernels.extract_canonical(kcodes, spec)
        else:
            w = packing.extract_kmers(kcodes, spec)
            was_rc = torch.zeros(kcodes.shape[0], dtype=torch.bool,
                                 device=kcodes.device)
        e = edge_bytes_for_windows(b.codes, b.valid, b.seg_id, spec.k,
                                   spec.alphabet, raw=raw)
        words.append(w)
        edges.append(torch.where(was_rc, revcomp_edge_byte(e), e)
                     .to(torch.int32))
        wvalid.append(packing.window_valid(b.valid, b.seg_id, spec.k)
                      & b.owned)
        if codec is not None:
            quals.append(window_quality(b.qual, spec.k, codec).view(
                torch.int32))
    words = st.stack(words)
    cols = (words, st.stack(edges)) + ((st.stack(quals),) if quals else ())
    owner = owners_for(words, nparts, hash_name)
    (rw, *pays), rvalid, route = dist.distribute(
        cols, owner, st.stack(wvalid), nparts, capacity)
    kc, pays, valid = _sorted_edge_runs(rw, pays, rvalid, spec, nparts)
    qs = pays[1].view(torch.float32) if quals else None
    return kc, pays[0], valid.to(torch.int32), qs, route.overflow


def run_vec_load_step(words, ebytes, weights, qsums, valid, nparts: int,
                      capacity: int | None, spec, hash_name: str = "murmur"):
    """Explicit (node, edge byte, weight[, quality sum]) rows [p, m, ...]
    (a saved graph's rows): route to their owners and sort each shard's
    into an adoptable WEIGHTED run.  Returns (key columns [p, w, n], edge
    bytes [p, n], weights [p, n], quality sums [p, n] or None,
    overflow)."""
    cols = (words, ebytes, weights) + (
        () if qsums is None else (qsums.to(torch.float32).view(torch.int32),))
    owner = owners_for(words, nparts, hash_name)
    (rw, *pays), rvalid, route = dist.distribute(cols, owner, valid, nparts,
                                                 capacity)
    kc, pays, _ = _sorted_edge_runs(rw, pays, rvalid, spec, nparts)
    qs = pays[2].view(torch.float32) if qsums is not None else None
    return kc, pays[0], pays[1], qs, route.overflow


def run_vec_adopt_step(words, ebytes, weights, qsums=None,
                       unit: bool = False, table: bool = True):
    """Adopt a sorted edge run per shard (words [p, w, n], the rest [p, n];
    qsums for the quality graph) as a stacked store: unit=True (file
    ingest) with the closed-form weights, table=False a LAZY run."""
    out = []
    for s in range(words.shape[0]):
        if qsums is None:
            adopt = st.run_vec_from_sorted_unit if unit \
                else st.run_vec_from_sorted
            out.append(adopt(words[s], ebytes[s], weights[s], table=table))
        else:
            adopt = st.run_vecq_from_sorted_unit if unit \
                else st.run_vecq_from_sorted
            out.append(adopt(words[s], ebytes[s], weights[s], qsums[s],
                             table=table))
    return st.stack_stores(out)


def run_vec_merge_pair_step(a, b, unit: bool = False, table: bool = True):
    """Merge two stacked edge runs shard by shard (the LSM level merge):
    K2 with the edge byte (and quality bits) for two UNIT runs, with the
    weights too otherwise; table=False leaves the output LAZY."""
    merge = st.run_vec_merge_unit if unit else st.run_vec_merge
    return st.stack_stores([merge(a.shard(s), b.shard(s), table=table)
                            for s in range(a.keys.shape[0])])


def run_vec_table_step(store, unit: bool = False):
    """A LAZY stacked run with its tables built on every shard (a UNIT run's
    with the closed-form self stream)."""
    return st.stack_stores([st.run_vec_with_table(sh, unit)
                            for sh in _shards(store)])


def run_vec_stats_step(store) -> list[int]:
    """Distinct live nodes per shard."""
    return [int(st.run_vec_distinct(sh)) for sh in _shards(store)]


def run_vec_compact_step(store, new_cap: int):
    """(compacted stacked store, the largest shard overflow) — see
    store.run_vec_compact."""
    out = [st.run_vec_compact(sh, new_cap) for sh in _shards(store)]
    return st.stack_stores([o[0] for o in out]), max(o[1] for o in out)


def run_vec_aux_step(store) -> list:
    """Each shard's query-aux metadata of one run (store.run_vec_query_aux)."""
    return [st.run_vec_query_aux(sh) for sh in _shards(store)]


def runs_vec_query_step(queries: torch.Tensor, qvalid: torch.Tensor, runs,
                        aux, nparts: int = 1, capacity: int | None = None,
                        hash_name: str = "murmur",
                        saturate: int | None = None):
    """Node query over a list of edge runs (the node_counts surface,
    de_bruijn_node_trait.hpp:186-280): route once, look up in each run,
    sum, clamp at `saturate`, reply.  queries [p, m, w], qvalid [p, m];
    aux: each run's per-shard aux.  Returns (counters int32[p, m, 9],
    quality sums float64[p, m] — None unless the runs are quality stores
    —, overflow)."""
    owner = owners_for(queries, nparts, hash_name)
    (rq,), rvalid, route = dist.distribute((queries,), owner, qvalid, nparts,
                                           capacity)
    counts, qsums = [], []
    for s in range(nparts):
        parts = [st.run_vec_lookup(run.shard(s), rq[s], run_aux[s])
                 for run, run_aux in zip(runs, aux)]
        total = sum(c for c, _ in parts)
        if saturate is not None:
            total = total.clamp(max=saturate)
        counts.append(torch.where(rvalid[s][:, None], total, 0))
        if parts[0][1] is not None:
            qsums.append(torch.where(rvalid[s], sum(q for _, q in parts),
                                     0.0))
    back = dist.undistribute((st.stack(counts),) + (
        (st.stack(qsums),) if qsums else ()), route, nparts, capacity)
    return back[0], back[1] if qsums else None, route.overflow


def run_vec_export_step(store, saturate: int | None = None) -> list:
    """Per shard, (keys int32[t, w], counters int32[t, 9], quality sums
    float64[t] or None) of every node (store.run_vec_export)."""
    return [st.run_vec_export(sh, saturate) for sh in _shards(store)]


# ------------------------------------------------------- Bimolecule run map
# The count family's run steps serve a RunBimolStore as they are (stats,
# aux, count query, erase, filter, select, histogram); only the
# representative columns need steps of their own.
def _bimol_run(words, pays, valid, sentinel_ok: bool):
    """One shard's (key [n, w], weight, id_hi, id_lo, strand) rows sorted
    into an adoptable Bimolecule run: (key columns [w, n], sentinel keys
    after the valid rows; weights 0, ids sentinel and strand 0 on the dead
    rows)."""
    c, (wt, hi, lo, stc), v = sortops.sort_rows(
        words, pays, valid, is_stable=False, sentinel_ok=sentinel_ok,
        as_cols=True)
    return (torch.where(v[None, :], c, SENTINEL), torch.where(v, wt, 0),
            torch.where(v, hi, SENTINEL), torch.where(v, lo, SENTINEL),
            torch.where(v, stc, 0))


def _bimol_runs(rw, pays, rvalid, nparts: int, sentinel_ok: bool):
    runs = [_bimol_run(rw[s], tuple(p[s] for p in pays), rvalid[s],
                       sentinel_ok) for s in range(nparts)]
    return tuple(st.stack([r[i] for r in runs]) for i in range(5))


def bimol_ingest_step(bases: DeviceBases, spec, nparts: int,
                      capacity: int | None, hash_name: str = "murmur"):
    """Bimolecule ingest of per-base tensors [p, L] (the JAX package's
    ``make_bimol_run_ingest_step``): K1 — its was_rc flag is the strand —,
    the owner exchange with (id_hi, id_lo, strand) as payloads and one sort
    per shard; live rows weigh 1.  Returns (key columns int32[p, w, n],
    weights, id_hi, id_lo, strand int32[p, n], overflow): an adoptable run
    per shard."""
    tups = [extract_tuples(bases.shard(s), spec, canonical=True)
            for s in range(bases.codes.shape[0])]
    words = st.stack([t.words for t in tups])
    valid = st.stack([t.valid for t in tups])
    cols = (words, valid.to(torch.int32), st.stack([t.id_hi for t in tups]),
            st.stack([t.id_lo for t in tups]),
            st.stack([t.strand.to(torch.int32) for t in tups]))
    owner = owners_for(words, nparts, hash_name)
    (rw, *pays), rvalid, route = dist.distribute(cols, owner, valid, nparts,
                                                 capacity)
    return (*_bimol_runs(rw, pays, rvalid, nparts, spec.sentinel_safe),
            route.overflow)


def bimol_tuples_step(words, weights, id_hi, id_lo, strand, valid,
                      nparts: int, capacity: int | None,
                      hash_name: str = "murmur"):
    """Explicit (canonical key, weight, id halves, strand) rows [p, m, ...]
    (insert, insert_counts, load): route to the owners and sort each
    shard's into an adoptable run.  Returns as `bimol_ingest_step`."""
    owner = owners_for(words, nparts, hash_name)
    (rw, *pays), rvalid, route = dist.distribute(
        (words, weights, id_hi, id_lo, strand), owner, valid, nparts,
        capacity)
    return (*_bimol_runs(rw, pays, rvalid, nparts, False), route.overflow)


def run_bimol_adopt_step(kcols, weights, id_hi, id_lo,
                         strand) -> st.RunBimolStore:
    """Adopt a sorted Bimolecule run per shard ([p, w, n] / [p, n]) as a
    stacked store (each prefix sum through K3)."""
    return st.stack_stores([st.run_bimol_from_sorted(
        kcols[s], weights[s], id_hi[s], id_lo[s], strand[s])
        for s in range(kcols.shape[0])])


def run_bimol_merge_pair_step(a: st.RunBimolStore,
                              b: st.RunBimolStore) -> st.RunBimolStore:
    """Merge two stacked Bimolecule runs shard by shard (K2, 4 payloads)."""
    return st.stack_stores([st.run_bimol_merge(a.shard(s), b.shard(s))
                            for s in range(a.keys.shape[0])])


def run_bimol_compact_step(store: st.RunBimolStore, new_cap: int,
                           saturate: int | None = None):
    """(compacted stacked store, the largest shard overflow) — see
    store.run_bimol_compact."""
    out = [st.run_bimol_compact(sh, new_cap, saturate)
           for sh in _shards(store)]
    return st.stack_stores([o[0] for o in out]), max(o[1] for o in out)


def run_bimol_strands_step(store: st.RunBimolStore) -> list:
    """Each shard's stored-orientation column (store.run_bimol_strands)."""
    return [st.run_bimol_strands(sh) for sh in _shards(store)]


def run_bimol_find_step(queries: torch.Tensor, qvalid: torch.Tensor, aux,
                        strands, nparts: int = 1,
                        capacity: int | None = None,
                        hash_name: str = "murmur",
                        saturate: int | None = None):
    """Bimolecule find over the one run: route the canonical query rows
    [p, m, w] (qvalid [p, m]) to their owners, look up each one's count
    and stored orientation (store.run_bimol_find_aux; aux and strands per
    shard), reply.  Returns (counts int32[p, m], strand int32[p, m],
    overflow)."""
    owner = owners_for(queries, nparts, hash_name)
    (rq,), rvalid, route = dist.distribute((queries,), owner, qvalid, nparts,
                                           capacity)
    counts, strand = [], []
    for s in range(nparts):
        c, o = st.run_bimol_find_aux(*aux[s], strands[s], rq[s], saturate)
        counts.append(torch.where(rvalid[s], c, 0))
        strand.append(torch.where(rvalid[s], o, 0))
    back = dist.undistribute((st.stack(counts), st.stack(strand)), route,
                             nparts, capacity)
    return (*back, route.overflow)


def run_bimol_export_step(store: st.RunBimolStore,
                          saturate: int | None = None) -> list:
    """Per shard, (keys int32[t, w], counts int32[t], strand int32[t]) of
    every distinct live key (store.run_bimol_export)."""
    return [st.run_bimol_export(sh, saturate) for sh in _shards(store)]


# ------------------------------------------------- unique-key value map
def _kv_stack(reduced, capacity: int) -> st.KVStore:
    """Per-shard `kv_reduce` outputs -> one stacked store of capacity
    max(capacity, next_pow2 of the largest shard's distinct keys)."""
    largest = max(int(r[3]) for r in reduced)
    cap = max(capacity, 1 << max(4, (largest - 1).bit_length()))
    return st.stack_stores([st.kv_cut(*r, cap) for r in reduced])


def kv_insert_step(store: st.KVStore, words, val_hi, val_lo, valid,
                   nparts: int, capacity: int | None,
                   hash_name: str = "murmur", reduce: str = "first"):
    """Route (key, value) rows [p, m, ...] (valid [p, m]) to their owners
    and merge each shard's under the reduction (store.kv_insert; arrival
    order at an owner is source-shard-major).  Each shard's capacity grows
    to fit: no store overflow.  Returns (new stacked store, route
    overflow)."""
    owner = owners_for(words, nparts, hash_name)
    (rw, rhi, rlo), rvalid, route = dist.distribute(
        (words, val_hi, val_lo), owner, valid, nparts, capacity)
    reduced = [st.kv_insert(store.shard(s), rw[s], rhi[s], rlo[s], rvalid[s],
                            reduce) for s in range(nparts)]
    return _kv_stack(reduced, store.capacity), route.overflow


def kv_ingest_step(store: st.KVStore, bases: DeviceBases, spec, canonical,
                   nparts: int, capacity: int | None,
                   hash_name: str = "murmur", reduce: str = "min"):
    """Value-map file ingest of per-base tensors [p, L]: extraction (K1
    under the canonical preset), each window's 64-bit position id as its
    value, then `kv_insert_step`.  Returns as it."""
    tups = [extract_tuples(bases.shard(s), spec, canonical=canonical)
            for s in range(bases.codes.shape[0])]
    get = lambda f: st.stack([getattr(t, f) for t in tups])  # noqa: E731
    return kv_insert_step(store, get("words"), get("id_hi"), get("id_lo"),
                          get("valid"), nparts, capacity, hash_name, reduce)


def kv_find_routed(store: st.KVStore, queries, qvalid, owner, nparts: int,
                   capacity: int | None):
    """Value lookup of query rows [p, m, w] under a given owner map (the
    hash's or the splitters'): (val_hi, val_lo int32[p, m], found
    bool[p, m], overflow)."""
    (rq,), rvalid, route = dist.distribute((queries,), owner, qvalid, nparts,
                                           capacity)
    out = [st.kv_lookup(store.shard(s), rq[s]) for s in range(nparts)]
    hi, lo, found = (st.stack([o[i] for o in out]) for i in range(3))
    back = dist.undistribute((hi, lo, found & rvalid), route, nparts,
                             capacity)
    return (*back, route.overflow)


def kv_erase_routed(store: st.KVStore, keys, valid, owner, nparts: int,
                    capacity: int | None):
    """Erase the key rows [p, m, w] under a given owner map: (new stacked
    store, keys erased, overflow)."""
    (rk,), rvalid, route = dist.distribute((keys,), owner, valid, nparts,
                                           capacity)
    out = [st.kv_erase(store.shard(s), rk[s], rvalid[s])
           for s in range(nparts)]
    return (st.stack_stores([o[0] for o in out]),
            sum(int(o[1]) for o in out), route.overflow)


def kv_filter_step(store: st.KVStore, keep_pred):
    """erase_if / filter over every entry: entries failing keep_pred(keys
    int64[cap, w], val_hi int64[cap], val_lo int64[cap]) -> bool[cap] are
    removed.  Returns (new stacked store, entries removed)."""
    out = [st.kv_filter(sh, keep_pred) for sh in _shards(store)]
    return (st.stack_stores([o[0] for o in out]),
            int(sum(o[1] for o in out)))


def kv_select_step(store: st.KVStore, pred) -> list:
    """Per shard, (keys int32[t, w], val_hi, val_lo) of the entries
    satisfying pred (store.kv_select), in key order."""
    return [st.kv_select(sh, pred) for sh in _shards(store)]
