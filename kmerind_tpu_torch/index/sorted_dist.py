"""Range-partitioned (sorted) count index steps: shard-local ingest, the
samplesort flush and splitter-routed queries.

The port of the count subset of ``kmerind_tpu.index.sorted_dist`` — the
reference's second distribution strategy (counting_sorted_map,
distributed_sorted_map.hpp:2825).  Where the hash strategy owns keys by
``hash(key) % p``, here shard i owns the key range
[splitter[i-1], splitter[i]):

* **ingest** appends shard-local rows (distributed_sorted_map.hpp:341):
  extract (K1), sort, run lengths (K4) — no exchange;
* **flush** (the lazy global sort on first query, :341,940,2061): samples
  of every shard's sorted rows give p-1 splitters, rows route to their
  range's shard, and each shard sorts and sums its rows into a
  `CountStore` — the result is globally sorted;
* **queries** route by splitter (:1568-1600) through the same exchange.

The multimap (sorted_multimap, :2333) keeps every pair: its ingest only
extracts, its flush sorts each shard's received pairs into a `MultiStore`,
and its queries share the hash multimap's routed lookups
(``distributed.py``) under the splitter owner map.  The value map
(sorted_map, :1407) ingests like the multimap, reduces each key's rows to
one in its flush, and shares the hash value map's routed lookups.

Each JAX ``make_*_step`` factory returns a jitted ``shard_map`` program;
here each step is a plain function over stacked [p, ...] shard tensors
(``parallel/distribute.py``), looping over the shards between exchanges.
"""

from __future__ import annotations

import torch

from ..io.kmer_parsers import DeviceBases, extract_tuples
from ..ops import sortops
from ..ops.keys import SENTINEL
from ..parallel import distribute as dist
from ..parallel.sample_sort import global_splitters, owners_from_splitters
from ..quality import ILLUMINA18
from . import store as st

__all__ = ["owners_from_splitters", "local_ingest_step", "count_flush_step",
           "count_query_step", "count_erase_step",
           "multi_local_ingest_step", "multi_flush_step", "kv_flush_step"]


def local_ingest_step(bases: DeviceBases, spec, canonical):
    """Shard-local extraction and pre-reduction, no exchange.  bases: [p, L]
    tensors.  Returns (words [p, L, w], weights int32[p, L], emit
    bool[p, L]): each shard's rows sorted, the last row of each key run
    emitted with the run's length."""
    words, weights, emit = [], [], []
    for s in range(bases.codes.shape[0]):
        tup = extract_tuples(bases.shard(s), spec, canonical=canonical)
        s_cols, _, s_valid = sortops.sort_rows(
            tup.words, (), tup.valid, is_stable=False,
            sentinel_ok=spec.sentinel_safe, as_cols=True)
        wt, em = sortops.run_length_counts(s_cols.t(), s_valid)
        words.append(s_cols.t())
        weights.append(wt)
        emit.append(em)
    return torch.stack(words), torch.stack(weights), torch.stack(emit)


def count_flush_step(words, weights, valid, nparts: int, capacity: int,
                     saturate: int | None = None, sentinel_ok: bool = False,
                     oversample: int = 64):
    """(words [p, n, w], weights [p, n], valid [p, n]) -> (store [p, cap, w],
    splitters [p-1, w], overflow).

    The whole-index rebuild of counting_sorted_map's lazy sort: the inputs
    are ALL live rows (store contents as weighted rows plus pending
    inserts); the output store is globally range-partitioned, one row per
    key with its summed weight (clipped at `saturate`).  Each shard's
    capacity is cut to next_pow2 of the largest shard's size (at least
    16)."""
    splitters = global_splitters(words, valid, nparts, oversample,
                                 sentinel_ok)
    owner = owners_from_splitters(words, splitters, nparts)
    (rw, rwts), rvalid, route = dist.distribute(
        (words, weights), owner, valid, nparts, capacity)
    reduced = []
    for s in range(nparts):
        s2, (v2,), sv2 = sortops.sort_rows(
            rw[s], (rwts[s],), rvalid[s], is_stable=False,
            sentinel_ok=sentinel_ok)
        uniq, red, n_unique = sortops.segment_reduce_sorted(s2, sv2, v2)
        if saturate is not None:
            red = red.clamp(max=saturate)
        reduced.append((uniq, red, n_unique.to(torch.int32)))
    largest = max(int(r[2]) for r in reduced)
    cap = min(reduced[0][0].shape[0], 1 << max(4, (largest - 1).bit_length()))
    store = st.stack_count_stores(
        [st.CountStore(u[:cap], r[:cap], n) for u, r, n in reduced])
    return store, splitters, route.overflow


def count_query_step(store: st.CountStore, splitters, queries, qvalid,
                     nparts: int, capacity: int):
    """Splitter-routed count: (counts int32[p, m], overflow) for queries
    [p, m, w] (qvalid [p, m]); invalid queries count 0."""
    owner = owners_from_splitters(queries, splitters, nparts)
    (rq,), rvalid, route = dist.distribute((queries,), owner, qvalid,
                                           nparts, capacity)
    local = torch.stack([
        torch.where(rvalid[s], st.count_lookup(store.shard(s), rq[s]), 0)
        for s in range(nparts)])
    (back,) = dist.undistribute((local,), route, nparts, capacity)
    return back, route.overflow


def count_erase_step(store: st.CountStore, splitters, keys, valid,
                     nparts: int, capacity: int):
    """Splitter-routed erase: (new store, n_erased int32[p], overflow).
    Erasing never moves keys between shards, so the splitters stay."""
    owner = owners_from_splitters(keys, splitters, nparts)
    (rk,), rvalid, route = dist.distribute((keys,), owner, valid, nparts,
                                           capacity)
    out = [st.count_erase(store.shard(s), rk[s], rvalid[s])
           for s in range(nparts)]
    return (st.stack_count_stores([o[0] for o in out]),
            torch.stack([o[1] for o in out]), route.overflow)


# ----------------------------------------------------------------- multimap
def multi_local_ingest_step(bases: DeviceBases, spec, canonical,
                            with_quality: bool = False, codec=ILLUMINA18):
    """Shard-local multimap extraction, no exchange and no reduction:
    bases [p, L] -> (words [p, L, w], id_hi, id_lo, qual float32 or None,
    valid), each [p, L]."""
    tups = [extract_tuples(bases.shard(s), spec, canonical=canonical,
                           with_quality=with_quality, codec=codec)
            for s in range(bases.codes.shape[0])]
    get = lambda f: st.stack([getattr(t, f) for t in tups])  # noqa: E731
    return (get("words"), get("id_hi"), get("id_lo"),
            get("qual") if with_quality else None, get("valid"))


def multi_flush_step(words, hi, lo, q, valid, nparts: int, capacity: int,
                     sentinel_ok: bool = False, oversample: int = 64):
    """The sorted multimap's rebuild (sorted_multimap's global sort,
    distributed_sorted_map.hpp:2333+): (words [p, n, w], hi, lo, q float32
    or None, valid [p, n]) -> (stacked store, splitters [p-1, w],
    overflow).  Every valid pair survives; each shard's pairs come out
    sorted by key (stable) with sentinel rows after, its capacity cut to
    next_pow2 of the largest shard's size (at least 16).  q None: the
    store's quality column is zero."""
    splitters = global_splitters(words, valid, nparts, oversample,
                                 sentinel_ok)
    owner = owners_from_splitters(words, splitters, nparts)
    cols = (words, hi, lo) + (() if q is None else (q,))
    recv, rvalid, route = dist.distribute(cols, owner, valid, nparts,
                                          capacity)
    stores = []
    for s in range(nparts):
        pays = tuple(r[s] for r in recv[1:])
        if q is None:
            pays += (torch.zeros(rvalid.shape[1], dtype=torch.float32,
                                 device=words.device),)
        s_cols, (s_hi, s_lo, s_q), s_valid = sortops.sort_rows(
            recv[0][s], pays, rvalid[s], as_cols=True)
        stores.append(st.MultiStore(
            torch.where(s_valid[None, :], s_cols, SENTINEL), s_hi, s_lo, s_q,
            s_valid.sum(dtype=torch.int32)))
    largest = max(int(x.size) for x in stores)
    cap = min(stores[0].capacity, 1 << max(4, (largest - 1).bit_length()))
    return (st.stack_multi_stores([st.MultiStore(
        x.keys[:, :cap].contiguous(), x.val_hi[:cap], x.val_lo[:cap],
        x.val_q[:cap], x.size) for x in stores]), splitters, route.overflow)


# ------------------------------------------------ unique-key value map
def kv_flush_step(words, val_hi, val_lo, order, valid, nparts: int,
                  capacity: int, reduce: str = "first",
                  sentinel_ok: bool = False, oversample: int = 64):
    """The sorted value map's rebuild (sorted_map's global sort,
    distributed_sorted_map.hpp:1407): (words [p, n, w], val_hi, val_lo,
    order — the priority columns of reduce="first", each [p, n] —, valid
    [p, n]) -> (stacked `KVStore`, splitters [p-1, w], overflow).  The
    inputs are ALL rows (the store's entries with the lowest priority,
    then the pending inserts); each shard reduces what it received
    (store.kv_reduce: under "first" the row first in priority, then
    arrival order; under "min" / "max" the extreme value), its capacity cut
    to next_pow2 of the largest shard's size (at least 16)."""
    splitters = global_splitters(words, valid, nparts, oversample,
                                 sentinel_ok)
    owner = owners_from_splitters(words, splitters, nparts)
    order = tuple(order) if reduce == "first" else ()
    (rw, rhi, rlo, *rord), rvalid, route = dist.distribute(
        (words, val_hi, val_lo) + order, owner, valid, nparts, capacity)
    reduced = [st.kv_reduce(rw[s], rhi[s], rlo[s], rvalid[s], reduce,
                            tuple(o[s] for o in rord))
               for s in range(nparts)]
    largest = max(int(r[3]) for r in reduced)
    cap = min(rw.shape[1], 1 << max(4, (largest - 1).bit_length()))
    return (st.stack_stores([st.kv_cut(*r, cap) for r in reduced]),
            splitters, route.overflow)
