"""Range-partitioned (sorted) k-mer count index.

The port of the count index of ``kmerind_tpu.index.sorted_api`` — the
reference's range-partitioned strategy, counting_sorted_map
(distributed_sorted_map.hpp:2825), beside the hash strategy of `api.py`.

Semantics follow the reference's lazy-sort design
(distributed_sorted_map.hpp:341,940): `insert*` appends shard-local rows;
the first query after an insert runs `_flush` — a global samplesort that
moves ALL rows across shards by key range and recomputes the p-1
splitters; queries then route by splitter instead of by hash.  Contents
equal the hash index's; only placement differs: shard i holds a contiguous
key range, which makes range scans (`items_in_range`) local.  Under a
mesh of several ranks the flush is a collective samplesort (the splitters
come from every rank's samples) and every query a splitter-routed
collective, as in ``api.py``.

Example::

    idx = SortedCountIndex(KmerSpec(21, DNA), nparts=4)   # on CUDA
    idx.build("reads.fastq")
    idx.count(["ACGTACGTACGTACGTACGTA"])
    idx.items_in_range(lo_kmer, hi_kmer)
"""

from __future__ import annotations

import numpy as np
import torch

from ..kmer import KmerSpec
from ..ops.keys import from_numpy_u32, to_numpy_u32, to_u64
from ..parallel.mesh import Mesh
from ..utils.timers import PhaseTimer
from . import sorted_dist as sx
from . import store as st
from . import distributed as dx
from .api import (_CountSurfaceMixin, _IndexBase, _MultimapSurfaceMixin,
                  _live_rows, _open_npz)

__all__ = ["SortedCountIndex", "SortedPositionIndex",
           "SortedPositionQualityIndex"]


class _SortedBase(_IndexBase):
    """Splitter bookkeeping of the sorted indexes."""

    def __init__(self, spec: KmerSpec, device="cuda", canonical=True,
                 nparts: int = 1, timer: PhaseTimer | None = None,
                 mesh: Mesh | None = None):
        super().__init__(spec, device, canonical, nparts, timer, mesh)
        #: int32[p-1, w] range boundaries; None until the first flush
        self.splitters = None

    def reserve(self, n: int):
        """No-op: each flush sizes every shard to next_pow2 of the largest
        shard's rows (the JAX package's sorted indexes have no `_grow`, so
        their reserve raises)."""
        return self

    def splitter_table(self) -> np.ndarray:
        """Host copy of the p-1 range boundaries (uint32[p-1, w])."""
        self._flush()
        return to_numpy_u32(self.splitters)

    def _routed(self, step, words: torch.Tensor):
        """Run a splitter-routed step(store, splitters, rows, valid, nparts,
        capacity) -> (*outputs, overflow) over query rows, doubling the
        bucket capacity until no bucket overflows.  Returns (outputs, m)."""
        self._flush()
        return self._route_rows(
            lambda w, v, cap: step(self.store, self.splitters, w, v,
                                   self.mesh, cap), words)


class SortedCountIndex(_CountSurfaceMixin, _SortedBase):
    """k-mer -> count index over `nparts` range-partitioned shards stacked
    on one device (counting_sorted_map, distributed_sorted_map.hpp:2825);
    the count surface of `CountIndex` (predicates see int64 key words).

    saturate: counts are clipped at this value on every flush."""

    def __init__(self, spec: KmerSpec, device="cuda", canonical=True,
                 saturate: int | None = None,
                 initial_capacity: int = 1 << 12, nparts: int = 1,
                 timer: PhaseTimer | None = None, mesh: Mesh | None = None):
        super().__init__(spec, device, canonical, nparts, timer, mesh)
        self.saturate = saturate
        self.store = st.stack_count_stores(
            [st.empty_count_store(initial_capacity, spec.nwords,
                                  self.device)] * self.mesh.p_local)
        #: appended rows awaiting the flush: (words [p, n, w], weights
        #: [p, n], valid [p, n])
        self._pending: list = []

    @property
    def capacity(self) -> int:
        return self.store.keys.shape[1]

    def size(self) -> int:
        """Distinct-key count."""
        self._flush()
        return self.mesh.all_sum(int(self.store.size.sum()))

    def local_sizes(self) -> list[int]:
        """Distinct keys per shard, in global (key range) order."""
        self._flush()
        return self._whole(self.store.size).tolist()

    # -- ingest --------------------------------------------------------
    def _insert_cols(self, cols: dict):
        """Shard-local extract + pre-reduce; rows stay on their shard until
        the flush (sorted_map append-then-sort,
        distributed_sorted_map.hpp:341)."""
        bases = self._to_device(cols)
        with self.timer.phase("insert"):
            self._pending.append(sx.local_ingest_step(
                bases, self.spec, self.canonical))
        return self

    def insert(self, kmers):
        """Insert k-mers (strings, ints or word rows), one count each."""
        words = self._query_words(kmers)
        return self._append_rows(words, torch.ones(
            words.shape[0], dtype=torch.int32, device=self.device))

    def insert_counts(self, kmers, counts):
        """(kmer, count) pair inserts (the counting map's second input
        flavor)."""
        return self._append_rows(self._query_words(kmers), torch.as_tensor(
            np.asarray(counts, np.int32), device=self.device))

    def _append_rows(self, words: torch.Tensor, counts: torch.Tensor):
        (wsh, csh), vsh, _ = self._shard_rows(words, extra=(counts,))
        self._pending.append((wsh, csh, vsh))
        return self

    # -- the global samplesort flush -----------------------------------
    def _flush(self):
        """Re-sort the store's rows and all pending rows across the shards,
        retrying with doubled bucket capacity on overflow."""
        if self.splitters is not None and not self._pending:
            return
        live = (torch.arange(self.capacity, device=self.device)[None, :]
                < self.store.size[:, None])
        parts = [(self.store.keys, self.store.counts, live)] + self._pending
        words, weights, valid = (torch.cat([t[i] for t in parts], dim=1)
                                 for i in range(3))
        self._pending = []
        del parts
        cap = max(self._bucket_capacity(max(self.mesh.all_sum(
            int(valid.sum())), 1)), 16)
        while True:
            with self.timer.phase("flush"):
                store, splitters, ovf = sx.count_flush_step(
                    words, weights, valid, self.mesh, cap, self.saturate,
                    self.spec.sentinel_safe)
            if ovf == 0:
                self.store, self.splitters = store, splitters
                return
            cap *= 2

    # -- queries -------------------------------------------------------
    def _count_words(self, words: torch.Tensor) -> np.ndarray:
        with self.timer.phase("count"):
            (counts,), m = self._routed(sx.count_query_step, words)
            return self._replies(counts, m).cpu().numpy()

    def _erase_words(self, words: torch.Tensor) -> int:
        """Remove the keys; returns how many were present.  Erasing never
        moves keys between shards, so the splitters stay."""
        (store, nerased), _ = self._routed(sx.count_erase_step, words)
        self.store = store
        return nerased

    # predicate scans and the spectrum are shard-local: no routing
    def _filter(self, keep_pred) -> int:
        self._flush()
        self.store, nerased = dx.count_filter_step(self.store, keep_pred,
                                                   self.mesh)
        return nerased

    def _select(self, pred) -> list:
        self._flush()
        return dx.count_select_step(self.store, pred)

    def _histogram(self, nbins: int) -> torch.Tensor:
        self._flush()
        return dx.histogram_step(self.store, nbins, self.mesh)

    # -- range scan: the capability hash distribution cannot offer ------
    def items_in_range(self, lo_kmer, hi_kmer):
        """All (kmer_int, count) with lo <= kmer < hi, sorted — a local
        selection on each shard, since shards hold contiguous key ranges
        (distributed_sorted_map.hpp:114-141).  The bounds are taken as
        given, not canonicalized."""
        lo, hi = (to_u64(from_numpy_u32(self._to_words([x])[0], self.device))
                  for x in (lo_kmer, hi_kmer))

        def less(k, bound):
            out = torch.zeros(k.shape[0], dtype=torch.bool, device=k.device)
            for j in reversed(range(k.shape[1])):
                out = torch.where(k[:, j] != bound[j], k[:, j] < bound[j], out)
            return out

        return sorted(self.count_if(lambda k, c: ~less(k, lo) & less(k, hi)))

    # -- persistence / export ------------------------------------------
    def to_dict(self) -> dict[int, int]:
        """Full contents as {kmer_int: count} (host-side; tests/tools)."""
        return dict(self.count_if(lambda k, c: c >= 0))

    def save(self, path):
        """npz in the JAX package's format: either package loads it."""
        self._flush()
        self._savez(
            path, kind="sorted_count", k=self.spec.k,
            alphabet=self.spec.alphabet.name, canonical=self.canonical,
            saturate=-1 if self.saturate is None else self.saturate,
            nparts=self.nparts,
            keys=to_numpy_u32(self._whole(self.store.keys)),
            counts=self._whole(self.store.counts).cpu().numpy(),
            sizes=self._whole(self.store.size).cpu().numpy())
        return self

    @classmethod
    def load(cls, path, device="cuda", nparts: int = 1, mesh=None):
        """An index of `nparts` shards (or over `mesh`) holding a saved
        index's contents (saved at any shard count, by either package)."""
        z, spec = _open_npz(path, ("sorted_count",))
        sat = int(z["saturate"])
        idx = cls(spec, device, canonical=bool(z["canonical"]),
                  saturate=None if sat < 0 else sat, nparts=nparts,
                  mesh=mesh)
        rows = _live_rows(z["keys"], z["sizes"])
        if rows.shape[0]:
            vals = _live_rows(z["counts"], z["sizes"]).astype(np.int32)
            idx._append_rows(from_numpy_u32(rows, idx.device),
                             torch.from_numpy(vals).to(idx.device))
        return idx


class SortedPositionIndex(_MultimapSurfaceMixin, _SortedBase):
    """k-mer -> position ids multimap over `nparts` range-partitioned shards
    stacked on one device (sorted_multimap, distributed_sorted_map.hpp:
    2333): ingest appends shard-local tuples; the first query after an
    insert re-sorts every pair across the shards by key range (samplesort)
    and recomputes the splitters.  Same surface as `PositionIndex`."""

    _npz_kind = "sorted_position"

    def __init__(self, spec: KmerSpec, device="cuda", canonical=False,
                 nparts: int = 1, id_kind: str = "short",
                 initial_capacity: int = 1 << 12, codec=None,
                 timer: PhaseTimer | None = None, mesh: Mesh | None = None):
        super().__init__(spec, device, canonical, nparts, timer, mesh)
        self._init_multimap(id_kind, initial_capacity, codec)

    def _insert_cols(self, cols: dict):
        """Shard-local extraction; the tuples stay on their shard until the
        flush."""
        bases = self._to_device(cols)
        with self.timer.phase("insert"):
            tup = sx.multi_local_ingest_step(
                bases, self.spec, self.canonical, self.with_quality,
                self.codec)
        self._pending.append(tup)
        self._pending_rows += tup[0].shape[1]
        return self

    def _insert_pairs(self, words, val_hi, val_lo, val_q):
        (wsh, hsh, lsh, qsh), vsh, _ = self._shard_rows(
            words, extra=(val_hi, val_lo, val_q))
        self._pending.append((wsh, hsh, lsh, qsh, vsh))
        self._pending_rows += wsh.shape[1]
        return self

    def _flush(self):
        """Re-sort the store's pairs and every pending tuple across the
        shards, retrying with doubled bucket capacity on overflow."""
        if self.splitters is not None and not self._pending:
            return
        s = self.store
        live = (torch.arange(s.capacity, device=self.device)[None, :]
                < s.size[:, None])
        parts = [(s.keys.transpose(1, 2), s.val_hi, s.val_lo, s.val_q,
                  live)] + self._pending
        words, hi, lo, q, valid = dx.concat_pending(parts, self._has_q)
        self._pending, self._pending_rows = [], 0
        del parts, s
        cap = max(self._bucket_capacity(max(self.mesh.all_sum(
            int(valid.sum())), 1)), 16)
        while True:
            with self.timer.phase("merge"):
                store, splitters, ovf = sx.multi_flush_step(
                    words, hi, lo, q, valid, self.mesh, cap,
                    self.spec.sentinel_safe)
            if ovf == 0:
                self.store, self.splitters = store, splitters
                return
            cap *= 2

    def _owners(self, words):
        """Owner shard per key row: its splitter range."""
        return sx.owners_from_splitters(words, self.splitters, self.nparts)


class SortedPositionQualityIndex(SortedPositionIndex):
    """Range-partitioned k-mer -> (position id, windowed quality)
    multimap."""

    with_quality = True
