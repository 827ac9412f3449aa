"""Unique-key k-mer -> 64-bit value indexes.

The port of ``kmerind_tpu.index.value_api``: the reference's generic
``KmerIndex = Index<densehash_map<Kmer, T>>`` alias (kmer_index.hpp:
397-399, over densehash_map.hpp:1742) and its sorted-map twin
(distributed_sorted_map.hpp:1407) — one uint64 value per k-mer under an
insert reduction:

* ``reduce="first"`` — the earliest-inserted value wins (the hash map's
  insert-does-not-overwrite; arrival order is call order, then row order
  within a call);
* ``reduce="min"`` / ``"max"`` — the extreme unsigned value wins (the
  reduction map's min / max functor, distributed_densehash_map.hpp:
  2429+); order-independent.

``build(path)`` gives each k-mer its occurrences' 64-bit position ids
(`id_kind` "short" or "long") as values; under "first" the file build
reduces by "min" — the earliest position, whatever the chunking or the
shard count.  `KmerValueIndex` is hash-partitioned and inserts eagerly
(one stable sort of store and batch per insert); `SortedKmerValueIndex`
is range-partitioned: inserts wait as shard-local rows until the first
query's samplesort flush.

Predicates take (keys int64[n, w], val_hi int64[n], val_lo int64[n]) —
each key word and value half an int64 holding its unsigned value — and
return bool[n].

Example::

    idx = KmerValueIndex(KmerSpec(21, DNA), reduce="min")   # on CUDA
    idx.build("reads.fastq")            # value: earliest position id
    values, found = idx.find(["ACGTACGTACGTACGTACGTA"])
    idx.insert(["ACGTACGTACGTACGTACGTA"], [7])
"""

from __future__ import annotations

import numpy as np
import torch

from ..kmer import KmerSpec
from ..ops.keys import from_numpy_u32, to_numpy_u32, to_u64
from ..utils.timers import PhaseTimer
from . import distributed as dx
from . import sorted_dist as sx
from . import store as st
from .api import _IndexBase, _live_rows, _next_pow2, _open_npz
from .sorted_api import _SortedBase

__all__ = ["KmerValueIndex", "SortedKmerValueIndex"]


def _split64(values) -> tuple[np.ndarray, np.ndarray]:
    """uint64 values -> their (hi, lo) uint32 halves."""
    v = np.asarray(values, dtype=np.uint64).reshape(-1)
    return ((v >> np.uint64(32)).astype(np.uint32),
            (v & np.uint64(0xFFFFFFFF)).astype(np.uint32))


def _join64(hi: torch.Tensor, lo: torch.Tensor) -> np.ndarray:
    """int32-held uint32 halves -> uint64 host values."""
    return ((to_numpy_u32(hi).astype(np.uint64) << np.uint64(32))
            | to_numpy_u32(lo).astype(np.uint64))


class _KVCommon:
    """The surface shared by both distributions.  A class provides
    `_insert_rows`, `_find_words`, `_erase_words`, `_flush` and
    `_npz_kind`; `store` is a stacked `store.KVStore`."""

    def _init_kv(self, reduce: str, id_kind: str, initial_capacity: int):
        if reduce not in ("first", "min", "max"):
            raise ValueError("reduce must be first|min|max (sum-type "
                             "reductions are the counting family)")
        if id_kind not in ("short", "long"):
            raise ValueError(f"unknown id kind {id_kind!r}")
        self.reduce = reduce
        self.id_kind = id_kind
        self.store = st.stack_stores(
            [st.empty_kv_store(initial_capacity, self.spec.nwords,
                               self.device)] * self.nparts)

    @property
    def capacity(self) -> int:
        """Rows per shard."""
        return self.store.capacity

    def size(self) -> int:
        """Distinct keys."""
        self._flush()
        return int(self.store.size.sum())

    def local_sizes(self) -> list[int]:
        """Distinct keys per shard, in shard order."""
        self._flush()
        return self.store.size.cpu().numpy().tolist()

    def unique_size(self) -> int:
        return self.size()

    def count(self, kmers) -> np.ndarray:
        """int32[m] 0 / 1 membership (a unique map's multiplicity)."""
        return self.find(kmers)[1].astype(np.int32)

    get_multiplicity = count

    def insert(self, kmers, values):
        """Insert (k-mer, uint64 value) pairs under the index's reduction
        (Index::insert of (Kmer, T) tuples)."""
        words = self._query_words(kmers)
        hi, lo = _split64(values)
        if hi.shape[0] != words.shape[0]:
            raise ValueError("kmers and values length mismatch")
        return self._insert_rows(words, from_numpy_u32(hi, self.device),
                                 from_numpy_u32(lo, self.device))

    def find(self, kmers):
        """(values uint64[m], found bool[m]) in query order (Index::find;
        an absent key reports value 0, found False)."""
        return self._find_words(self._query_words(kmers))

    def _pred_mask(self, pred, words: torch.Tensor,
                   vals: np.ndarray) -> np.ndarray:
        """bool[m] host mask of pred over query rows and their values."""
        hi, lo = _split64(vals)
        put = lambda a: to_u64(from_numpy_u32(a, words.device))  # noqa: E731
        keep = pred(to_u64(words), put(hi), put(lo))
        return torch.as_tensor(keep).cpu().numpy().astype(bool)

    def find_if(self, pred, kmers=None):
        """Without kmers: count_if(pred).  With kmers: (values, found &
        pred(queries, their values))."""
        if kmers is None:
            return self.count_if(pred)
        words = self._query_words(kmers)
        vals, found = self._find_words(words)
        return vals, found & self._pred_mask(pred, words, vals)

    def count_if(self, pred, kmers=None):
        """Without kmers: [(kmer_int, value)] of every entry satisfying
        pred, shard by shard in key order.  With kmers: int32[m] 1 where
        the query is present and pred holds, else 0."""
        if kmers is not None:
            vals, found = self.find_if(pred, kmers)
            return found.astype(np.int32)
        self._flush()
        out = []
        for keys, hi, lo in dx.kv_select_step(self.store, pred):
            if keys.shape[0]:
                out.extend(zip(self.spec.to_ints(to_numpy_u32(keys)).tolist(),
                               _join64(hi, lo).tolist()))
        return out

    def erase(self, kmers) -> int:
        """Erase the query keys; returns how many were present."""
        return self._erase_words(self._query_words(kmers))

    def erase_if(self, pred, kmers=None) -> int:
        """Erase the entries satisfying pred; with `kmers`, only those query
        keys whose (key, value) satisfies it.  Returns how many."""
        if kmers is None:
            self._flush()
            with self.timer.phase("filter"):
                self.store, nerased = dx.kv_filter_step(
                    self.store, lambda k, h, lo: ~pred(k, h, lo))
            return nerased
        words = self._query_words(kmers)
        vals, found = self._find_words(words)
        hits = found & self._pred_mask(pred, words, vals)
        if not hits.any():
            return 0
        return self._erase_words(words[torch.from_numpy(hits).to(
            words.device)])

    def filter(self, pred) -> int:
        """Keep only the entries satisfying pred; returns how many were
        erased."""
        return self.erase_if(lambda k, h, lo: ~pred(k, h, lo))

    def _values_of(self, hi, lo, found, m: int):
        """Routed replies [p, mq] -> (values uint64[m], found bool[m])."""
        return (_join64(hi.reshape(-1)[:m], lo.reshape(-1)[:m]),
                found.reshape(-1)[:m].to(torch.bool).cpu().numpy())

    def to_dict(self) -> dict[int, int]:
        """Full contents as {kmer_int: value} (host-side; tests/tools)."""
        self._flush()
        s = self.store
        sizes = s.size.cpu().numpy()
        rows = _live_rows(to_numpy_u32(s.keys), sizes)
        if rows.shape[0] == 0:
            return {}
        vals = ((_live_rows(to_numpy_u32(s.val_hi), sizes).astype(np.uint64)
                 << np.uint64(32))
                | _live_rows(to_numpy_u32(s.val_lo), sizes).astype(np.uint64))
        return dict(zip(self.spec.to_ints(rows).tolist(), vals.tolist()))

    # -- persistence: the JAX package's "kv" / "sorted_kv" npz ----------
    def save(self, path):
        """One npz file of every entry, shard by shard (keys [p, n, w], n
        the fullest shard's size), and the config, in the JAX package's
        format: either package loads it, at any shard count."""
        self._flush()
        s = self.store
        n = int(s.size.max())
        extra = ({"hash_name": self.hash_name} if hasattr(self, "hash_name")
                 else {})
        np.savez_compressed(
            path, kind=self._npz_kind, k=self.spec.k,
            alphabet=self.spec.alphabet.name, canonical=self.canonical,
            reduce=self.reduce, nparts=self.nparts,
            keys=to_numpy_u32(s.keys[:, :n]),
            val_hi=to_numpy_u32(s.val_hi[:, :n]),
            val_lo=to_numpy_u32(s.val_lo[:, :n]),
            sizes=s.size.cpu().numpy(), **extra)
        return self

    @classmethod
    def load(cls, path, device="cuda", nparts: int = 1):
        """An index of `nparts` shards holding a saved value map's entries
        (saved at any shard count, by either package); the stored keys are
        already transformed and go back in without another transform."""
        z, spec = _open_npz(path, (cls._npz_kind,))
        extra = ({"hash_name": str(z["hash_name"])}
                 if "hash_name" in z.files else {})
        idx = cls(spec, device, canonical=bool(z["canonical"]),
                  reduce=str(z["reduce"]), nparts=nparts, **extra)
        sizes = z["sizes"]
        rows = _live_rows(z["keys"], sizes)
        if rows.shape[0]:
            idx._insert_rows(from_numpy_u32(rows, idx.device),
                             *(from_numpy_u32(_live_rows(z[f], sizes),
                                              idx.device)
                               for f in ("val_hi", "val_lo")))
        return idx


class KmerValueIndex(_KVCommon, _IndexBase):
    """Hash-partitioned unique k-mer -> uint64 value map over `nparts`
    shards stacked on one device (``KmerIndex = Index<densehash_map<Kmer,
    T>>``, kmer_index.hpp:397-399).  Key q lives on shard
    ``owner_from_hash(HASHES[hash_name](q), p)``; every insert routes its
    rows to their owners and merges them at once (`store.kv_insert`)."""

    _npz_kind = "kv"

    def __init__(self, spec: KmerSpec, device="cuda", canonical=True,
                 nparts: int = 1, hash_name: str = "murmur",
                 reduce: str = "first", id_kind: str = "short",
                 initial_capacity: int = 1 << 12,
                 timer: PhaseTimer | None = None):
        super().__init__(spec, device, canonical, nparts, timer)
        self.hash_name = hash_name
        self._init_kv(reduce, id_kind, initial_capacity)

    def _flush(self):
        return  # inserts are eager

    def _grow(self, new_cap: int):
        self.store = st.kv_grow(self.store, new_cap)

    def _owners(self, words):
        return dx.owners_for(words, self.nparts, self.hash_name)

    def _insert_rows(self, words, val_hi, val_lo):
        """Route explicit (key, value halves) device rows to their owners
        and merge them under the reduction."""
        if words.shape[0] == 0:
            return self
        with self.timer.phase("insert"):
            (store,), _ = self._route_rows(
                lambda w, h, lo, v, cap: dx.kv_insert_step(
                    self.store, w, h, lo, v, self.nparts, cap,
                    self.hash_name, self.reduce),
                words, extra=(val_hi, val_lo))
        self.store = store
        return self

    def _insert_cols(self, cols: dict):
        bases = self._to_device(cols)
        cap = self._bucket_capacity(bases.codes.shape[1])
        reduce = "min" if self.reduce == "first" else self.reduce
        with self.timer.phase("insert"):
            while True:
                store, ovf = dx.kv_ingest_step(
                    self.store, bases, self.spec, self.canonical,
                    self.nparts, cap, self.hash_name, reduce)
                if ovf == 0:
                    break
                cap = _next_pow2(cap + ovf)
        self.store = store
        return self

    def _find_words(self, words: torch.Tensor):
        with self.timer.phase("find"):
            (hi, lo, found), m = self._route_rows(
                lambda q, v, cap: dx.kv_find_routed(
                    self.store, q, v, self._owners(q), self.nparts, cap),
                words)
            return self._values_of(hi, lo, found, m)

    def _erase_words(self, words: torch.Tensor) -> int:
        with self.timer.phase("erase"):
            (store, nerased), _ = self._route_rows(
                lambda q, v, cap: dx.kv_erase_routed(
                    self.store, q, v, self._owners(q), self.nparts, cap),
                words)
        self.store = store
        return nerased


class SortedKmerValueIndex(_KVCommon, _SortedBase):
    """Range-partitioned unique k-mer -> uint64 value map over `nparts`
    shards stacked on one device (sorted_map, distributed_sorted_map.hpp:
    1407): inserts append shard-local rows; the first query after them
    re-sorts the store's entries and every pending row across the shards
    by key range (samplesort, `sorted_dist.kv_flush_step`) and reduces
    each key's rows to one.  Under reduce="first" the store's entries
    win, then explicit inserts in call order, then arrival order; a file
    build's rows rank by their position id (the earliest wins)."""

    _npz_kind = "sorted_kv"

    def __init__(self, spec: KmerSpec, device="cuda", canonical=True,
                 nparts: int = 1, reduce: str = "first",
                 id_kind: str = "short", initial_capacity: int = 1 << 12,
                 timer: PhaseTimer | None = None):
        super().__init__(spec, device, canonical, nparts, timer)
        self._init_kv(reduce, id_kind, initial_capacity)
        #: pending (words [p, n, w], val_hi, val_lo, prio, tie, valid):
        #: under "first" a row ranks by (prio, tie) — an explicit insert's
        #: call number and 0, a file row's position id halves — then by
        #: arrival; the store's entries re-enter at (0, 0) and win
        self._pending: list = []
        self._calls = 1

    def _owners(self, words):
        return sx.owners_from_splitters(words, self.splitters, self.nparts)

    def _insert_rows(self, words, val_hi, val_lo):
        m = words.shape[0]
        prio = torch.full((m,), self._calls, dtype=torch.int32,
                          device=self.device)
        self._calls += 1
        (wsh, hsh, lsh, psh, tsh), vsh, _ = self._shard_rows(
            words, extra=(val_hi, val_lo, prio, torch.zeros_like(prio)))
        self._pending.append((wsh, hsh, lsh, psh, tsh, vsh))
        return self

    def _insert_cols(self, cols: dict):
        """Shard-local extraction; the rows stay on their shard until the
        flush."""
        with self.timer.phase("insert"):
            words, hi, lo, _, valid = sx.multi_local_ingest_step(
                self._to_device(cols), self.spec, self.canonical)
        self._pending.append((words, hi, lo, hi, lo, valid))
        return self

    def _flush(self):
        """Re-sort the store's entries and every pending row across the
        shards, retrying with doubled bucket capacity on overflow."""
        if self.splitters is not None and not self._pending:
            return
        s = self.store
        live = (torch.arange(s.capacity, device=self.device)[None, :]
                < s.size[:, None])
        zero = torch.zeros_like(s.val_hi)
        parts = [(s.keys, s.val_hi, s.val_lo, zero, zero, live)] \
            + self._pending
        words, hi, lo, prio, tie, valid = (
            torch.cat([t[i] for t in parts], dim=1) for i in range(6))
        self._pending = []
        del parts, s
        cap = max(self._bucket_capacity(max(int(valid.sum()), 1)), 16)
        while True:
            with self.timer.phase("flush"):
                store, splitters, ovf = sx.kv_flush_step(
                    words, hi, lo, (prio, tie), valid, self.nparts, cap,
                    self.reduce, self.spec.sentinel_safe)
            if ovf == 0:
                self.store, self.splitters = store, splitters
                return
            cap *= 2

    def _find_words(self, words: torch.Tensor):
        with self.timer.phase("find"):
            (hi, lo, found), m = self._routed(
                lambda s, spl, q, v, p, cap: dx.kv_find_routed(
                    s, q, v, self._owners(q), p, cap), words)
            return self._values_of(hi, lo, found, m)

    def _erase_words(self, words: torch.Tensor) -> int:
        """Remove the keys; erasing never moves keys between shards, so the
        splitters stay."""
        (store, nerased), _ = self._routed(
            lambda s, spl, q, v, p, cap: dx.kv_erase_routed(
                s, q, v, self._owners(q), p, cap), words)
        self.store = store
        return nerased
