"""Top-level k-mer index API — the hash count index and the shared
input path of every index.

The port of ``kmerind_tpu.index.api`` (the reference's
``bliss::index::kmer::Index`` presets, src/index/kmer_index.hpp:98-411).
An index lives on the one `device` the caller names (no auto-selection),
as `nparts` shards stacked on it; `CountIndex` has one shard so far.

Host-side responsibilities (this file): parsing files, cutting the base
stream into fixed-shape chunks with a k-1 halo and each chunk into one
piece per shard, feeding them to the device double-buffered (a worker
thread parses and marshals chunk i+1 while the main thread copies chunk i
to the device and launches its work), and the run-list (LSM) bookkeeping.
Device work is in ``distributed.py`` / ``store.py``.
"""

from __future__ import annotations

import concurrent.futures

import numpy as np
import torch

from ..io.batch import ReadBatch
from ..io.files import (file_size, read_fasta_block, read_fastq_block,
                        read_file, sniff_format)
from ..io.kmer_parsers import DeviceBases, transform_name
from ..kmer import KmerSpec
from ..ops import bitops, packing
from ..ops.keys import from_numpy_u32, to_numpy_u32
from ..utils.timers import PhaseTimer
from . import distributed as dx
from . import store as st

__all__ = ["CountIndex"]


def _next_pow2(n: int) -> int:
    return 1 << max(4, (max(n, 1) - 1).bit_length())


class _IndexBase:
    """Input marshalling and the build paths shared by index flavors."""

    #: streaming granularity: batches above this many bases are cut into
    #: equal padded chunks, so device memory stays bounded for any input
    default_chunk_bases = 1 << 23
    #: files above this size build by streaming byte blocks (build_stream)
    stream_threshold_bytes = 64 << 20

    def __init__(self, spec: KmerSpec, device, canonical=True,
                 nparts: int = 1, timer: PhaseTimer | None = None):
        if nparts < 1:
            raise ValueError(f"nparts must be >= 1, got {nparts}")
        self.spec = spec
        self.device = torch.device(device)
        self.nparts = nparts
        self.canonical = canonical
        transform_name(canonical)  # rejects transforms not ported yet
        self.timer = timer if timer is not None else PhaseTimer()
        self._marshal_pool: dict = {}

    # -- input marshalling -------------------------------------------------
    def _to_words(self, kmers) -> np.ndarray:
        """uint32[m, w] rows from uint32[m, w] rows, an iterable of strings,
        or big ints (spec.to_int values)."""
        if hasattr(kmers, "shape") and getattr(kmers, "ndim", 0) == 2:
            return np.asarray(kmers).astype(np.uint32)
        rows = []
        for km in kmers:
            if isinstance(km, str):
                rows.append(self.spec.from_string(km))
            elif isinstance(km, (int, np.integer)):
                rows.append(self.spec.from_int(int(km)))
            else:
                rows.append(np.asarray(km, dtype=np.uint32))
        return np.stack(rows).astype(np.uint32)

    @property
    def transform(self) -> str:
        return transform_name(self.canonical)

    def _maybe_canonicalize_queries(self, words: torch.Tensor) -> torch.Tensor:
        """Canonical presets transform queries too (transform_input on the
        query path, distributed_map_base.hpp:286-301)."""
        if self.transform == "single":
            return words
        rc = bitops.revcomp(words, self.spec)
        return torch.where(packing.lex_less(rc, words)[:, None], rc, words)

    def _shard_rows(self, rows: torch.Tensor, extra=()):
        """[m, ...] rows -> ([p, mq, ...] tensors, valid bool[p, mq], m):
        rows dealt in order to the shards, mq per shard, zero-padded."""
        m, p = rows.shape[0], self.nparts
        mq = max(1, -(-m // p))
        valid = torch.arange(p * mq, device=rows.device) < m

        def put(a):
            a = torch.as_tensor(a).to(rows.device)
            pad = a.new_zeros((p * mq - m,) + tuple(a.shape[1:]))
            return torch.cat([a, pad]).reshape((p, mq) + tuple(a.shape[1:]))

        return [put(a) for a in (rows, *extra)], valid.reshape(p, mq), m

    def _marshal_bufs(self, pad_to: int) -> dict:
        """Pooled host buffers [p, pad_to] for one chunk's per-base columns,
        alternating between two generations: the worker fills one while
        the main thread copies the other to the device."""
        gens = self._marshal_pool.get(pad_to)
        if gens is None:
            layout = (("codes", np.uint8), ("valid", bool), ("owned", bool),
                      ("seg_id", np.int32))
            gens = self._marshal_pool[pad_to] = [
                [{nm: np.empty((self.nparts, pad_to), dt)
                  for nm, dt in layout} for _ in range(2)], 0]
        gens[1] ^= 1
        return gens[0][gens[1]]

    def _marshal_chunk(self, batch: ReadBatch) -> dict:
        """Host work only (runs on the feeding thread): split a chunk's
        per-base columns over the shards into pooled buffers — the JAX
        package's `_batch_to_stacked`.  Shard s owns bases
        [s * owned, (s + 1) * owned) and also gets the k-1 bases after them
        (valid, not owned), so every window lies whole on one shard; short
        shards are padded (invalid, seg_id -1).  One shard takes the chunk
        as it is: it already carries its halo."""
        with self.timer.phase("marshal"):
            p, n = self.nparts, batch.num_bases
            halo = self.spec.k - 1
            owned = -(-n // p)
            bufs = self._marshal_bufs(owned + (halo if p > 1 else 0))
            for s in range(p):
                lo = min(s * owned, n)
                ln = min(lo + owned + halo, n) - lo
                for nm, fill in (("codes", 0), ("valid", False),
                                 ("seg_id", -1), ("owned", False)):
                    bufs[nm][s, :ln] = getattr(batch, nm)[lo:lo + ln]
                    bufs[nm][s, ln:] = fill
                bufs["owned"][s, owned:] = False
            return bufs

    def _to_device(self, cols: dict) -> DeviceBases:
        """Synchronous host-to-device copies (main thread) of [p, L]
        columns: the pooled buffer is rewritten two chunks later, so the
        copy must have read it by the time this returns."""
        put = lambda a: torch.from_numpy(a).to(self.device)  # noqa: E731
        return DeviceBases(codes=put(cols["codes"]), valid=put(cols["valid"]),
                           owned=put(cols["owned"]),
                           seg_id=put(cols["seg_id"]))

    def _stream_chunks_iter(self, it, marshal, consume):
        """Double-buffered streaming over a lazy chunk iterator: the worker
        thread pulls (parses) and marshals the next chunk — host work only —
        while the main thread copies the current one to the device and
        launches.  Parser ring slots (io/native.py, two of them) stay live
        for exactly this window: block p+1 parses only after block p's
        last chunk is marshalled, and block p's slot is rewritten only by
        block p+2, after that chunk's copy returned."""

        def produce():
            b = next(it, None)
            return None if b is None else marshal(b)

        with concurrent.futures.ThreadPoolExecutor(max_workers=1) as ex:
            fut = ex.submit(produce)
            while True:
                cols = fut.result()
                if cols is None:
                    return
                fut = ex.submit(produce)
                consume(cols)

    def _query_words(self, kmers) -> torch.Tensor:
        """Query or insert rows as device key words, transformed like the
        index's own k-mers."""
        return self._maybe_canonicalize_queries(
            from_numpy_u32(self._to_words(kmers), self.device))

    # -- build paths ---------------------------------------------------------
    def insert_batch(self, batch: ReadBatch, chunk_bases: int | None = None):
        """Insert a parsed batch's k-mers, streamed through the device in
        chunks of `chunk_bases` bases (a k-1 lookahead keeps the windows
        that span a chunk boundary)."""
        if chunk_bases is None:
            chunk_bases = self.default_chunk_bases
        if batch.num_bases > chunk_bases:
            chunks = list(batch.iter_chunks(chunk_bases, self.spec.k - 1))
        else:
            chunks = [batch]
        self._stream_chunks_iter(iter(chunks), self._marshal_chunk,
                                 self._insert_cols)
        return self

    def build(self, path, fmt: str | None = None, file_id: int = 0):
        """Read a FASTQ/FASTA file and insert all its k-mers
        (Index::build_posix/build_mmap, kmer_index.hpp:201-394).  Files
        above `stream_threshold_bytes` stream block by block
        (`build_stream`); smaller ones parse whole into parser-ring views
        (reuse=True — consumed before this returns)."""
        fmt = fmt or sniff_format(path)
        if file_size(path) > self.stream_threshold_bytes:
            return self.build_stream(path, fmt, file_id)
        with self.timer.phase("read"):
            batch = read_file(path, self.spec.alphabet, fmt, file_id,
                              reuse=True)
        return self.insert_batch(batch)

    def build_stream(self, path, fmt: str | None = None, file_id: int = 0,
                     block_bytes: int | None = None):
        """Build by streaming byte blocks of the file through the parser
        ring and the device — O(block) host memory for any corpus size
        (the reference's read_block loop, kmer_file_helper.hpp:293-331 +
        file.hpp:1216-1432).  Every chunk has one shape."""
        fmt = fmt or sniff_format(path)
        halo = self.spec.k - 1
        if block_bytes is None:
            # FASTQ bytes ~ 2.2x bases (quality + headers); FASTA ~ 1.01x
            block_bytes = self.default_chunk_bases * (
                2 if fmt == "fastq" else 1)
        # a block never yields more than block_bytes bases
        chunk_bases = min(self.default_chunk_bases, block_bytes)
        nblocks = max(1, -(-file_size(path) // block_bytes))
        alphabet = self.spec.alphabet

        def chunks():
            for p in range(nblocks):
                with self.timer.phase("read"):
                    if fmt == "fastq":
                        b = read_fastq_block(path, alphabet, p, nblocks,
                                             file_id=file_id, reuse=True)
                    else:
                        b = read_fasta_block(path, alphabet, p, nblocks,
                                             file_id=file_id, halo=halo,
                                             reuse=True)
                if b.num_bases:
                    yield from b.iter_chunks(chunk_bases, halo)

        self._stream_chunks_iter(chunks(), self._marshal_chunk,
                                 self._insert_cols)
        return self


class CountIndex(_IndexBase):
    """k-mer -> count index (CountIndex preset, kmer_index.hpp:409-411;
    counting_densehash_map semantics) on one device.

    The store is a SMALL LIST of sorted runs (`store.RunCountStore`) —
    log-structured-merge discipline.  Each ingested chunk lands as one
    sorted UNIT run; the index is queryable at once (count visits every run
    and sums), and the two smallest runs merge (K2) whenever the list
    exceeds `max_runs`.  size(), items() and compact() consolidate to one
    run first; compaction (run_compact, whose prefix sum is K3) collapses
    duplicate rows when they dominate.

    Example::

        idx = CountIndex(KmerSpec(21, DNA), device="cuda")
        idx.build("reads.fastq")
        idx.count(["ACGTACGTACGTACGTACGTA"])
    """

    #: weight budget before a pressure check: headroom under int32 max
    _I32_WEIGHT_GUARD = (1 << 31) - (1 << 26)

    def __init__(self, spec: KmerSpec, device, canonical=True,
                 initial_capacity: int = 1 << 12, max_runs: int = 8,
                 nparts: int = 1, timer: PhaseTimer | None = None):
        if nparts != 1:
            raise NotImplementedError(
                "CountIndex with nparts > 1 needs owner hashing, not ported "
                "yet: ROADMAP queue 1, item 4 (SortedCountIndex takes "
                "nparts > 1)")
        super().__init__(spec, device, canonical, nparts, timer)
        self.initial_capacity = initial_capacity
        self.max_runs = max_runs
        self.runs = [st.empty_run_count_store(initial_capacity, spec.nwords,
                                              self.device)]
        #: per-run flag: every live row has weight 1 and sentinels mark
        #: exactly the dead tail (file-ingest output) — such pairs merge
        #: keys-only (st.run_merge_unit).  Only sentinel-safe specs.
        self._unit = [spec.sentinel_safe]
        #: the initial empty run is replaced by the first real run
        self._virgin = True
        #: compact when capacity >= compact_factor * next_pow2(2*distinct)
        self.compact_factor = 4
        #: upper bound on the raw weight total: the int32 prefix sums
        #: would wrap past 2^31 (see _note_weight)
        self._ingested_weight = 0
        self._aux_cache: list = []

    # ------------------------------------------------------------------
    @property
    def capacity(self) -> int:
        return sum(r.capacity for r in self.runs)

    def _distinct(self) -> int:
        assert len(self.runs) == 1
        return dx.run_stats_step(self.runs[0])

    def size(self) -> int:
        """Distinct-key count (dsc::map_base::size)."""
        self._consolidate()
        return self._distinct()

    def _merge_two_smallest(self):
        order = sorted(range(len(self.runs)),
                       key=lambda i: self.runs[i].capacity, reverse=True)
        self.runs = [self.runs[i] for i in order]
        self._unit = [self._unit[i] for i in order]
        b, ub = self.runs.pop(), self._unit.pop()
        a, ua = self.runs.pop(), self._unit.pop()
        with self.timer.phase("merge"):
            self.runs.append(dx.run_merge_pair_step(a, b, unit=ua and ub))
        self._unit.append(ua and ub)
        self._drop_stale_aux()

    def _note_weight(self, add: int):
        """Account `add` incoming weight against the int32 prefix-sum
        budget; on pressure, tighten the bound from the true run totals and
        raise before the sums can wrap (the reference's uint32 counts
        overflow silently at 2^32)."""
        if self._ingested_weight + add > self._I32_WEIGHT_GUARD:
            self._ingested_weight = sum(int(r.csum[-1]) for r in self.runs)
            if self._ingested_weight + add > (1 << 31) - 1:
                raise OverflowError(
                    "count index raw weight total would overflow the int32 "
                    "prefix sums; use smaller inputs per index")
        self._ingested_weight += add

    def _append_run(self, words, weights, unit: bool = False):
        unit = unit and self.spec.sentinel_safe
        run = dx.run_adopt_step(words, weights, unit=unit)
        if self._virgin:
            self.runs, self._unit, self._virgin = [run], [unit], False
        else:
            self.runs.append(run)
            self._unit.append(unit)
        while len(self.runs) > self.max_runs:
            self._merge_two_smallest()

    def adopt_runs(self, runs: list):
        """Replace the contents by already-built runs whose weights may be
        anything (e.g. converted from another index, `convert.py`); the
        LSM bound then applies."""
        if not runs:
            return self
        self.runs, self._virgin = list(runs), False
        self._unit = [False] * len(self.runs)
        self._ingested_weight = sum(int(r.csum[-1]) for r in self.runs)
        while len(self.runs) > self.max_runs:
            self._merge_two_smallest()
        return self

    def _consolidate(self):
        """Merge every run into one (smallest pairs first) and reclaim dead
        rows if the result is mostly duplicates."""
        while len(self.runs) > 1:
            self._merge_two_smallest()
        self._maybe_compact()

    def _maybe_compact(self):
        """Compact when the store is mostly duplicate rows (amortized O(1)
        per ingested row: fires only after the store has at least
        compact_factor/2-folded its live data)."""
        cap = self.capacity
        if len(self.runs) != 1 or cap <= (1 << 14):
            return
        target = _next_pow2(max(2 * self._distinct(), 1 << 12))
        if cap >= self.compact_factor * target:
            self.compact(target)

    def compact(self, new_cap: int | None = None):
        """Consolidate to one run, collapse every key's rows to one
        (key, count) row, and shrink capacity to new_cap (default:
        next_pow2(2 * distinct))."""
        while len(self.runs) > 1:
            self._merge_two_smallest()
        if new_cap is None:
            new_cap = _next_pow2(max(2 * self._distinct(), 16))
        while True:
            with self.timer.phase("compact"):
                new_store, ovf = dx.run_compact_step(self.runs[0], new_cap)
            if ovf == 0:
                self.runs, self._unit = [new_store], [False]
                self._drop_stale_aux()
                return self
            new_cap = _next_pow2(new_cap + ovf)

    # ------------------------------------------------------------------
    def _insert_cols(self, cols: dict):
        with self.timer.phase("insert"):
            bases = self._to_device(cols).shard(0)
            rw, rwt = dx.run_ingest_step(bases, self.spec, self.canonical,
                                         self.nparts)
        # a chunk's weight is at most its window count
        self._note_weight(rw.shape[-1])
        self._append_run(rw, rwt, unit=True)
        return self

    def _drop_stale_aux(self):
        """Release the cached aux of runs that left the run list (the aux
        would otherwise keep the replaced runs' memory until the next
        query)."""
        self._aux_cache = [(r, a) for r, a in self._aux_cache
                           if any(r is x for x in self.runs)]

    def _ensure_aux(self) -> list:
        """Per-run query-aux metadata cached by run IDENTITY: any mutation
        replaces the run objects, so a stale entry cannot be hit."""
        out = []
        for r in self.runs:
            hit = next((a for rr, a in self._aux_cache if rr is r), None)
            out.append((r, hit if hit is not None else dx.run_aux_step(r)))
        self._aux_cache = out
        return [a for _, a in out]

    def count(self, kmers) -> np.ndarray:
        """int32[m] per-query counts in query order (Index::count,
        kmer_index.hpp:142).  kmers: uint32[m, w] rows, strings or ints."""
        words = self._query_words(kmers)
        aux = self._ensure_aux()
        with self.timer.phase("count"):
            counts = dx.runs_count_query_step(words, aux, self.nparts)
            return counts.cpu().numpy()

    def items(self) -> tuple[np.ndarray, np.ndarray]:
        """(words uint32[t, w], counts int64[t]) — every distinct live entry
        in key order (to_vector analog, distributed_map_base.hpp:202-217)."""
        self._consolidate()
        _, is_last, total = st.run_totals(self.runs[0])
        emit = is_last & (total > 0)
        rows = to_numpy_u32(self.runs[0].keys[:, emit].t())
        return rows, total[emit].cpu().numpy().astype(np.int64)

    def to_dict(self) -> dict[int, int]:
        """Full contents as {kmer_int: count} (host-side; tests/tools)."""
        rows, cnts = self.items()
        if rows.shape[0] == 0:
            return {}
        return dict(zip(self.spec.to_ints(rows).tolist(), cnts.tolist()))
