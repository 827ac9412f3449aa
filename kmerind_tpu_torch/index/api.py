"""Top-level k-mer index API — the hash count index and the shared
input path of every index.

The port of ``kmerind_tpu.index.api`` (the reference's
``bliss::index::kmer::Index`` presets, src/index/kmer_index.hpp:98-411).
An index lives on one `device` ("cuda" unless the caller names another),
as `nparts` hash-partitioned shards stacked on it — or, given a `mesh=`
(``parallel/mesh.py``) over W `torch.distributed` ranks, as nparts / W
shards on each rank's device.

Under a mesh of several ranks every method of an index is a collective:
each rank calls it, in the same order, with the same arguments.  Builds
read each rank's own byte block of the file (``parallel/multihost.py``),
and every rank runs one step per chunk of the rank with the most
(`_stream_chunks_iter`'s lockstep: a rank whose blocks are exhausted feeds
an all-invalid chunk); queries and explicit inserts take the same rows on
every rank, each rank routing its share; exports (`items`, `to_dict`,
`pairs`, the predicate scans) and answers come back whole on every rank;
npz files are written by rank 0.  Every host decision between exchanges —
bucket capacities and their overflow retries, growth, flushes,
compactions — is taken on host ints reduced over the ranks, so all ranks
take the same branch.  One process without a mesh behaves as before.

Host-side responsibilities (this file): parsing files, cutting the base
stream into fixed-shape chunks with a k-1 halo and each chunk into one
piece per shard, feeding them to the device double-buffered (a worker
thread parses and marshals chunk i+1 while the main thread copies chunk i
to the device and launches its work), and the run-list (LSM) bookkeeping.
Device work is in ``distributed.py`` / ``store.py``.
"""

from __future__ import annotations

import concurrent.futures
import math

import numpy as np
import torch

from .. import alphabets
from ..io.batch import ReadBatch
from ..io.fasta import parse_fasta
from ..io.files import (file_size, read_fasta_block, read_fastq_block,
                        read_file, sniff_format)
from ..io.kmer_parsers import DeviceBases, transform_name
from ..kmer import KmerSpec
from ..ops import bitops, kernels, packing
from ..quality import ILLUMINA18
from ..ops.keys import from_numpy_u32, to_numpy_u32, to_u64
from ..parallel.mesh import Mesh
from ..parallel.multihost import (distributed_fasta_grid_context,
                                  distributed_fastq_grid_base,
                                  host_block_batch)
from ..utils.timers import PhaseTimer
from . import distributed as dx
from . import store as st

__all__ = ["CountIndex", "BimoleculeCountIndex", "PositionIndex",
           "PositionQualityIndex"]


#: the buffer dtype of an id index's per-base offsets in the record, as
#: `kernels.position_ids` takes them (the copy into int16 keeps the low 16
#: bits a short id keeps)
_ID_OFF_DTYPES = {kind: torch.empty(0, dtype=dt).numpy().dtype
                  for kind, dt in kernels.ID_OFF_DTYPES.items()}


def _next_pow2(n: int) -> int:
    return 1 << max(4, (max(n, 1) - 1).bit_length())


def _pred_mask(pred, words: torch.Tensor, counts: np.ndarray) -> np.ndarray:
    """bool[m] host mask of a user predicate over query rows:
    pred(keys int64[m, w] — the words' unsigned values, counts [m])."""
    keep = pred(to_u64(words), torch.from_numpy(counts).to(words.device))
    return torch.as_tensor(keep).cpu().numpy().astype(bool)


def _open_npz(path, kinds: tuple):
    """(the npz archive, its KmerSpec) of a saved index whose `kind` is one
    of `kinds` (the JAX package's npz formats)."""
    z = np.load(path, allow_pickle=False)
    if str(z["kind"]) not in kinds:
        raise ValueError(f"{path}: a {str(z['kind'])!r} index, not "
                         f"{' / '.join(kinds)}")
    return z, KmerSpec(int(z["k"]), alphabets.by_name(str(z["alphabet"])))


def _live_rows(a: np.ndarray, sizes: np.ndarray) -> np.ndarray:
    """The live rows a[s, :sizes[s]] of every shard s, concatenated."""
    return np.concatenate([a[s, :n] for s, n in enumerate(sizes.tolist())])


class _IndexBase:
    """Input marshalling and the build paths shared by index flavors."""

    #: streaming granularity: batches above this many bases are cut into
    #: equal padded chunks, so device memory stays bounded for any input
    default_chunk_bases = 1 << 23
    #: files above this size build by streaming byte blocks (build_stream)
    stream_threshold_bytes = 64 << 20
    #: exchange bucket headroom over an even split: the reference's
    #: all2allv ships exact per-destination counts
    #: (incremental_mxx.hpp:1087-1098); the dense exchange sizes buckets
    #: ~n/p and retries larger on overflow
    fill_factor = 1.6
    #: position-id kind the marshal adds to each chunk ("short" / "long"),
    #: None for indexes that store no ids
    id_kind = None
    #: the index stores each window's quality: the marshal copies the
    #: phred bytes to the device
    with_quality = False

    def __init__(self, spec: KmerSpec, device="cuda", canonical=True,
                 nparts: int = 1, timer: PhaseTimer | None = None,
                 mesh: Mesh | None = None):
        if mesh is None:
            if nparts < 1:
                raise ValueError(f"nparts must be >= 1, got {nparts}")
            mesh = Mesh(nparts, torch.device(device))
        elif nparts not in (1, mesh.nparts):
            raise ValueError(f"nparts={nparts} disagrees with the mesh's "
                             f"{mesh.nparts} shards")
        self.spec = spec
        #: the shard layout; with a mesh the index lives on its device
        self.mesh = mesh
        self.device = mesh.device
        self.nparts = mesh.nparts
        self.canonical = canonical
        transform_name(canonical)  # rejects unknown transforms
        self.timer = timer if timer is not None else PhaseTimer()
        self._marshal_pool: dict = {}
        #: `_pooled_id_table`'s two buffers and the one last written
        self._id_tables = [np.empty(0, np.uint64)] * 2
        self._id_gen = 0

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

    @property
    def num_shards(self) -> int:
        """Shards of the whole index, over every rank (`nparts`)."""
        return self.nparts

    def _maybe_canonicalize_queries(self, words: torch.Tensor) -> torch.Tensor:
        """Canonical presets transform queries too (transform_input on the
        query path, distributed_map_base.hpp:286-301)."""
        t = self.transform
        if t == "single":
            return words
        rc = bitops.revcomp(words, self.spec)
        if t == "xor_rev_comp":
            return words ^ rc
        less = packing.lex_less(rc, words)[:, None]
        if t == "lex_greater":
            return torch.where(less, words, rc)
        return torch.where(less, rc, words)

    def _chunk_halo(self) -> tuple[int, int]:
        """(halo, halo_left): the context bases each chunk carries after and
        before the bases it owns — the k-1 window lookahead
        (kmer_file_helper.hpp:361); the de Bruijn graph needs one more base
        on each side for the edges."""
        return self.spec.k - 1, 0

    @property
    def parse_alphabet(self):
        """The alphabet the build paths parse files with: the k-mer
        alphabet; the de Bruijn graph parses raw ASCII bytes."""
        return self.spec.alphabet

    def _shard_rows(self, rows: torch.Tensor, extra=()):
        """[m, ...] rows -> ([p_local, mq, ...] tensors, valid
        bool[p_local, mq], m): rows dealt in order to the p shards, mq per
        shard, zero-padded; each rank keeps its own shards' share of the
        rows, which every rank passes whole (the JAX package's SPMD
        queries)."""
        m, p = rows.shape[0], self.nparts
        mq = max(1, -(-m // p))
        lo, hi = self.mesh.shard_range
        valid = torch.arange(p * mq, device=rows.device) < m

        def put(a):
            a = torch.as_tensor(a).to(rows.device)
            pad = a.new_zeros((p * mq - m,) + tuple(a.shape[1:]))
            return torch.cat([a, pad]).reshape(
                (p, mq) + tuple(a.shape[1:]))[lo:hi]

        return ([put(a) for a in (rows, *extra)],
                valid.reshape(p, mq)[lo:hi], m)

    def _whole(self, t: torch.Tensor) -> torch.Tensor:
        """A rank's [p_local, ...] tensor -> all p shards' [p, ...] (an
        all-gather over several ranks; the shapes agree on every rank)."""
        return self.mesh.all_gather(t)

    def _replies(self, t: torch.Tensor, m: int) -> torch.Tensor:
        """Routed per-query replies [p_local, mq, ...] -> [m, ...] in query
        order, whole on every rank."""
        return self._whole(t).reshape((-1,) + tuple(t.shape[2:]))[:m]

    def _rows_of_all(self, parts) -> torch.Tensor:
        """Per-shard row sets of this rank -> every shard's, in global shard
        order (a ragged all-gather over several ranks)."""
        return self.mesh.all_gather_ragged(torch.cat(list(parts)))

    def _savez(self, path, **arrays):
        """np.savez_compressed of arrays whole on every rank: rank 0 writes
        and the others wait for it."""
        if self.mesh.rank == 0:
            np.savez_compressed(path, **arrays)
        self.mesh.barrier()

    def _chunk_capacity(self, bases: DeviceBases) -> int:
        """Exchange bucket capacity of an ingest chunk: from the longest
        chunk of any rank, so every rank's buckets agree."""
        return self._bucket_capacity(self.mesh.all_max(bases.codes.shape[1]))

    def _bucket_capacity(self, n_per_shard: int) -> int:
        """Exchange bucket capacity per (source, destination) shard pair
        for n_per_shard routed rows."""
        return _next_pow2(int(math.ceil(n_per_shard / self.nparts
                                        * self.fill_factor)))

    def _route_rows(self, step, words: torch.Tensor, extra=()):
        """Deal query rows over the shards and run step(row tensors...,
        valid, capacity) -> (*outputs, overflow), doubling the bucket
        capacity until no bucket overflows.  Returns (outputs, m)."""
        shards, vsh, m = self._shard_rows(words, extra)
        cap = self._bucket_capacity(shards[0].shape[1])
        while True:
            *out, ovf = step(*shards, vsh, cap)
            if ovf == 0:
                return out, m
            cap *= 2

    def _marshal_sources(self, batch: ReadBatch) -> list:
        """(name, per-base source column, pad fill, buffer dtype) of each
        column this index copies to the device: an id index's offsets in
        the record (`_ID_OFF_DTYPES`) and phred bytes only where the index
        stores them."""
        srcs = [(nm, a, fill, a.dtype) for nm, a, fill in (
            ("codes", batch.codes, 0), ("valid", batch.valid, False),
            ("seg_id", batch.seg_id, -1), ("owned", batch.owned, False))]
        if self.id_kind is not None:
            srcs.append(("id_off", batch.offset_in_record, 0,
                         _ID_OFF_DTYPES[self.id_kind]))
        if self.with_quality:
            srcs.append(("qual", batch.qual, 0, batch.qual.dtype))
        return srcs

    def _pooled_id_table(self, batch: ReadBatch) -> np.ndarray:
        """uint64[r]: each record's id word (`kernels.position_ids`; short
        ids: fid << 56 | (record_start & POS40) << 16, long ids: fid << 56
        | seq_index << 40 | (record_start & POS40)), composed in place into
        a pooled buffer.  Two buffers alternate, as `_marshal_bufs`'
        generations do: one is rewritten only after the copy that read it
        returned.  The phase "marshal.ids", inside "marshal" on the feeding
        thread."""
        with self.timer.phase("marshal.ids"):
            r = batch.num_records
            self._id_gen ^= 1
            buf = self._id_tables[self._id_gen]
            if buf.shape[0] < r:
                buf = self._id_tables[self._id_gen] = np.empty(
                    _next_pow2(r), np.uint64)
            out = buf[:r]
            np.copyto(out, batch.record_start, casting="unsafe")
            out &= np.uint64((1 << 40) - 1)
            if self.id_kind == "short":
                out <<= np.uint64(16)
            else:
                out |= batch.seq_index.astype(np.uint64) << np.uint64(40)
            out |= batch.file_id.astype(np.uint64) << np.uint64(56)
            return out

    def _marshal_bufs(self, pad_to: int, layout: tuple) -> dict:
        """Pooled host buffers [p, pad_to] for one chunk's per-base columns,
        alternating between two generations: the worker fills one while
        the main thread copies the other to the device."""
        key = (pad_to, layout)
        gens = self._marshal_pool.get(key)
        if gens is None:
            gens = self._marshal_pool[key] = [
                [{nm: np.empty((self.mesh.p_local, pad_to), dt)
                  for nm, dt in layout} for _ in range(2)], 0]
        gens[1] ^= 1
        return gens[0][gens[1]]

    def _marshal_chunk(self, batch: ReadBatch) -> dict:
        """Host work only (runs on the feeding thread): split a chunk's
        per-base columns over the shards into pooled buffers — the JAX
        package's `_batch_to_stacked`.  Shard s owns bases
        [s * owned, (s + 1) * owned) and also gets the `halo` bases after
        them and the `halo_left` before them (valid, not owned;
        `_chunk_halo`), so every window and its edge context lie whole on
        one shard; short shards are padded (invalid, seg_id -1).  One shard
        takes the chunk as it is: it already carries its context.  An id
        index adds "id_table", the chunk's record words
        (`_pooled_id_table`)."""
        with self.timer.phase("marshal"):
            p, n = self.mesh.p_local, batch.num_bases
            halo, halo_left = self._chunk_halo()
            owned = -(-n // p)
            srcs = self._marshal_sources(batch)
            bufs = self._marshal_bufs(
                owned + (halo_left + halo if p > 1 else 0),
                tuple((nm, dt) for nm, _, _, dt in srcs))
            for s in range(p):
                own_start = min(s * owned, n)
                lo = max(0, own_start - halo_left)
                left = own_start - lo
                ln = min(own_start + owned + halo, n) - lo
                for nm, src, fill, _ in srcs:
                    bufs[nm][s, :ln] = src[lo:lo + ln]
                    bufs[nm][s, ln:] = fill
                bufs["owned"][s, :left] = False
                bufs["owned"][s, left + owned:] = False
            if self.id_kind is not None:
                return dict(bufs, id_table=self._pooled_id_table(batch))
            return bufs

    def _to_device(self, cols: dict) -> DeviceBases:
        """Synchronous host-to-device copies (main thread) of [p, L]
        columns: the pooled buffer is rewritten two chunks later, so the
        copy must have read it by the time this returns — and must be a
        copy on the CPU too, where the multimaps keep the id columns.  An
        id index's ids are then composed on the device
        (`kernels.position_ids`, one launch) from "seg_id", the offsets
        "id_off" and the record words "id_table", which are dropped once
        read."""
        with self.timer.phase("h2d"):
            cols = dict(cols)
            table = cols.pop("id_table", None)
            dev = {nm: torch.from_numpy(a).to(self.device, copy=True)
                   for nm, a in cols.items()}
            if table is not None:
                words = torch.from_numpy(table.view(np.int64)).to(
                    self.device, copy=True)
                dev["id_hi"], dev["id_lo"] = kernels.position_ids(
                    dev["seg_id"], dev.pop("id_off"), words, self.id_kind)
            return DeviceBases(**dev)

    def _stream_chunks_iter(self, it, marshal, consume, make_dummy):
        """Double-buffered streaming over a lazy chunk iterator: the worker
        thread pulls (parses) and marshals the next chunk — host work only —
        while the main thread copies the current one to the device and
        launches.  Parser ring slots (io/native.py, two of them) stay live
        for exactly this window: block p+1 parses only after block p's
        last chunk is marshalled, and block p's slot is rewritten only by
        block p+2, after that chunk's copy returned.

        Over several ranks the loop runs in lockstep (the JAX package's
        `_stream_chunks_lockstep`): `consume` holds collectives, so before
        each chunk one all-reduced flag asks whether any rank has one left,
        and a rank that has none consumes the all-invalid batch that
        `make_dummy()` builds on first need (no owned windows: it only
        takes part in the exchanges).  With one rank the flag is the rank's
        own and no dummy is built.  The main thread's wait for the worker is
        the phase "feed_wait"."""

        def produce():
            b = next(it, None)
            return None if b is None else marshal(b)

        dummy = None
        with concurrent.futures.ThreadPoolExecutor(max_workers=1) as ex:
            fut = ex.submit(produce)
            while True:
                with self.timer.phase("feed_wait"):
                    cols = fut.result()
                if not self.mesh.all_max(cols is not None):
                    return
                if cols is None:
                    dummy = make_dummy() if dummy is None else dummy
                    cols = marshal(dummy)
                fut = ex.submit(produce)
                consume(cols)

    def _invalid_chunk(self, n: int) -> ReadBatch:
        """An all-invalid batch of n bases (no valid base, no owned window):
        what an exhausted rank feeds the lockstep loop."""
        return parse_fasta(np.zeros(0, np.uint8),
                           self.parse_alphabet).pad_to(n)

    def _query_words(self, kmers) -> torch.Tensor:
        """Query or insert rows as device key words, transformed like the
        index's own k-mers (the phase "rows")."""
        with self.timer.phase("rows"):
            return self._maybe_canonicalize_queries(
                from_numpy_u32(self._to_words(kmers), self.device))

    # -- container surface (dsc::map_base, distributed_map_base.hpp:149-302)
    def empty(self) -> bool:
        """True when no shard holds an entry."""
        return self.size() == 0

    def exists(self, kmers) -> np.ndarray:
        """bool[m] membership per query (the KmerIndex exists view,
        kmer_index.hpp:399)."""
        return self.count(kmers) > 0

    def clear(self):
        """Drop every entry and pending row, keeping the capacity
        (map_base::clear): sentinel keys, every other field zero."""
        if hasattr(self, "_pending"):
            self._pending = []
            self._pending_rows = 0
        self.store = st.cleared(self.store)
        return self

    def reserve(self, n: int):
        """Grow each shard's capacity to hold ~n entries in all
        (map_base::reserve)."""
        per = _next_pow2(-(-n // self.nparts))
        if per > self.capacity:
            self._grow(per)
        return self

    # -- build paths ---------------------------------------------------------
    def insert_batch(self, batch: ReadBatch, chunk_bases: int | None = None):
        """Insert a parsed batch's k-mers, streamed through the device in
        chunks of `chunk_bases` bases (a k-1 lookahead keeps the windows
        that span a chunk boundary; `_chunk_halo`).  Under a mesh of
        several ranks each rank passes its OWN batch (its block of the
        input, `parallel.multihost.host_block_batch`)."""
        if chunk_bases is None:
            chunk_bases = self.default_chunk_bases
        halo, halo_left = self._chunk_halo()
        if batch.num_bases > chunk_bases:
            chunks = list(batch.iter_chunks(chunk_bases, halo, halo_left))
        else:
            chunks = [batch] if batch.num_bases or self.mesh.world == 1 \
                else []
        self._stream_chunks_iter(
            iter(chunks), self._marshal_chunk, self._insert_cols,
            lambda: self._invalid_chunk(halo_left + halo + 1))
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
            if self.mesh.world > 1:
                # each rank parses only its own byte block
                halo, halo_left = self._chunk_halo()
                batch = host_block_batch(path, self.parse_alphabet,
                                         self.mesh, fmt, halo, file_id,
                                         halo_left)
            else:
                batch = read_file(path, self.parse_alphabet, fmt, file_id,
                                  reuse=True)
        return self.insert_batch(batch)

    def build_stream(self, path, fmt: str | None = None, file_id: int = 0,
                     block_bytes: int | None = None):
        """Build by streaming byte blocks of the file through the parser
        ring and the device — O(block) host memory for any corpus size
        (the reference's read_block loop, kmer_file_helper.hpp:293-331 +
        file.hpp:1216-1432).  Every chunk has one shape.

        Over W ranks the file is a grid of W * b blocks, rank r streaming
        blocks [r * b, (r + 1) * b) in lockstep with the others; a FASTA
        block's record context comes from the distributed header scan, and
        a FASTQ build that stores long ids numbers its records from the
        count of the records before the rank's range (one collective scan
        each, ``parallel/multihost.py``)."""
        fmt = fmt or sniff_format(path)
        halo, halo_left = self._chunk_halo()
        if block_bytes is None:
            # FASTQ bytes ~ 2.2x bases (quality + headers); FASTA ~ 1.01x
            block_bytes = self.default_chunk_bases * (
                2 if fmt == "fastq" else 1)
        # a block never yields more than block_bytes bases
        chunk_bases = min(self.default_chunk_bases, block_bytes)
        w, r = self.mesh.world, self.mesh.rank
        # the same on every rank: the grid is globally consistent
        bph = max(1, -(-file_size(path) // (w * block_bytes)))
        nblocks = w * bph
        alphabet = self.parse_alphabet
        ctxs, base = [None] * bph, 0
        if w > 1 and fmt == "fasta":
            ctxs = distributed_fasta_grid_context(path, bph, self.mesh)
        elif w > 1 and self.id_kind == "long":
            base = distributed_fastq_grid_base(path, bph, self.mesh)

        def chunks():
            n_records = base
            for j in range(bph):
                p = r * bph + j
                with self.timer.phase("read"):
                    if fmt == "fastq":
                        # records numbered in the file, so long ids keep
                        # file order across blocks
                        b = read_fastq_block(path, alphabet, p, nblocks,
                                             file_id=file_id, reuse=True,
                                             seq_index_base=n_records)
                        n_records += b.num_records
                    else:
                        b = read_fasta_block(path, alphabet, p, nblocks,
                                             file_id=file_id, halo=halo,
                                             halo_left=halo_left, reuse=True,
                                             context=ctxs[j])
                if b.num_bases:
                    yield from b.iter_chunks(chunk_bases, halo, halo_left)

        self._stream_chunks_iter(
            chunks(), self._marshal_chunk, self._insert_cols,
            lambda: self._invalid_chunk(halo_left + chunk_bases + halo))
        return self

    def build_posix(self, path, fmt: str | None = None, file_id: int = 0):
        """`build` under the reference's per-reader entry names
        (build_posix / build_mmap / build_mpiio, kmer_index.hpp:332-394):
        one memory-mapped reader serves all three."""
        return self.build(path, fmt, file_id)

    build_mmap = build_mpiio = build_posix

    def build_files(self, paths, fmt: str | None = None):
        """Build from several files in turn; a k-mer's file_id is its file's
        position in `paths`."""
        for fid, path in enumerate(paths):
            self.build(path, fmt, file_id=fid)
        return self

    def _checkpoint_prepare(self):
        """Bring the store to what a checkpoint holds (`utils/checkpoint`):
        every pending row flushed."""
        self._flush()


class _RunListIndex(_IndexBase):
    """The LSM (log-structured merge) run list of the count indexes and the
    de Bruijn graphs.  Each shard's store is a SMALL LIST of sorted runs,
    each run stacked [p, ...]: every ingested chunk lands as one run per
    shard, the index is queryable at once (a query visits every run and
    sums), and the two smallest runs merge (K2) whenever the list exceeds
    `max_runs`.  size() and the exports consolidate to one run first, and a
    consolidated run compacts when it is mostly duplicate or erased rows.
    Each run's query aux is cached by run identity.

    A family provides what depends on its store: `_empty_store`, `_adopt`
    (sorted columns -> one stacked run), `_merge_pair`, `_aux_step`,
    `_stats_step`, `_grow_run`, `_shard_weight`, `compact`,
    `_compact_headroom` (`_maybe_compact` sizes a compaction at
    next_pow2(headroom * the largest shard's distinct keys)) and
    `_overflow_message` (raised before a shard's int32 prefix sums wrap);
    it may hook `_ensure_tables` (tables a run builds only when read) and
    `_relieve_weight_pressure`."""

    #: weight budget before a pressure check: headroom under int32 max
    _I32_WEIGHT_GUARD = (1 << 31) - (1 << 26)

    def __init__(self, spec: KmerSpec, device, canonical, nparts: int,
                 hash_name: str, saturate: int | None, initial_capacity: int,
                 max_runs: int, timer: PhaseTimer | None, mesh: Mesh | None):
        super().__init__(spec, device, canonical, nparts, timer, mesh)
        self.hash_name = hash_name
        self.saturate = saturate
        self.initial_capacity = initial_capacity
        self.max_runs = max_runs
        #: compact when capacity >= compact_factor * the compaction target
        self.compact_factor = 4
        self.clear()

    def clear(self):
        """Drop every entry: one empty run of `initial_capacity` rows per
        shard, as a new index holds."""
        self.runs = [st.stack_stores([self._empty_store()]
                                     * self.mesh.p_local)]
        #: per-run flag: every live row has weight 1 and sentinels mark
        #: exactly the dead tail (file-ingest output) — such pairs merge
        #: without the weight column.  Only sentinel-safe specs.
        self._unit = [self.spec.sentinel_safe]
        #: the initial empty run is replaced by the first real run
        self._virgin = True
        #: upper bound on any shard's raw weight total: the int32 prefix
        #: sums would wrap past 2^31 (see _note_weight)
        self._ingested_weight = 0
        #: (run, its per-shard query aux), by run identity (`_ensure_aux`)
        self._aux_cache: list = []
        return self

    @property
    def store(self) -> list:
        """The run list, as the JAX package's `store` (its checkpoints
        flatten it); assigning a run or a list of runs adopts them
        (`adopt_runs`)."""
        return self.runs

    @store.setter
    def store(self, value):
        self.adopt_runs(list(value) if isinstance(value, (list, tuple))
                        else [value])

    @property
    def capacity(self) -> int:
        """Rows per shard over all runs."""
        return sum(r.capacity for r in self.runs)

    def _distinct(self) -> list[int]:
        """Distinct live keys per shard of every rank (one consolidated
        run)."""
        assert len(self.runs) == 1
        return self._stats_step(self.runs[0], self.mesh)

    def size(self) -> int:
        """Distinct-key count (dsc::map_base::size)."""
        return sum(self.local_sizes())

    def local_sizes(self) -> list[int]:
        """Distinct keys per shard, in global shard order (as `items` lists
        them)."""
        self._consolidate()
        return self._distinct()

    def reserve(self, n: int):
        """Grow the capacity to hold ~n rows in all (map_base::reserve):
        the last run's sentinel tail grows (weight-0 rows change no
        count)."""
        self._ensure_tables()
        per = _next_pow2(-(-n // self.nparts))
        if per > self.capacity:
            self.runs[-1] = self._grow_run(self.runs[-1], per - self.capacity)
            self._drop_stale_aux()
        return self

    def _ensure_tables(self):
        """Build the tables that runs defer until a query, export,
        compaction or save reads them (none by default)."""

    def _merge_two_smallest(self):
        order = sorted(range(len(self.runs)),
                       key=lambda i: self.runs[i].capacity, reverse=True)
        self.runs = [self.runs[i] for i in order]
        self._unit = [self._unit[i] for i in order]
        b, ub = self.runs.pop(), self._unit.pop()
        a, ua = self.runs.pop(), self._unit.pop()
        with self.timer.phase("merge"):
            self.runs.append(self._merge_pair(a, b, ua and ub))
        self._unit.append(ua and ub)
        self._drop_stale_aux()

    def _note_weight(self, add: int):
        """Account `add` incoming weight against the int32 prefix-sum
        budget of the fullest shard (the bound assumes every row may land
        on one shard); on pressure, `_relieve_weight_pressure`."""
        if self._ingested_weight + add > self._I32_WEIGHT_GUARD:
            self._relieve_weight_pressure(add)
        self._ingested_weight += add

    def _relieve_weight_pressure(self, incoming: int):
        """Tighten the bound to the true worst shard total, and raise if a
        shard's raw int32 weight total could still pass 2^31 with
        `incoming` more (the reference's uint32 counts overflow silently
        at 2^32)."""
        self._ingested_weight = self._shard_weight()
        self._check_weight(incoming)

    def _check_weight(self, incoming: int):
        if self._ingested_weight + incoming > (1 << 31) - 1:
            raise OverflowError(self._overflow_message)

    def _append_run(self, *cols, unit: bool = False):
        """Adopt a chunk's routed sorted columns as a run and apply the
        LSM bound."""
        unit = unit and self.spec.sentinel_safe
        run = self._adopt(*cols, unit=unit)
        if self._virgin:
            self.runs, self._unit, self._virgin = [run], [unit], False
        else:
            self.runs.append(run)
            self._unit.append(unit)
        while len(self.runs) > self.max_runs:
            self._merge_two_smallest()

    def adopt_runs(self, runs: list):
        """Replace the contents by already-built stacked runs ([p, ...],
        p = nparts) whose weights may be anything (e.g. converted from
        another index, `convert.py`, or a checkpoint); the LSM bound then
        applies."""
        if not runs:
            return self
        self.runs, self._virgin = list(runs), False
        self._unit = [False] * len(self.runs)
        self._drop_stale_aux()
        self._ingested_weight = self._shard_weight()
        while len(self.runs) > self.max_runs:
            self._merge_two_smallest()
        return self

    def _consolidate(self):
        """Merge every run into one (smallest pairs first) and reclaim dead
        rows if the result is mostly duplicates."""
        while len(self.runs) > 1:
            self._merge_two_smallest()
        self._maybe_compact()

    def _checkpoint_prepare(self):
        self._consolidate()
        self._ensure_tables()

    def _maybe_compact(self):
        """Compact when the store is mostly duplicate or erased rows
        (amortized O(1) per ingested row: fires only after the store has at
        least compact_factor/2-folded its live data)."""
        cap = self.capacity
        if len(self.runs) != 1 or cap <= (1 << 14):
            return
        target = _next_pow2(max(self._compact_headroom
                                * max(self._distinct()), 1 << 12))
        if cap >= self.compact_factor * target:
            self.compact(target)

    def _drop_stale_aux(self):
        """Release the cached aux of runs that left the run list (the aux
        would otherwise keep the replaced runs' memory until the next
        query)."""
        self._aux_cache = [(r, a) for r, a in self._aux_cache
                           if any(r is x for x in self.runs)]

    def _ensure_aux(self) -> list:
        """Per-run, per-shard query-aux metadata cached by run IDENTITY:
        any mutation replaces the run objects, so a stale entry cannot be
        hit."""
        out = []
        for r in self.runs:
            hit = next((a for rr, a in self._aux_cache if rr is r), None)
            if hit is None:
                with self.timer.phase("aux"):
                    hit = self._aux_step(r)
            out.append((r, hit))
        self._aux_cache = out
        return [a for _, a in out]


class _CountSurfaceMixin:
    """The Index surface (kmer_index.hpp:142-201) of the count indexes,
    shared by the hash-partitioned CountIndex and the range-partitioned
    SortedCountIndex.  A class provides `_count_words`, `_erase_words`,
    `_filter`, `_select` and `_histogram`.

    Predicates take (keys int64[n, w], counts int32[n]) and return bool[n]:
    each key word is an int64 holding its unsigned value (the store's
    int32 bit patterns would compare signed), so ``k[:, 0] >= 0x80000000``
    means what it says.  The JAX package's predicates get jnp arrays of the
    same shapes; one lambda written with operators both accept serves
    both."""

    def count(self, kmers) -> np.ndarray:
        """int32[m] per-query counts in query order (Index::count,
        kmer_index.hpp:142).  kmers: uint32[m, w] rows, strings or ints."""
        return self._count_words(self._query_words(kmers))

    get_multiplicity = count

    def find(self, kmers):
        """(words uint32[h, w], counts int32[h]) of the queries found, in
        query order, keys as stored (transformed); duplicated queries give
        duplicated pairs (Index::find, kmer_index.hpp:115-140)."""
        words = self._query_words(kmers)
        counts = self._count_words(words)
        hit = counts > 0
        return to_numpy_u32(words)[hit], counts[hit]

    def erase(self, kmers) -> int:
        """Erase the query keys; returns how many distinct keys were
        present (Index::erase, kmer_index.hpp:148)."""
        return self._erase_words(self._query_words(kmers))

    def erase_if(self, pred, kmers=None) -> int:
        """Erase the entries satisfying pred (kmer_index.hpp:153-195);
        returns how many.  With `kmers`, only those query keys whose (key,
        count) satisfies pred."""
        if kmers is None:
            return self._filter(lambda k, c: ~pred(k, c))
        words = self._query_words(kmers)
        counts = self._count_words(words)
        hits = _pred_mask(pred, words, counts) & (counts > 0)
        if not hits.any():
            return 0
        return self._erase_words(words[torch.from_numpy(hits).to(
            words.device)])

    def filter(self, pred) -> int:
        """Keep only the entries satisfying pred; returns how many were
        erased."""
        return self.erase_if(lambda k, c: ~pred(k, c))

    def count_if(self, pred, kmers=None):
        """Without kmers: [(kmer_int, count)] of every entry satisfying
        pred, shard by shard in key order.  With kmers: the per-query
        counts, 0 where pred fails."""
        if kmers is None:
            parts = self._select(pred)
            rows = to_numpy_u32(self._rows_of_all(r for r, _ in parts))
            cnts = self._rows_of_all(c for _, c in parts).cpu().numpy()
            if rows.shape[0] == 0:
                return []
            return list(zip(self.spec.to_ints(rows).tolist(),
                            cnts.astype(int).tolist()))
        words = self._query_words(kmers)
        counts = self._count_words(words)
        return np.where(_pred_mask(pred, words, counts), counts, 0)

    def find_if(self, pred, kmers=None):
        """find restricted to the entries satisfying pred: count_if(pred)
        without kmers, else (found bool[m], counts int32[m])."""
        if kmers is None:
            return self.count_if(pred)
        counts = self.count_if(pred, kmers)
        return counts > 0, counts

    def histogram(self, max_count: int = 255) -> np.ndarray:
        """int64[max_count + 1] k-mer spectrum: hist[c] = distinct k-mers of
        count c, counts above max_count in the last bin — where genome-size
        and coverage estimates start (the reference's
        utils/kmer_distribution.R over index dumps)."""
        return self._histogram(max_count + 1).cpu().numpy().astype(np.int64)

    def unique_size(self) -> int:
        """Distinct keys: size() for a unique-key map."""
        return self.size()


class CountIndex(_CountSurfaceMixin, _RunListIndex):
    """k-mer -> count index (CountIndex preset, kmer_index.hpp:409-411;
    counting_densehash_map semantics) over `nparts` hash-partitioned shards
    stacked on one device: key q lives on shard
    ``owner_from_hash(HASHES[hash_name](q), p)``.

    Each shard's store is a run list (`_RunListIndex`) of
    `store.RunCountStore` runs.  Each ingested chunk lands as one sorted
    UNIT run per shard.  Explicit (key, count) inserts land as weighted
    runs (their prefix sum is K3), and erase / filter zero the weights of
    the rows they remove (K3 again), so every later merge of such a run
    carries the weights as K2's payload.  items(), histogram() and the
    predicate scans consolidate to one run first; compaction (run_compact,
    whose prefix sum is K3) collapses duplicate and erased rows when they
    dominate.

    saturate: counts clamp at this value in every reader — count, items,
    histogram, the predicates' counts and the compaction
    (saturating_counting_densehash_map, distributed_densehash_map.hpp:
    2947); the runs keep raw weights until a compaction clamps them.

    Example::

        idx = CountIndex(KmerSpec(21, DNA))       # on the CUDA device
        idx.build("reads.fastq")
        idx.count(["ACGTACGTACGTACGTACGTA"])
        spectrum = idx.histogram(255)
        idx.filter(lambda k, c: c >= 2)           # drop the singletons
        idx.save("index.npz")
    """

    _compact_headroom = 2
    _overflow_message = (
        "count index raw weight total would overflow the int32 prefix sums "
        "on a shard; use saturate= (clamped counts), more shards, or "
        "smaller insert batches")
    _stats_step = staticmethod(dx.run_stats_step)
    _aux_step = staticmethod(dx.run_aux_step)
    _grow_run = staticmethod(st.run_grow)

    def __init__(self, spec: KmerSpec, device="cuda", canonical=True,
                 initial_capacity: int = 1 << 12, max_runs: int = 8,
                 nparts: int = 1, hash_name: str = "murmur",
                 saturate: int | None = None,
                 timer: PhaseTimer | None = None, mesh: Mesh | None = None):
        super().__init__(spec, device, canonical, nparts, hash_name,
                         saturate, initial_capacity, max_runs, timer, mesh)

    def _empty_store(self):
        return st.empty_run_count_store(self.initial_capacity,
                                        self.spec.nwords, self.device)

    def _adopt(self, words, weights, unit: bool):
        return dx.run_adopt_step(words, weights, unit=unit)

    def _merge_pair(self, a, b, unit: bool):
        """One LSM level merge of two stacked runs (K2)."""
        return dx.run_merge_pair_step(a, b, unit=unit)

    def _shard_weight(self) -> int:
        """The largest shard's raw weight total over all runs."""
        return self.mesh.all_max(int(sum(r.csum[:, -1].to(torch.int64)
                                         for r in self.runs).max()))

    def _relieve_weight_pressure(self, incoming: int):
        """A saturating map compacts with the clamp (exact,
        `store.run_compact`), rebounds from its distinct counts and raises
        if that is still too much; a plain map tightens the bound to the
        true worst shard total and raises (`_RunListIndex`)."""
        if self.saturate is None or self._virgin:
            return super()._relieve_weight_pressure(incoming)
        self.compact()
        self._ingested_weight = max(self._distinct()) * int(self.saturate)
        self._check_weight(incoming)

    def compact(self, new_cap: int | None = None):
        """Consolidate to one run, collapse every key's rows to one
        (key, count) row — clamped at `saturate` — and shrink each shard's
        capacity to new_cap (default: next_pow2(2 * the largest shard's
        distinct count))."""
        while len(self.runs) > 1:
            self._merge_two_smallest()
        if new_cap is None:
            new_cap = _next_pow2(max(2 * max(self._distinct()), 16))
        while True:
            with self.timer.phase("compact"):
                new_store, ovf = self._compact_step(new_cap)
            if ovf == 0:
                self.runs, self._unit = [new_store], [False]
                self._drop_stale_aux()
                return self
            new_cap = _next_pow2(new_cap + ovf)

    def _compact_step(self, new_cap: int):
        """(the one run compacted to new_cap rows, overflow)."""
        return dx.run_compact_step(self.runs[0], new_cap, self.saturate,
                                   self.mesh)

    # ------------------------------------------------------------------
    def _insert_cols(self, cols: dict):
        bases = self._to_device(cols)
        cap = self._chunk_capacity(bases)
        with self.timer.phase("insert"):
            while True:
                rw, rwt, ovf = dx.run_ingest_step(
                    bases, self.spec, self.canonical, self.mesh, cap,
                    self.hash_name)
                if ovf == 0:
                    break
                cap = _next_pow2(cap + ovf)
        # a shard's share of a chunk is at most the rows it received
        self._note_weight(rw.shape[-1])
        self._append_run(rw, rwt, unit=True)
        return self

    def _insert_rows(self, words: torch.Tensor, counts: torch.Tensor):
        """Route explicit (key, count) device rows [m, w] / int32[m] to
        their owners and append them as one weighted run per shard (sorted
        with the counts as payload, adopted with the K3 prefix sum)."""
        if words.shape[0] == 0:
            return self
        self._note_weight(int(counts.sum()))
        with self.timer.phase("insert"):
            (rw, rwt), _ = self._route_rows(
                lambda w, c, v, cap: dx.run_insert_step(
                    w, c, v, self.mesh, cap, self.hash_name),
                words, extra=(counts,))
        self._append_run(rw, rwt)
        return self

    def insert(self, kmers):
        """Insert explicit k-mers, one count each (Index::insert,
        kmer_index.hpp:201)."""
        words = self._query_words(kmers)
        return self._insert_rows(words, torch.ones(
            words.shape[0], dtype=torch.int32, device=self.device))

    def insert_counts(self, kmers, counts):
        """Insert (kmer, count) pairs — the counting map's second input
        flavor (counting_densehash_map insert of ::std::pair<Kmer, T>,
        distributed_densehash_map.hpp:2669+).  Counts are non-negative
        int32 values (the reference's counts are unsigned)."""
        words = self._query_words(kmers)
        c = np.asarray(counts, dtype=np.int64).reshape(-1)
        if c.shape[0] != words.shape[0]:
            raise ValueError("kmers and counts length mismatch")
        if c.size and (c.min() < 0 or c.max() > (1 << 31) - 1):
            raise ValueError("counts must be non-negative int32 values")
        return self._insert_rows(words, torch.from_numpy(
            c.astype(np.int32)).to(self.device))

    def _count_words(self, words: torch.Tensor) -> np.ndarray:
        aux = self._ensure_aux()
        with self.timer.phase("count"):
            with self.timer.phase("count.lookup"):
                (counts,), m = self._route_rows(
                    lambda q, v, cap: dx.runs_count_query_step(
                        q, v, aux, self.mesh, cap, self.hash_name,
                        self.saturate), words)
            with self.timer.phase("count.reply"):
                return self._replies(counts, m).cpu().numpy()

    def _erase_words(self, words: torch.Tensor) -> int:
        """Zero every row of the query keys in every run; the runs stop
        being unit runs (a keys-only merge would revive the dead rows)."""
        aux = self._ensure_aux()
        with self.timer.phase("erase"):
            (runs, nerased), _ = self._route_rows(
                lambda q, v, cap: dx.runs_erase_step(
                    self.runs, aux, q, v, self.mesh, cap, self.hash_name),
                words)
        self.runs, self._unit = runs, [False] * len(runs)
        self._drop_stale_aux()
        return nerased

    def _filter(self, keep_pred) -> int:
        self._consolidate()
        with self.timer.phase("filter"):
            store, nerased = dx.run_filter_step(self.runs[0], keep_pred,
                                                self.saturate, self.mesh)
        self.runs, self._unit = [store], [False]
        self._drop_stale_aux()
        return nerased

    def _select(self, pred) -> list:
        self._consolidate()
        return dx.run_select_step(self.runs[0], pred, self.saturate)

    def _histogram(self, nbins: int) -> torch.Tensor:
        self._consolidate()
        return dx.run_histogram_step(self.runs[0], nbins, self.saturate,
                                     self.mesh)

    def items(self) -> tuple[np.ndarray, np.ndarray]:
        """(words uint32[t, w], counts int64[t]) — every distinct live entry,
        shard by shard, each shard in key order, counts clamped at
        `saturate` (to_vector analog, distributed_map_base.hpp:202-217)."""
        self._consolidate()
        parts = [st.run_select(self.runs[0].shard(s), saturate=self.saturate)
                 for s in range(self.mesh.p_local)]
        return (to_numpy_u32(self._rows_of_all(k for k, _ in parts)),
                self._rows_of_all(c for _, c in parts).cpu().numpy().astype(
                    np.int64))

    def to_dict(self) -> dict[int, int]:
        """Full contents as {kmer_int: count} (host-side; tests/tools)."""
        rows, cnts = self.items()
        if rows.shape[0] == 0:
            return {}
        return dict(zip(self.spec.to_ints(rows).tolist(), cnts.tolist()))

    # -- persistence: the JAX package's npz format ----------------------
    def save(self, path):
        """One npz file of the contents (one row per distinct key, counts
        clamped) and the config, in the JAX package's format: either
        package loads it, at any shard count."""
        rows, cnts = self.items()
        self._savez(
            path, kind="count", k=self.spec.k,
            alphabet=self.spec.alphabet.name, canonical=self.canonical,
            hash_name=self.hash_name,
            saturate=-1 if self.saturate is None else self.saturate,
            nparts=self.nparts, rows=rows, row_counts=cnts)
        return self

    @classmethod
    def load(cls, path, device="cuda", nparts: int = 1, mesh=None):
        """An index of `nparts` shards (or over `mesh`) holding a saved
        index's contents (saved at any shard count, by either package): the
        stored keys — already transformed — go back in through the insert
        path without another transform."""
        z, spec = _open_npz(path, ("count",))
        sat = int(z["saturate"])
        idx = cls(spec, device, canonical=bool(z["canonical"]),
                  nparts=nparts, hash_name=str(z["hash_name"]),
                  saturate=None if sat < 0 else sat, mesh=mesh)
        rows = z["rows"]
        if rows.shape[0]:
            idx._insert_rows(from_numpy_u32(rows, idx.device),
                             torch.from_numpy(z["row_counts"].astype(
                                 np.int32)).to(idx.device))
        return idx


class BimoleculeCountIndex(CountIndex):
    """k-mer -> count index with the Bimolecule map preset
    (kmer_index.hpp:436-562; ``kmerind_tpu.index.api.
    BimoleculeCountIndex``): keys are hashed and compared canonically —
    both strands of a k-mer answer the same entry, counts are the canonical
    CountIndex's — but each key is REPORTED in the input orientation of its
    earliest occurrence (file order; explicit inserts after every file
    occurrence), like the reference's hash table keeping the first-inserted
    key.  `items`, `to_dict` and `find` return that orientation; `count_if`
    and predicates see the canonical keys, as in the JAX package.

    The store is ONE `store.RunBimolStore` per shard: canonical keys sorted
    with duplicates, weights, the count prefix sum (K3) and each row's
    64-bit occurrence id and strand.  Ingested chunks (K1, whose was_rc
    flag is the strand; ids of the long kind, `id_kind`) and explicit
    inserts wait as sorted runs until `flush_rows` rows wait or a query
    comes; `_flush` then merges them and the store two smallest first (K2
    with 4 payloads: weight, id halves, strand) — merging each into the
    store one at a time would double its capacity per run.  A key's stored
    orientation is the strand of its live row with the smallest id
    (`store.run_bimol_min_rep`).

    Example::

        idx = BimoleculeCountIndex(KmerSpec(21, DNA))   # on the CUDA device
        idx.build("reads.fastq")
        words, counts = idx.find(["ACGTACGTACGTACGTACGTA"])  # as stored
        idx.to_dict()                       # {stored-orientation int: count}
    """

    id_kind = "long"

    def __init__(self, spec: KmerSpec, device="cuda",
                 initial_capacity: int = 1 << 12, nparts: int = 1,
                 hash_name: str = "murmur", saturate: int | None = None,
                 timer: PhaseTimer | None = None, mesh: Mesh | None = None):
        super().__init__(spec, device, canonical=True,
                         initial_capacity=initial_capacity, max_runs=1,
                         nparts=nparts, hash_name=hash_name,
                         saturate=saturate, timer=timer, mesh=mesh)
        #: pending rows per shard that trigger a flush while building
        self.flush_rows = 1 << 24
        #: ids of explicitly inserted k-mers rank after every file
        #: occurrence id (file ids use at most 63 bits)
        self._insert_seq = 1 << 63

    _overflow_message = (
        "Bimolecule raw weight total would overflow the int32 prefix sums "
        "on a shard; use saturate=, more shards, or smaller insert batches")

    def clear(self):
        """Drop every entry and pending run: one empty run of
        `initial_capacity` rows per shard."""
        super().clear()
        self._unit = [False]
        self._strand_cache = None
        self._pending: list = []
        self._pending_rows = 0
        return self

    def _empty_store(self):
        return st.empty_run_bimol_store(self.initial_capacity,
                                        self.spec.nwords, self.device)

    # -- the run list: pending runs, one consolidated store -------------
    @property
    def store(self) -> st.RunBimolStore:
        """The one consolidated stacked run (pending runs wait apart), as
        the JAX package's `store`; assigning one adopts it."""
        return self.runs[0]

    @store.setter
    def store(self, value):
        self.adopt_runs([value])

    def _merge_pair(self, a, b, unit: bool):
        return dx.run_bimol_merge_pair_step(a, b)

    def _compact_step(self, new_cap: int):
        """A compaction whose representative minimum is made first, in the
        phase "bimol.min_rep" (launches only)."""
        with self.timer.phase("bimol.min_rep"):
            reps = dx.run_bimol_min_rep_step(self.runs[0])
        return dx.run_bimol_compact_step(self.runs[0], new_cap,
                                         self.saturate, self.mesh, reps)

    def _flush(self):
        """Adopt every pending run (K3) and merge them and the store, two
        smallest first (K2), into one run per shard: the phase
        "bimol.flush" when rows wait (its `merge` phases inside it), which
        ends on `_maybe_compact`'s distinct-key read."""
        if not self._pending:
            return
        with self.timer.phase("bimol.flush"):
            runs = [dx.run_bimol_adopt_step(*rc) for rc in self._pending]
            self._pending, self._pending_rows = [], 0
            self.runs = runs if self._virgin else self.runs + runs
            self._unit, self._virgin = [False] * len(self.runs), False
            while len(self.runs) > 1:
                self._merge_two_smallest()
            self._drop_stale_aux()
            self._maybe_compact()

    def _consolidate(self):
        self._flush()
        self._maybe_compact()

    def _checkpoint_prepare(self):
        self._flush()

    def compact(self, new_cap: int | None = None):
        """Flush, then collapse every key's rows to one (key, total,
        minimum representative) row at capacity new_cap (see
        `CountIndex.compact`)."""
        self._flush()
        return super().compact(new_cap)

    def _drop_stale_aux(self):
        super()._drop_stale_aux()
        if self._strand_cache is not None and \
                self._strand_cache[0] is not self.runs[0]:
            self._strand_cache = None

    def _relieve_weight_pressure(self, incoming: int):
        """The JAX package's guard: tighten the bound to the true worst
        shard total; if that is still too much, a saturating map compacts
        with the clamp and rebounds from size() * saturate; else raise
        before the int32 prefix sums can wrap."""
        self._ingested_weight = self._shard_weight()
        if self._ingested_weight + incoming > (1 << 31) - 1 and \
                self.saturate is not None:
            self.compact()
            self._ingested_weight = self.size() * int(self.saturate)
        self._check_weight(incoming)

    def _add_pending(self, run):
        self._pending.append(tuple(run))
        self._pending_rows += run[0].shape[-1]
        if self._pending_rows >= self.flush_rows:
            self._flush()
        return self

    # -- build and inserts --------------------------------------------------
    def _insert_cols(self, cols: dict):
        bases = self._to_device(cols)
        cap = self._chunk_capacity(bases)
        with self.timer.phase("insert"):
            while True:
                *run, ovf = dx.bimol_ingest_step(bases, self.spec,
                                                 self.mesh, cap,
                                                 self.hash_name)
                if ovf == 0:
                    break
                cap = _next_pow2(cap + ovf)
        self._note_weight(run[0].shape[-1])
        return self._add_pending(run)

    def _insert_tuples(self, canon, weights, id_hi, id_lo, strand):
        """Route explicit (canonical key, weight, id halves, strand) device
        rows to their owners as one pending run per shard."""
        if canon.shape[0] == 0:
            return self
        self._flush()
        self._note_weight(int(weights.sum()))
        with self.timer.phase("insert"):
            run, _ = self._route_rows(
                lambda w, wt, h, lo, s, v, cap: dx.bimol_tuples_step(
                    w, wt, h, lo, s, v, self.mesh, cap, self.hash_name),
                canon, extra=(weights, id_hi, id_lo, strand))
        return self._add_pending(run)

    def _insert_explicit(self, kmers, weights: np.ndarray | None):
        """Input-strand k-mers -> canonical rows remembering their strand,
        with ids from `_insert_seq` on (first insertion wins)."""
        raw = from_numpy_u32(self._to_words(kmers), self.device)
        canon = self._maybe_canonicalize_queries(raw)
        m = raw.shape[0]
        ids = np.arange(m, dtype=np.uint64) + np.uint64(self._insert_seq)
        self._insert_seq += m
        if weights is None:
            weights = np.ones(m, np.int32)
        put = lambda a: torch.from_numpy(a).to(self.device)  # noqa: E731
        return self._insert_tuples(
            canon, put(weights),
            from_numpy_u32((ids >> np.uint64(32)).astype(np.uint32),
                           self.device),
            from_numpy_u32(ids.astype(np.uint32), self.device),
            (raw != canon).any(dim=1).to(torch.int32))

    def insert(self, kmers):
        """Insert input-strand k-mers, one count each: stored canonically,
        their orientation remembered (the first insertion of a key wins)."""
        return self._insert_explicit(kmers, None)

    def insert_counts(self, kmers, counts):
        """Insert (input-strand k-mer, count) pairs; counts are
        non-negative int32 values."""
        c = np.asarray(counts, dtype=np.int64).reshape(-1)
        if c.size and (c.min() < 0 or c.max() > (1 << 31) - 1):
            raise ValueError("counts must be non-negative int32 values")
        return self._insert_explicit(kmers, c.astype(np.int32))

    # -- queries --------------------------------------------------------
    def _count_words(self, words: torch.Tensor) -> np.ndarray:
        self._flush()
        return super()._count_words(words)

    def _erase_words(self, words: torch.Tensor) -> int:
        self._flush()
        return super()._erase_words(words)

    def _strands(self) -> list:
        """Each shard's stored-orientation column of the run, cached by run
        identity like the query aux; built on a miss in the phase
        "bimol.strands" (launches only)."""
        if self._strand_cache is None or \
                self._strand_cache[0] is not self.runs[0]:
            with self.timer.phase("bimol.strands"):
                strands = dx.run_bimol_strands_step(self.runs[0])
            self._strand_cache = (self.runs[0], strands)
        return self._strand_cache[1]

    def _stored(self, canon: torch.Tensor, strand: torch.Tensor):
        """Canonical rows [m, w] in their stored orientation: reverse
        complemented where strand is 1."""
        rc = bitops.revcomp(canon, self.spec)
        return torch.where((strand == 1)[:, None], rc, canon)

    def find(self, kmers):
        """(words uint32[h, w] in their STORED orientation, counts
        int32[h]) of the queries found (either strand), in query order: one
        routed lookup returns each canonical query's count and stored
        strand, and flagged hits are reverse-complemented."""
        self._flush()
        canon = self._query_words(kmers)
        aux = self._ensure_aux()[0]
        strands = self._strands()
        with self.timer.phase("find"):
            (counts, strand), m = self._route_rows(
                lambda q, v, cap: dx.run_bimol_find_step(
                    q, v, aux, strands, self.mesh, cap, self.hash_name,
                    self.saturate), canon)
        counts, strand = self._replies(counts, m), self._replies(strand, m)
        hit = counts > 0
        words = self._stored(canon[hit], strand[hit])
        return to_numpy_u32(words), counts[hit].cpu().numpy()

    def items(self) -> tuple[np.ndarray, np.ndarray]:
        """(words uint32[t, w] in their stored orientation, counts
        int64[t]): every distinct live entry, shard by shard, each shard in
        canonical key order, counts clamped at `saturate`."""
        self._consolidate()
        parts = dx.run_bimol_export_step(self.runs[0], self.saturate)
        return (to_numpy_u32(self._rows_of_all(
                    self._stored(k, o) for k, _, o in parts)),
                self._rows_of_all(c for _, c, _ in parts).cpu().numpy()
                .astype(np.int64))

    # -- persistence: the JAX package's "bimol_count" npz ---------------
    def save(self, path):
        """One npz file of the compacted run — one (key, count, id,
        strand) row per distinct key, cut after the fullest shard's last
        live row — and the config, in the JAX package's format: either
        package loads it, at any shard count."""
        self.compact()
        r = self.runs[0]
        n = max(self._distinct())
        cut = lambda t: self._whole(t[..., :n])  # noqa: E731
        self._savez(
            path, kind="bimol_count", k=self.spec.k,
            alphabet=self.spec.alphabet.name, hash_name=self.hash_name,
            saturate=-1 if self.saturate is None else self.saturate,
            nparts=self.nparts, keys=to_numpy_u32(cut(r.keys)),
            weights=cut(r.weights).cpu().numpy(),
            rep_hi=to_numpy_u32(cut(r.rep_hi)),
            rep_lo=to_numpy_u32(cut(r.rep_lo)),
            rep_strand=to_numpy_u32(cut(r.rep_strand)))
        return self

    @classmethod
    def load(cls, path, device="cuda", nparts: int = 1, mesh=None):
        """An index of `nparts` shards (or over `mesh`) holding a saved
        Bimolecule index's contents: the saved rows go back in with their
        weights, ids and strands, so every stored orientation survives."""
        z, spec = _open_npz(path, ("bimol_count",))
        sat = int(z["saturate"])
        idx = cls(spec, device, nparts=nparts, hash_name=str(z["hash_name"]),
                  saturate=None if sat < 0 else sat, mesh=mesh)
        live = z["weights"] > 0
        cols = [np.concatenate([z[f][s][..., live[s]]
                                for s in range(live.shape[0])], axis=-1)
                for f in ("keys", "weights", "rep_hi", "rep_lo",
                          "rep_strand")]
        if cols[1].shape[0]:
            idx._insert_tuples(
                from_numpy_u32(cols[0].T, idx.device),
                torch.from_numpy(cols[1].astype(np.int32)).to(idx.device),
                *(from_numpy_u32(c, idx.device) for c in cols[2:]))
        return idx


# ------------------------------------------------------------------ multimaps
class _MultimapSurfaceMixin:
    """The Index surface (kmer_index.hpp:142-201) of the multimaps, shared
    by the hash-partitioned PositionIndex and the range-partitioned
    SortedPositionIndex.  A class provides `store` (a stacked
    `store.MultiStore`), `_flush`, `_insert_pairs`, `_owners` (the shard
    that owns each key row: the hash, or the splitters) and `_npz_kind`.

    Pair predicates take (keys int64[n, w], id_hi int64[n], id_lo int64[n],
    qual float32[n]) and return bool[n]; query predicates (count_if /
    find_if with kmers) take (keys int64[m, w], counts int32[m]).  Every
    key word and id half is an int64 holding its unsigned value."""

    def _init_multimap(self, id_kind: str, initial_capacity: int, codec):
        if id_kind not in ("short", "long"):
            raise ValueError(f"unknown id kind {id_kind!r}")
        self.id_kind = id_kind
        self.codec = codec if codec is not None else ILLUMINA18
        self.store = st.stack_multi_stores(
            [st.empty_multi_store(initial_capacity, self.spec.nwords,
                                  self.device)] * self.mesh.p_local)
        self._pending: list = []
        self._pending_rows = 0
        #: the store's val_q column is live: a quality index, or quals
        #: given to insert() (kept; the JAX PositionIndex drops them at its
        #: next flush, ROADMAP queue 3)
        self._has_q = self.with_quality
        self._aux_cache = None

    @property
    def capacity(self) -> int:
        """Rows per shard."""
        return self.store.capacity

    def size(self) -> int:
        """Total number of (k-mer, position) pairs."""
        self._flush()
        return self.mesh.all_sum(int(self.store.size.sum()))

    def local_sizes(self) -> list[int]:
        """Pairs per shard, in global shard order."""
        self._flush()
        return self._whole(self.store.size).tolist()

    def unique_size(self) -> int:
        """Distinct keys (map_base::unique_size)."""
        self._flush()
        return dx.unique_size_step(self.store, self.mesh)

    def insert(self, kmers, ids, quals=None):
        """Insert explicit (k-mer, position id[, quality]) pairs — the
        multimap insert of (key, T) tuples (densehash_multimap insert,
        distributed_densehash_map.hpp:2067+; sorted_multimap,
        distributed_sorted_map.hpp:2333+).  ids: uint64 position ids;
        quals: float32 per pair (0 when None)."""
        words = self._query_words(kmers)
        ids = np.asarray(ids, dtype=np.uint64).reshape(-1)
        if ids.shape[0] != words.shape[0]:
            raise ValueError("kmers and ids length mismatch")
        q = (np.zeros(ids.shape[0], np.float32) if quals is None
             else np.asarray(quals, np.float32).reshape(-1))
        self._has_q |= quals is not None
        def put(a):
            return torch.from_numpy(a).to(self.device)
        halves = ((ids >> np.uint64(32)).astype(np.uint32),
                  ids.astype(np.uint32))
        return self._insert_pairs(words, *(put(h.view(np.int32))
                                           for h in halves), put(q))

    def _ensure_aux(self) -> list:
        """Per-shard query-aux metadata (store.multi_query_aux), cached by
        store IDENTITY: every mutation replaces the store object, so a
        stale entry cannot be hit."""
        if self._aux_cache is None or self._aux_cache[0] is not self.store:
            with self.timer.phase("aux"):
                self._aux_cache = (self.store, dx.multi_aux_step(self.store))
        return self._aux_cache[1]

    def count(self, kmers) -> np.ndarray:
        """int32[m] multiplicity per query (get_multiplicity / count on the
        multimap)."""
        return self._count_words(self._query_words(kmers))

    def _count_words(self, words: torch.Tensor) -> np.ndarray:
        self._flush()
        aux = self._ensure_aux()
        with self.timer.phase("count"):
            with self.timer.phase("count.lookup"):
                (counts,), m = self._route_rows(
                    lambda w, v, cap: dx.multi_count_routed(
                        self.store, aux, w, v, self._owners(w), self.mesh,
                        cap), words)
            with self.timer.phase("count.reply"):
                return self._replies(counts, m).to(
                    torch.int32).cpu().numpy()

    get_multiplicity = count

    def find(self, kmers, max_per_query: int = 64,
             with_quality: bool = False, grow_to_fit: bool = True):
        """Per-query position-id lists: (ids uint64[m, width],
        mask bool[m, width]), with float32 qualities [m, width] between
        them when `with_quality`.

        The gather width starts at max_per_query; with grow_to_fit (the
        default) a query whose multiplicity exceeds it reruns at the next
        power of two above the largest, so nothing is cut (the reference's
        find returns every pair, distributed_densehash_map.hpp:328-420).
        With grow_to_fit=False the lists are cut at max_per_query and the
        true multiplicities int32[m] come last: counts[i] > mask[i].sum()
        means query i lost pairs."""
        return self._find_words(self._query_words(kmers), max_per_query,
                                with_quality, grow_to_fit)

    def _find_words(self, words: torch.Tensor, max_per_query: int = 64,
                    with_quality: bool = False, grow_to_fit: bool = True):
        """Spans: "find" a gather width tried, inside it "find.lookup"
        (the routed gather and the counts' read) and, at the width that
        holds every pair, "find.reply" (the answer's copies to the host
        and the ids composed there)."""
        self._flush()
        aux = self._ensure_aux()
        while True:
            with self.timer.phase("find"):
                with self.timer.phase("find.lookup"):
                    (hi, lo, q, mask, nfound), m = self._route_rows(
                        lambda w, v, cap: dx.multi_find_routed(
                            self.store, aux, w, v, self._owners(w),
                            self.mesh, cap, max_per_query), words)
                    counts = self._replies(nfound, m).to(
                        torch.int32).cpu().numpy()
                worst = int(counts.max()) if m else 0
                if grow_to_fit and worst > max_per_query:
                    max_per_query = _next_pow2(worst)
                    continue
                with self.timer.phase("find.reply"):
                    rows = lambda t: self._replies(t, m)  # noqa: E731
                    ids = ((to_numpy_u32(rows(hi)).astype(np.uint64)
                            << np.uint64(32))
                           | to_numpy_u32(rows(lo)).astype(np.uint64))
                    out = (ids,) + ((rows(q).cpu().numpy(),) if with_quality
                                    else ())
                    out += (rows(mask).to(torch.bool).cpu().numpy(),)
                return out if grow_to_fit else out + (counts,)

    def erase(self, kmers) -> int:
        """Remove ALL pairs whose key matches a query k-mer; returns the
        number of erased pairs (Index::erase, kmer_index.hpp:148)."""
        return self._erase_words(self._query_words(kmers))

    def _erase_words(self, words: torch.Tensor, pred=None) -> int:
        self._flush()
        aux = self._ensure_aux()
        with self.timer.phase("erase"):
            (store, nerased), _ = self._route_rows(
                lambda w, v, cap: dx.multi_erase_routed(
                    self.store, aux, w, v, self._owners(w), self.mesh, cap,
                    pred), words)
        self.store = store
        return nerased

    def erase_if(self, pred, kmers=None) -> int:
        """Erase the pairs satisfying the pair predicate; with `kmers`, only
        pairs of those (transformed) query keys.  Returns how many pairs
        (erase_if, kmer_index.hpp:187-195)."""
        if kmers is not None:
            return self._erase_words(self._query_words(kmers), pred)
        self._flush()
        with self.timer.phase("filter"):
            self.store, nerased = dx.multi_filter_step(
                self.store, lambda k, h, l, q: ~pred(k, h, l, q), self.mesh)
        return nerased

    def filter(self, pred) -> int:
        """Keep only the pairs satisfying the pair predicate; returns how
        many were erased."""
        return self.erase_if(lambda k, h, l, q: ~pred(k, h, l, q))

    def count_if(self, pred, kmers=None):
        """Without kmers: sorted [(kmer_int, n)] of every key with n >= 1
        pairs satisfying the pair predicate (count_if(pred),
        kmer_index.hpp:181).  With kmers: per-query multiplicities, 0 where
        the query predicate fails (kmer_index.hpp:175)."""
        if kmers is not None:
            words = self._query_words(kmers)
            counts = self._count_words(words)
            return np.where(_pred_mask(pred, words, counts), counts, 0)
        self._flush()
        parts = dx.multi_select_step(self.store, pred)
        rows = to_numpy_u32(self._rows_of_all(r for r, _ in parts))
        matches = self._rows_of_all(n for _, n in parts).cpu().numpy()
        out: dict = {}
        if rows.shape[0]:
            # a key may straddle two range shards: sum its matches
            for v, n in zip(self.spec.to_ints(rows).tolist(),
                            matches.tolist()):
                out[v] = out.get(v, 0) + n
        return sorted(out.items())

    def find_if(self, pred, kmers=None, max_per_query: int = 64):
        """find restricted by the predicate (find_if, kmer_index.hpp:
        157-170): count_if(pred) without kmers, else (ids, mask) with the
        queries failing pred(words, counts) masked out."""
        if kmers is None:
            return self.count_if(pred)
        words = self._query_words(kmers)
        ids, mask = self._find_words(words, max_per_query)
        keep = _pred_mask(pred, words, mask.sum(axis=1).astype(np.int32))
        return ids, mask & keep[:, None]

    def pairs(self) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
        """(kmer ints, position ids uint64, qualities float32) of every
        stored pair, shard by shard, each shard in key order — the
        vectorized host export behind `to_dict`."""
        self._flush()
        keys, hi, lo = (to_numpy_u32(self._whole(t)) for t in (
            self.store.keys, self.store.val_hi, self.store.val_lo))
        q = self._whole(self.store.val_q).cpu().numpy()
        sizes = self._whole(self.store.size).cpu().numpy().tolist()
        rows = np.concatenate([keys[s][:, :n].T for s, n in enumerate(sizes)])
        take = lambda a: np.concatenate(  # noqa: E731
            [a[s, :n] for s, n in enumerate(sizes)])
        ids = ((take(hi).astype(np.uint64) << np.uint64(32))
               | take(lo).astype(np.uint64))
        return self.spec.to_ints(rows), ids, take(q)

    def to_dict(self) -> dict:
        """Full contents: {kmer_int: sorted position ids}, or with quality
        {kmer_int: sorted [(position id, quality), ...]} (tests/tools)."""
        ints, ids, qs = self.pairs()
        vals = (zip(ids.tolist(), qs.tolist()) if self.with_quality
                else ids.tolist())
        out: dict = {}
        for v, val in zip(ints.tolist(), vals):
            out.setdefault(v, []).append(val)
        return {k: sorted(v) for k, v in out.items()}

    # -- persistence: the JAX package's npz formats ---------------------
    def save(self, path):
        """One npz file of every pair, shard by shard, and the config, in
        the JAX package's format (keys [p, cap, w] row-major, id halves
        uint32): either package loads it, at any shard count."""
        self._flush()
        s = self.store
        host = lambda t: to_numpy_u32(self._whole(t))  # noqa: E731
        extra = ({"hash_name": self.hash_name} if hasattr(self, "hash_name")
                 else {})
        self._savez(
            path, kind=self._npz_kind, k=self.spec.k,
            alphabet=self.spec.alphabet.name, canonical=self.canonical,
            id_kind=self.id_kind, with_quality=self.with_quality,
            nparts=self.nparts, keys=host(s.keys).transpose(0, 2, 1),
            val_hi=host(s.val_hi), val_lo=host(s.val_lo),
            val_q=self._whole(s.val_q).cpu().numpy(),
            sizes=self._whole(s.size).cpu().numpy(), **extra)
        return self

    @classmethod
    def load(cls, path, device="cuda", nparts: int = 1, mesh=None):
        """An index of `nparts` shards (or over `mesh`) holding a saved
        multimap's pairs (saved at any shard count, by either package); the
        stored keys are already transformed and go back in without another
        transform."""
        z, spec = _open_npz(path, (cls._npz_kind,))
        extra = ({"hash_name": str(z["hash_name"])}
                 if "hash_name" in z.files else {})
        idx = cls(spec, device, canonical=bool(z["canonical"]),
                  nparts=nparts, id_kind=str(z["id_kind"]), mesh=mesh,
                  **extra)
        sizes = z["sizes"]
        rows = _live_rows(z["keys"], sizes)
        if rows.shape[0]:
            q = _live_rows(z["val_q"], sizes).astype(np.float32)
            idx._has_q |= bool(q.any())
            idx._insert_pairs(
                from_numpy_u32(rows, idx.device),
                *(from_numpy_u32(_live_rows(z[f], sizes), idx.device)
                  for f in ("val_hi", "val_lo")),
                torch.from_numpy(q).to(idx.device))
        return idx


class PositionIndex(_MultimapSurfaceMixin, _IndexBase):
    """k-mer -> position ids multimap (PositionIndex preset,
    kmer_index.hpp:399-404; densehash_multimap semantics) over `nparts`
    hash-partitioned shards stacked on one device.

    Ingested chunks wait as pending owner-resident tuples; once
    `flush_rows` rows wait, and before any query, `_flush` sorts them and
    merges them into each shard's sorted store (K2, with the id halves —
    and the quality — as payloads).

    id_kind: "short" (FASTQ reads, ShortSequenceKmerId) or "long" (FASTA,
    LongSequenceKmerId), as the reference's parser presets choose
    (kmer_parser.hpp:304+).

    Example::

        idx = PositionIndex(KmerSpec(21, DNA))    # on the CUDA device
        idx.build("reads.fastq")
        ids, mask = idx.find(["ACGTACGTACGTACGTACGTA"])
    """

    _npz_kind = "position"

    def __init__(self, spec: KmerSpec, device="cuda", canonical=False,
                 nparts: int = 1, hash_name: str = "murmur",
                 id_kind: str = "short", initial_capacity: int = 1 << 12,
                 codec=None, timer: PhaseTimer | None = None,
                 mesh: Mesh | None = None):
        super().__init__(spec, device, canonical, nparts, timer, mesh)
        self.hash_name = hash_name
        self._init_multimap(id_kind, initial_capacity, codec)
        #: pending rows that trigger a flush while building
        self.flush_rows = 1 << 24

    def _flush(self):
        """Merge every pending tuple into the store, growing each shard's
        capacity to fit (next power of two): the phase "flush", its K2
        merge the phase "merge" inside it."""
        if not self._pending:
            return
        with self.timer.phase("flush"):
            words, hi, lo, q, valid = dx.concat_pending(self._pending,
                                                        self._has_q)
            self._pending, self._pending_rows = [], 0
            need = self.mesh.all_max(int((self.store.size
                                          + valid.sum(dim=1)).max()))
            if need > self.capacity:
                self._grow(_next_pow2(need))
            with self.timer.phase("merge"):
                while True:
                    store, ovf = dx.multi_merge_step(
                        self.store, words, hi, lo, q, valid,
                        self.spec.sentinel_safe, self.mesh)
                    if ovf == 0:
                        self.store = store
                        return
                    self._grow(_next_pow2(self.capacity + ovf))

    def _grow(self, new_cap: int):
        self.store = st.multi_grow(self.store, new_cap)

    def _insert_cols(self, cols: dict):
        bases = self._to_device(cols)
        cap = self._chunk_capacity(bases)
        with self.timer.phase("insert"):
            while True:
                *tup, ovf = dx.multi_ingest_step(
                    bases, self.spec, self.canonical, self.mesh, cap,
                    self.hash_name, self.with_quality, self.codec)
                if ovf == 0:
                    break
                cap = _next_pow2(cap + ovf)
        self._pending.append(tuple(tup))
        self._pending_rows += tup[0].shape[1]
        if self._pending_rows >= self.flush_rows:
            self._flush()
        return self

    def _insert_pairs(self, words, val_hi, val_lo, val_q):
        """Insert explicit (key, id halves, quality) device rows through the
        owner exchange and one sort per shard."""
        self._flush()
        need = -(-(self.size() + words.shape[0]) // self.nparts)
        if need > self.capacity:
            self._grow(_next_pow2(need))
        (wsh, hsh, lsh, qsh), vsh, _ = self._shard_rows(
            words, extra=(val_hi, val_lo, val_q))
        cap = self._bucket_capacity(wsh.shape[1])
        while True:
            store, route_ovf, store_ovf = dx.multi_insert_step(
                self.store, wsh, hsh, lsh, qsh, vsh, self.mesh, cap,
                self.hash_name)
            if route_ovf == 0 and store_ovf == 0:
                self.store = store
                return self
            cap *= 2
            if store_ovf:
                self._grow(self.capacity * 2)

    def _owners(self, words):
        """Owner shard per key row (KeyToRank)."""
        return dx.owners_for(words, self.nparts, self.hash_name)


class PositionQualityIndex(PositionIndex):
    """k-mer -> (position id, windowed quality) multimap — the
    PositionQualityIndex preset (kmer_index.hpp:406;
    KmerPositionQualityTupleParser, kmer_parser.hpp:578+).  Each window's
    quality is `quality.window_quality` of its phred bytes under `codec`;
    find(..., with_quality=True) returns (ids, qualities, mask)."""

    with_quality = True
