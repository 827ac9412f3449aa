"""The de Bruijn graphs: `DeBruijnGraph` and `QualityDeBruijnGraph`.

The port of ``kmerind_tpu.debruijn.graph`` (the reference's de Bruijn
application, test/test/debruijn/): nodes are (canonical) k-mers, each with
9 counters [out A, C, G, T; in A, C, G, T; self] summed from the edge
bytes of the windows that hit it (de_bruijn_node_trait.hpp:186-280
`edge_counts`; `edge_exists` is the thresholded view).  Construction is
the index build with the edge byte as an extra payload
(de_bruijn_construct_engine.hpp:91-131 zips the k-mer and edge
iterators); the node store is a run list (``index/api.py``'s
`_RunListIndex`) of sorted runs (`store.RunVecStore`, p shards stacked on
one device) whose counters are prefix-sum differences.

Each chunk lands as one UNIT run per shard (K1 extracts, one sort); runs
merge (K2: the edge byte as the one payload of two unit runs, the edge
byte and the weight otherwise) when there are more than `max_runs`, and
a run's [9, cap] counter table (K3, one launch per stream) is built only
when a query, export, compaction or save needs it.  Under a mesh of
several ranks every method is a collective, as in ``index/api.py``: the
builds read each rank's block, the lazy tables are built on every rank at
the same calls, and the node queries and exports come back whole.
"""

from __future__ import annotations

import warnings

import numpy as np
import torch

from .. import alphabets
from ..io.batch import ReadBatch
from ..index import distributed as dx
from ..index import store as st
from ..index.api import _RunListIndex, _next_pow2, _open_npz
from ..kmer import KmerSpec
from ..ops.keys import from_numpy_u32, to_numpy_u32
from ..parallel.mesh import Mesh
from ..quality import ILLUMINA18
from ..utils.timers import PhaseTimer

__all__ = ["DeBruijnGraph", "QualityDeBruijnGraph"]

_DIM = 9  # out A C G T, in A C G T, self


class DeBruijnGraph(_RunListIndex):
    """De Bruijn graph over `nparts` hash-partitioned shards stacked on one
    device (`device`, "cuda" unless the caller names another).

    canonical=True mirrors the reference driver's canonical configuration
    (test_de_bruijn_graph_construction.cpp:118-131): the node is the
    canonical k-mer, and a window's edge byte is reverse-complemented when
    its reverse complement was taken, so counters are ordered for the
    canonical strand.  Files parse as raw bytes (`parse_alphabet` is
    ASCII): the k-mer sees the k-mer alphabet's code of a byte ('N' -> A
    under DNA, the window stays valid), the edge nibble its DNA16 code
    ('N' -> 0xF, all four bases).

    Example::

        g = DeBruijnGraph(KmerSpec(21, DNA))        # on the CUDA device
        g.build("reads.fastq")
        counts, found = g.node_counts(["ACGTACGTACGTACGTACGTA"])
        ins, outs = g.neighbors("ACGTACGTACGTACGTACGTA")
    """

    _npz_kind = "debruijn"
    # distinct (key, edge byte) groups are a few per node in real genomes:
    # size a compaction for 4x before giving up on shrinking
    _compact_headroom = 4
    _overflow_message = (
        "de Bruijn raw weight total would overflow the int32 prefix sums on "
        "a shard; use more shards or smaller insert batches")
    _stats_step = staticmethod(dx.run_vec_stats_step)
    _aux_step = staticmethod(dx.run_vec_aux_step)
    _grow_run = staticmethod(st.run_vec_grow)

    def __init__(self, spec: KmerSpec, device="cuda", canonical: bool = True,
                 nparts: int = 1, hash_name: str = "murmur",
                 saturate: int | None = None,
                 initial_capacity: int = 1 << 12, max_runs: int = 8,
                 timer: PhaseTimer | None = None, mesh: Mesh | None = None):
        if not isinstance(canonical, bool):
            raise ValueError(
                "DeBruijnGraph defines edge orientation on the lex_less "
                "canonical strand; transform-name presets apply to the "
                "k-mer index families only")
        self._warned_lossy_edges = False
        super().__init__(spec, device, canonical, nparts, hash_name,
                         saturate, initial_capacity, max_runs, timer, mesh)

    def _empty_store(self):
        return st.empty_run_vec_store(self.initial_capacity,
                                      self.spec.nwords, self.device)

    def _adopt(self, words, ebytes, weights, qsums, unit: bool):
        """A LAZY run (the table waits for `_ensure_tables`: an
        intermediate LSM run is merge fodder)."""
        return dx.run_vec_adopt_step(words, ebytes, weights, qsums, unit=unit,
                                     table=False)

    def _merge_pair(self, a, b, unit: bool):
        return dx.run_vec_merge_pair_step(a, b, unit=unit, table=False)

    def _ensure_tables(self):
        """Build the deferred counter tables of every run (queries,
        exports, compaction and saves read them)."""
        for i, r in enumerate(self.runs):
            if r.bsum is None:
                with self.timer.phase("table"):
                    self.runs[i] = dx.run_vec_table_step(r, self._unit[i])

    def _shard_weight(self) -> int:
        """The largest shard's raw weight total over all runs."""
        return self.mesh.all_max(int(sum(r.weights.to(torch.int64).sum(-1)
                                         for r in self.runs).max()))

    def compact(self, new_cap: int | None = None):
        """Consolidate to one run and collapse equal (key, edge byte) rows
        into one weighted row; the capacity doubles from new_cap until the
        groups fit (default: next_pow2(4 * the largest shard's node
        count)), and the raw run stays if nothing can be reclaimed."""
        while len(self.runs) > 1:
            self._merge_two_smallest()
        cap = self.capacity
        if new_cap is None:
            new_cap = _next_pow2(max(4 * max(self._distinct()), 1 << 12))
        while True:
            with self.timer.phase("compact"):
                new_run, ovf = dx.run_vec_compact_step(self.runs[0], new_cap,
                                                       self.mesh)
            if ovf == 0:
                self.runs, self._unit = [new_run], [False]
                self._drop_stale_aux()
                return self
            if new_cap >= cap:
                return self
            new_cap *= 2

    # ------------------------------------------------------------------
    def _chunk_halo(self) -> tuple[int, int]:
        # the edges need 1 base of left context and the k-th base on the
        # right, beyond the k-1 window halo (edge_iterator.hpp:56)
        return self.spec.k, 1

    @property
    def parse_alphabet(self):
        """ASCII: the graph parses raw bytes, so an edge nibble is
        DNA16::FROM_ASCII[byte] as in the reference's edge iterator; the
        k-mer codes come from the k-mer alphabet's LUT on the device."""
        return alphabets.ASCII

    def insert_batch(self, batch: ReadBatch, chunk_bases: int | None = None):
        """Insert a parsed batch's windows and edges.  A batch parsed with
        `parse_alphabet` (raw ASCII) gets the reference's dual-LUT edges;
        one already encoded in the k-mer alphabet is lossy (an 'N'
        neighbour reads as the alphabet's code, not DNA16 0xF), and the
        first such batch warns."""
        if (batch.alphabet is None or batch.alphabet.name != "ASCII") \
                and not self._warned_lossy_edges:
            self._warned_lossy_edges = True
            name = None if batch.alphabet is None else batch.alphabet.name
            warnings.warn(
                f"{type(self).__name__} received a batch encoded in the "
                f"{name} alphabet: edge characters outside it (e.g. 'N') "
                "are lossy.  Parse inputs with graph.parse_alphabet (raw "
                "ASCII) for the reference's dual-LUT edge semantics.",
                RuntimeWarning, stacklevel=2)
        return super().insert_batch(batch, chunk_bases)

    def _marshal_chunk(self, batch: ReadBatch):
        """(the per-shard columns, raw: the bytes are ASCII)."""
        raw = batch.alphabet is not None and batch.alphabet.name == "ASCII"
        return super()._marshal_chunk(batch), raw

    def _codec(self):
        """The quality codec of the ingest (None: no quality)."""
        return None

    def _insert_cols(self, marshalled):
        cols, raw = marshalled
        bases = self._to_device(cols)
        # the longest chunk of any rank: the bound and the buckets agree
        n_local = self.mesh.all_max(bases.codes.shape[1])
        self._note_weight(n_local * self.nparts)
        cap = self._bucket_capacity(n_local)
        with self.timer.phase("insert"):
            while True:
                rw, reb, rwt, rqs, ovf = dx.debruijn_ingest_step(
                    bases, self.spec, self.canonical, self.mesh, cap,
                    self.hash_name, raw=raw, codec=self._codec())
                if ovf == 0:
                    break
                cap = _next_pow2(cap + ovf)
        self._append_run(rw, reb, rwt, rqs, unit=True)
        return self

    # ------------------------------------------------------------------
    def _node_payload(self, kmers):
        """(counters int32[m, 9], quality sums float64[m] or None) of the
        query nodes, transformed like the graph's own.  Phases: "rows",
        then "query" with its children "query.lookup" (each shard's lookup
        tables — one "query.lookup.run" per run and shard as its tables
        join them —, routing and the shard's one lookup launch) and
        "query.reply" (the replies in query order, copied to the host: the
        wait for the lookup)."""
        words = self._query_words(kmers)
        self._ensure_tables()
        aux = self._ensure_aux()
        with self.timer.phase("query"):
            with self.timer.phase("query.lookup"):
                tables = [self._shard_tables(aux, s)
                          for s in range(self.mesh.p_local)]
                (vals, qs), m = self._route_rows(
                    lambda q, v, cap: dx.runs_vec_query_step(
                        q, v, tables, self.mesh, cap, self.hash_name,
                        self.saturate), words)
            with self.timer.phase("query.reply"):
                vals = self._replies(vals, m).cpu().numpy()
                if qs is not None:
                    qs = self._replies(qs, m).cpu().numpy()
        return vals, qs

    def _shard_tables(self, aux, s: int) -> list:
        """Local shard s's lookup tables, one (ext, bstart, bsum, qcsum or
        None) per run: the run's cached aux, counter table and quality
        prefix sums (`kernels.run_vec_lookup`)."""
        tables = []
        for run, run_aux in zip(self.runs, aux):
            with self.timer.phase("query.lookup.run"):
                tables.append((*run_aux[s], run.bsum[s],
                               run.qcsum[s] if isinstance(run, st.RunVecQStore)
                               else None))
        return tables

    def node_counts(self, kmers):
        """(counters int32[m, 9], found bool[m]) per query node, the
        counters summed over the run list; a node exists iff a window hit
        it (self > 0)."""
        vals, _ = self._node_payload(kmers)
        return vals, vals[:, 8] > 0

    def edge_exists(self, kmers) -> np.ndarray:
        """bool[m, 8] out / in edge flags (the edge_exists node trait,
        de_bruijn_node_trait.hpp:270-330)."""
        vals, found = self.node_counts(kmers)
        return (vals[:, :8] > 0) & found[:, None]

    def neighbors(self, kmer):
        """(in_neighbors, out_neighbors) of one node as lists of
        (k-mer string, edge count) (get_in/out_neighbors,
        de_bruijn_node_trait.hpp:60-115), walked from the canonical node:
        the counters are ordered for the canonical strand."""
        spec = self.spec
        word = to_numpy_u32(self._query_words([kmer]))
        vals, found = self.node_counts(word)
        if not found[0]:
            return [], []
        counts = vals[0]
        codes = spec.unpack_words(word[0])
        outs, ins = [], []
        for b in range(4):  # DNA codes A C G T = 0..3
            if counts[b] > 0:
                nxt = np.concatenate([codes[1:], [b]]).astype(np.uint8)
                outs.append((spec.alphabet.decode(nxt), int(counts[b])))
            if counts[4 + b] > 0:
                prv = np.concatenate([[b], codes[:-1]]).astype(np.uint8)
                ins.append((spec.alphabet.decode(prv), int(counts[4 + b])))
        return ins, outs

    def items(self):
        """(words uint32[t, w], counters int32[t, 9]) of every node, shard
        by shard, each shard in key order (the quality graph adds each
        node's quality sum, float64[t])."""
        self._consolidate()
        self._ensure_tables()
        parts = dx.run_vec_export_step(self.runs[0], self.saturate)
        out = (to_numpy_u32(self._rows_of_all(k for k, _, _ in parts)),
               self._rows_of_all(v for _, v, _ in parts).cpu().numpy())
        if self.with_quality:
            out += (self._rows_of_all(q for _, _, q in parts).cpu().numpy(),)
        return out

    def to_dict(self) -> dict:
        """{kmer_int: (out A, C, G, T, in A, C, G, T, self)}; the quality
        graph's values add (windows, quality sum) (tests and tools)."""
        words, vecs, *qs = self.items()
        ints = self.spec.to_ints(words).tolist()
        vecs = vecs.tolist()
        if not qs:
            return {v: tuple(c) for v, c in zip(ints, vecs)}
        return {v: tuple(c) + (c[8], q)
                for v, c, q in zip(ints, vecs, qs[0].tolist())}

    # -- persistence: the JAX package's npz formats ---------------------
    def _npz_columns(self, run) -> dict:
        return {"ebytes": self._whole(run.ebytes).cpu().numpy(),
                "weights": self._whole(run.weights).cpu().numpy()}

    def save(self, path):
        """One npz file of the consolidated run's rows (keys [p, w, n],
        edge bytes, weights; weight-0 rows are dead) and the config, in the
        JAX package's format: either package loads it, at any shard count.
        The columns stop after the last live row of the fullest shard (the
        JAX package writes the run's whole capacity; loading reads the
        live rows either way)."""
        self._consolidate()
        run = self.runs[0]
        live = run.weights > 0
        idx = torch.arange(run.capacity, device=live.device)
        n = self.mesh.all_max(int(torch.where(live, idx + 1, 0).max()))
        run = type(run)(**{f: None if v is None else v[..., :n]
                           for f, v in vars(run).items()})
        self._savez(
            path, kind=self._npz_kind, k=self.spec.k,
            alphabet=self.spec.alphabet.name, canonical=self.canonical,
            hash_name=self.hash_name, nparts=self.nparts,
            keys=to_numpy_u32(self._whole(run.keys)),
            **self._npz_columns(run))
        return self

    @classmethod
    def load(cls, path, device="cuda", nparts: int = 1, mesh=None):
        """A graph of `nparts` shards (or over `mesh`) holding a saved
        graph's rows (saved at any shard count, by either package): the
        live rows are routed to their owners, sorted and adopted as one
        weighted run."""
        z, spec = _open_npz(path, (cls._npz_kind,))
        g = cls(spec, device, canonical=bool(z["canonical"]), nparts=nparts,
                hash_name=str(z["hash_name"]), mesh=mesh)
        keys, weights = z["keys"], z["weights"]
        live = weights > 0
        rows = np.concatenate([keys[p].T[live[p]]
                               for p in range(keys.shape[0])])
        if rows.shape[0] == 0:
            return g

        def col(name, dt):
            return torch.from_numpy(np.ascontiguousarray(
                z[name][live].astype(dt))).to(g.device)

        qs = col("qsums", np.float32) if "qsums" in z.files else None
        g._insert_rows(from_numpy_u32(rows, g.device), col("ebytes", np.int32),
                       col("weights", np.int32), qs)
        return g

    def _insert_rows(self, words, ebytes, weights, qsums=None):
        """Route explicit (node, edge byte, weight[, quality sum]) device
        rows to their owners and append them as one weighted run."""
        self._note_weight(int(weights.to(torch.int64).sum()))

        def step(w, e, t, *rest):
            *q, valid, cap = rest
            return dx.run_vec_load_step(w, e, t, q[0] if q else None, valid,
                                        self.mesh, cap, self.spec,
                                        self.hash_name)

        extra = (ebytes, weights) + (() if qsums is None else (qsums,))
        with self.timer.phase("insert"):
            (kc, eb, wt, qs), _ = self._route_rows(step, words, extra=extra)
        self._append_run(kc, eb, wt, qs)
        return self


class QualityDeBruijnGraph(DeBruijnGraph):
    """A de Bruijn graph whose windows also carry their quality — the
    reference's `de_bruijn_quality_engine` (de_bruijn_construct_engine.hpp:
    245; its parser zips the k-mer, edge and quality-score streams,
    :160-230).  Per node: the 9 counters of `DeBruijnGraph`, the number of
    windows (the self counter) and the SUM of the windows' qualities
    (`quality.window_quality` of the phred bytes under `codec`);
    `node_quality` reports the mean.  FASTQ only.

    The node store is `store.RunVecQStore`: the quality sums ride K2 as
    float32 bit patterns (2 payloads in a unit merge, 3 otherwise), and
    their prefix sum is float64 (the JAX package's float32 prefix loses a
    node's digits as a run grows: `store.RunVecQStore`)."""

    _npz_kind = "debruijn_quality"
    with_quality = True

    def __init__(self, spec: KmerSpec, device="cuda", canonical: bool = True,
                 nparts: int = 1, hash_name: str = "murmur",
                 saturate: int | None = None,
                 initial_capacity: int = 1 << 12, max_runs: int = 8,
                 codec=None, timer: PhaseTimer | None = None,
                 mesh: Mesh | None = None):
        self.codec = codec if codec is not None else ILLUMINA18
        super().__init__(spec, device, canonical, nparts, hash_name,
                         saturate, initial_capacity, max_runs, timer, mesh)

    def _empty_store(self):
        return st.empty_run_vecq_store(self.initial_capacity,
                                       self.spec.nwords, self.device)

    def _codec(self):
        return self.codec

    def node_quality(self, kmers):
        """(mean quality float32[m], windows int32[m], found bool[m]) per
        query node: the mean of the qualities of every window that hit
        it."""
        vals, qsum = self._node_payload(kmers)
        n = vals[:, 8]
        mean = np.where(n > 0, qsum / np.maximum(n, 1), 0.0)
        return mean.astype(np.float32), n, n > 0

    def _npz_columns(self, run) -> dict:
        return dict(super()._npz_columns(run),
                    qsums=self._whole(run.qsums).cpu().numpy())
