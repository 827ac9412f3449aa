"""The headline benchmark of the port: the counterpart of the repo's
``bench.py``, with the same modes, flags and one-line JSON.

    python3 -m kmerind_tpu_torch.bench.headline [--mode e2e] [--bases N]
        [--k K] [--chunks C] [--max-runs R] [--iters I] [--queries M]
        [--device cuda] [--seed S] [--pinned-baseline RATE] [--json-only]

Every mode keeps a synthetic corpus on the device (`make_batch`: --bases
random DNA bases in reads of --read-len) and times the device schedule of
one index over it, built from the port's own modules:

* ``e2e``: per chunk K1 (`io.kmer_parsers.extract_tuples`) and a sort,
  the LSM policy of `CountIndex` (while more than --max-runs runs, the two
  smallest merge through K2), then each run adopted — in closed form for a
  sentinel-safe spec, through K3 otherwise (e.g. ``--k 16``);
* ``ingest``: K1 and the sort alone, --inner chunks a timing, per chunk;
* ``count_query``, ``erase``, ``multimap_find``: a `CountIndex` /
  `PositionIndex` built from the corpus, then the routed query step over
  --queries sampled read windows (the erase times the same snapshot every
  time);
* ``debruijn`` / ``debruijn_quality``: edge bytes, unit runs merged
  through K2 with 1-2 payloads, the counter tables at the end (K3);
* ``position`` / ``position_quality``: the multimap's flushes (K2 with 2-3
  payloads) into a store grown on the index's schedule.

Chunk i (of a build started at salt s) flips the low bit of base 0 when
s + i is odd, as ``bench.py`` does.  ``value`` is the best of --iters
timings, each ending in `torch.cuda.synchronize()` on a card (every
iteration's time goes to stderr); ``compile_s`` is the wall time to the
first result, ``kernel_build_s`` of it the kernel library's build at first
use, ``first_run_s`` the rest.  ``vs_baseline`` divides by a numpy rate
measured here (the median of 3 single-thread runs of the same canonical
count at --baseline-bases; the query modes time their own numpy
equivalent), or by ``--pinned-baseline``; ``baseline`` says which.

The modes are functions (`MODES`) of a `Context` that return the JSON
dict and the state they built, so tests can hold the state against an
index.  With no CUDA device and no ``--device cpu`` the script exits 2.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import statistics
import sys
import time

import numpy as np
import torch
from torch.profiler import record_function

from .. import DNA, KmerSpec
from ..index import distributed as dx
from ..index import store as st
from ..index.api import CountIndex, PositionIndex
from ..io.batch import ReadBatch
from ..io.kmer_parsers import DeviceBases, extract_tuples
from ..ops import kernels, packing, sortops
from ..ops.keys import SENTINEL
from ..quality import ILLUMINA18, window_quality

__all__ = ["MODES", "UNITS", "Context", "parse_args", "make_batch",
           "numpy_baseline", "in_read_windows", "run", "main"]

UNITS = {"e2e": "kmers/s", "ingest": "kmers/s", "count_query": "queries/s",
         "multimap_find": "queries/s", "erase": "keys/s",
         "debruijn": "kmers/s", "debruijn_quality": "kmers/s",
         "position": "pairs/s", "position_quality": "pairs/s"}


class NoDevice(RuntimeError):
    """The requested device does not exist."""


def parse_args(argv=None) -> argparse.Namespace:
    ap = argparse.ArgumentParser(prog="kmerind_tpu_torch.bench.headline")
    ap.add_argument("--bases", type=int, default=1 << 24,
                    help="bases per chunk")
    ap.add_argument("--k", type=int, default=21)
    ap.add_argument("--read-len", type=int, default=250)
    ap.add_argument("--chunks", type=int, default=8,
                    help="chunks in the end-to-end build")
    ap.add_argument("--max-runs", type=int, default=4,
                    help="LSM run bound (merges trigger above it)")
    ap.add_argument("--iters", type=int, default=3)
    ap.add_argument("--inner", type=int, default=40,
                    help="chunks per timing in --mode ingest")
    ap.add_argument("--mode", default="e2e", choices=tuple(UNITS))
    ap.add_argument("--queries", type=int, default=1 << 20,
                    help="query rows in the query-rate modes")
    ap.add_argument("--max-per-query", type=int, default=16,
                    help="multimap find gather width")
    ap.add_argument("--baseline-bases", type=int, default=1 << 21)
    base = ap.add_mutually_exclusive_group()
    base.add_argument("--measure-baseline", action="store_true",
                      help="measure the numpy baseline (the default)")
    base.add_argument("--pinned-baseline", type=float, default=None,
                      help="divide by this k-mers/s rate instead")
    ap.add_argument("--json-only", action="store_true")
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--seed", type=int, default=0)
    return ap.parse_args(argv)


# ---------------------------------------------------------------- corpus
def make_batch(n_bases: int, read_len: int, seed: int = 0):
    """(codes uint8[n], valid bool[n], seg_id int32[n]): random DNA bases
    in reads of read_len (the last one shorter)."""
    rng = np.random.default_rng(seed)
    codes = rng.integers(0, 4, size=n_bases).astype(np.uint8)
    valid = np.ones(n_bases, dtype=bool)
    seg_id = (np.arange(n_bases) // read_len).astype(np.int32)
    return codes, valid, seg_id


def in_read_windows(n_bases: int, read_len: int, k: int) -> int:
    """The k-windows lying inside one read of the corpus (closed form)."""
    full, last = divmod(n_bases, read_len)
    return full * max(read_len - k + 1, 0) + max(last - k + 1, 0)


def _packs(vals: np.ndarray, m: int) -> np.ndarray:
    """uint64[n]: entry i packs vals[i : i+m) at 2 bits a base, the first
    most significant (m <= 32; entries near the end are partial)."""
    acc = vals.astype(np.uint64)
    span = 1
    while span < m:
        step = min(span, m - span)
        shifted = np.zeros_like(acc)
        shifted[:-step] = acc[step:]
        acc = (acc << np.uint64(2 * step)) | shifted
        span += step
    return acc


def canonical_limbs(codes: np.ndarray, k: int):
    """(canonical uint64[n - k + 1, L], was_rc bool[n - k + 1]): every
    window's canonical DNA k-mer in limbs of up to 32 bases (limb 0 the
    first), the lexicographically smaller of the window and its reverse
    complement — numpy, independent of the port's kernels."""
    n = codes.shape[0]
    nw = n - k + 1
    lens = [min(32, k - 32 * j) for j in range(-(-k // 32))]
    comp = np.uint8(3) - codes
    fwd, rev = {}, {}
    for ln in set(lens):
        fwd[ln] = _packs(codes, ln)
        rev[ln] = _packs(comp[::-1], ln)[::-1][ln - 1:]
    f = np.stack([fwd[ln][32 * j:32 * j + nw]
                  for j, ln in enumerate(lens)], axis=1)
    g = np.stack([rev[ln][k - 32 * j - ln:k - 32 * j - ln + nw]
                  for j, ln in enumerate(lens)], axis=1)
    use_rc = np.zeros(nw, bool)
    decided = np.zeros(nw, bool)
    for j in range(len(lens)):
        use_rc |= ~decided & (g[:, j] < f[:, j])
        decided |= g[:, j] != f[:, j]
    return np.where(use_rc[:, None], g, f), use_rc


def numpy_baseline(codes: np.ndarray, seg_id: np.ndarray, k: int):
    """Single-thread numpy canonical count build of a DNA code stream:
    (k-mers/s, (distinct canonical k-mers uint64[t, L], counts))."""
    t0 = time.perf_counter()
    canon, _ = canonical_limbs(codes, k)
    vals = canon[seg_id[: codes.shape[0] - k + 1] == seg_id[k - 1:]]
    if vals.shape[1] == 1:
        uniq, counts = np.unique(vals[:, 0], return_counts=True)
        uniq = uniq[:, None]
    else:
        uniq, counts = np.unique(vals, axis=0, return_counts=True)
    return vals.shape[0] / (time.perf_counter() - t0), (uniq, counts)


@dataclasses.dataclass
class Context:
    """One mode's run: the arguments, the device, the spec and the corpus
    on the host and on the device."""

    args: argparse.Namespace
    device: torch.device
    spec: KmerSpec
    codes_np: np.ndarray
    seg_np: np.ndarray
    codes: torch.Tensor
    valid: torch.Tensor
    seg: torch.Tensor
    #: seconds of each timed iteration of the last mode run (per chunk in
    #: the ingest mode)
    times: list = dataclasses.field(default_factory=list)

    @classmethod
    def create(cls, args: argparse.Namespace) -> "Context":
        device = torch.device(args.device)
        if device.type == "cuda" and not torch.cuda.is_available():
            raise NoDevice("no CUDA device: pass --device cpu to run on the "
                           "CPU")
        codes, valid, seg = make_batch(args.bases, args.read_len, args.seed)
        put = lambda a: torch.from_numpy(a).to(device)  # noqa: E731
        return cls(args, device, KmerSpec(args.k, DNA), codes, seg,
                   put(codes), put(valid), put(seg))

    def log(self, msg: str):
        if not self.args.json_only:
            print(msg, file=sys.stderr, flush=True)

    def sync(self):
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def build_kernels(self) -> float:
        """Wall seconds of the kernel library's build and load (nothing
        to do once loaded, or on the CPU)."""
        if self.device.type != "cuda":
            return 0.0
        t0 = time.perf_counter()
        kernels.build()
        return time.perf_counter() - t0

    def salted(self, salt: int) -> torch.Tensor:
        """The corpus codes with the low bit of base 0 flipped when salt
        is odd."""
        c = self.codes.clone()
        c[0] ^= salt & 1
        return c

    def qual_np(self) -> np.ndarray:
        """uint8 phred bytes 33-74 of every base (the quality modes)."""
        return np.random.default_rng(self.args.seed + 5).integers(
            33, 75, self.args.bases).astype(np.uint8)

    def read_batch(self, qual: np.ndarray | None = None) -> ReadBatch:
        """The corpus as a host ReadBatch (the index build paths)."""
        n, rl = self.args.bases, self.args.read_len
        r = -(-n // rl)
        return ReadBatch(
            codes=self.codes_np, valid=np.ones(n, bool),
            owned=np.ones(n, bool), seg_id=self.seg_np,
            offset_in_record=(np.arange(n) % rl).astype(np.uint32),
            global_pos=np.arange(n, dtype=np.uint64),
            qual=np.zeros(n, np.uint8) if qual is None else qual,
            record_start=np.arange(r, dtype=np.uint64) * rl,
            seq_index=np.arange(r, dtype=np.uint32),
            file_id=np.zeros(r, np.uint16), alphabet=DNA)

    def sample_queries(self) -> torch.Tensor:
        """--queries in-read windows of the corpus as key rows [m, w]
        (forward strand) on the device."""
        a, k = self.args, self.spec.k
        starts = np.random.default_rng(a.seed + 1).integers(
            0, a.bases - k + 1, a.queries)
        in_read = self.seg_np[starts] == self.seg_np[starts + k - 1]
        starts = np.where(in_read, starts,
                          (starts // a.read_len) * a.read_len)
        words = packing.extract_kmers(self.codes, self.spec)
        return words[torch.from_numpy(starts).to(self.device)]

    def store_keys(self, size: int) -> np.ndarray:
        """The numpy query baselines' store: `size` sorted random keys."""
        return np.sort(np.random.default_rng(self.args.seed + 2).integers(
            0, 1 << 42, size, dtype=np.uint64))

    def store_queries(self, skeys: np.ndarray, m: int) -> np.ndarray:
        return skeys[np.random.default_rng(self.args.seed + 3).integers(
            0, len(skeys), m)]


# ------------------------------------------------------------- timing
#: the profiler range around each timed iteration
#: (``tools/profile_headline.py`` reads the device's work inside it)
ITER_RANGE = "headline:iter"


def _time_builds(ctx: Context, build):
    """Time build(salt) -> (state, windows as a 0-d tensor): the first run
    (with the kernel build) and the read of its windows is compile_s; then
    --iters timed runs, each ending in a sync.  Returns ((state, windows)
    of the salt-0 run, times, kernel_build_s, compile_s)."""
    t0 = time.perf_counter()
    kb = ctx.build_kernels()
    state, total = build(0)
    total = int(total)
    compile_s = time.perf_counter() - t0
    ctx.log(f"compile+first run: {compile_s:.3f} s (kernel build {kb:.3f} "
            f"s; total windows in store: {total})")
    times = []
    for i in range(ctx.args.iters):
        t0 = time.perf_counter()
        with record_function(ITER_RANGE):
            build(i)
            ctx.sync()
        times.append(time.perf_counter() - t0)
        ctx.log(f"iter {i}: {times[-1] * 1e3:.1f} ms/build")
    return (state, total), times, kb, compile_s


def _time_step(ctx: Context, step, label: str) -> list:
    """Times of --iters calls of step() after one warm call, each ending
    in a sync."""
    step()
    ctx.sync()
    times = []
    for i in range(ctx.args.iters):
        t0 = time.perf_counter()
        with record_function(ITER_RANGE):
            step()
            ctx.sync()
        times.append(time.perf_counter() - t0)
        ctx.log(f"iter {i}: {times[-1] * 1e3:.3f} ms/{label}")
    return times


def _result(ctx: Context, metric: str, n: int, times: list, kb: float,
            compile_s: float, base_rate: float | None = None) -> dict:
    """The JSON line of a mode: n items over the best time; the k-mer
    modes divide by the shared numpy baseline, the query modes pass
    their own rate."""
    ctx.times = list(times)
    rate = n / min(times)
    a = ctx.args
    if base_rate is not None:
        baseline = "measured"
    elif a.pinned_baseline is not None:
        base_rate, baseline = a.pinned_baseline, "pinned"
    else:
        ctx.log("running numpy baseline…")
        bcodes, _, bseg = make_batch(a.baseline_bases, a.read_len, a.seed)
        base_rate = statistics.median(
            numpy_baseline(bcodes, bseg, a.k)[0] for _ in range(3))
        baseline = "measured"
    ctx.log(f"numpy baseline ({baseline}): {base_rate / 1e6:.3f} M/s")
    return {"metric": metric, "value": rate, "unit": UNITS[a.mode],
            "vs_baseline": rate / base_rate, "compile_s": compile_s,
            "baseline": baseline, "kernel_build_s": kb,
            "first_run_s": compile_s - kb}


# ------------------------------------------------------- count index modes
def _ingest(ctx: Context, salt: int):
    """One chunk through K1 and the sort: (sorted key columns [w, n],
    weights int32[n] — 1 on each live row)."""
    spec = ctx.spec
    bases = DeviceBases(codes=ctx.salted(salt), valid=ctx.valid,
                        owned=ctx.valid, seg_id=ctx.seg)
    tup = extract_tuples(bases, spec, canonical=True)
    s_words, _, s_valid = sortops.sort_rows(
        tup.words, (), tup.valid, is_stable=False,
        sentinel_ok=spec.sentinel_safe, as_cols=True)
    if not spec.sentinel_safe:
        s_words = torch.where(s_valid[None, :], s_words, SENTINEL)
    return s_words, s_valid.to(torch.int32)


def _lsm(runs: list, max_runs: int, merge, rows):
    """The index's run bound: while more than max_runs runs, merge the two
    with the fewest rows (`rows(run)`)."""
    while len(runs) > max_runs:
        runs.sort(key=rows, reverse=True)
        b = runs.pop()
        a = runs.pop()
        runs.append(merge(a, b))


def _merge_counts(a, b, unit: bool):
    """K2 over two (key columns, weights) runs: keys only for unit runs
    (the weights come back as the live rows), else the weights ride."""
    if unit:
        keys, _ = sortops.merge_sorted_runs_cols(a[0], (), b[0], ())
        return keys, (~(keys == SENTINEL).all(dim=0)).to(torch.int32)
    keys, (wt,) = sortops.merge_sorted_runs_cols(a[0], (a[1],), b[0],
                                                 (b[1],))
    return keys, wt


def e2e(ctx: Context):
    """The full C-chunk build (CountIndex's schedule).  State: the run
    stores (`store.RunCountStore`, one shard)."""
    a, spec = ctx.args, ctx.spec
    unit = spec.sentinel_safe

    def build(salt0):
        runs = []
        for i in range(a.chunks):
            runs.append(_ingest(ctx, salt0 + i))
            _lsm(runs, a.max_runs, lambda x, y: _merge_counts(x, y, unit),
                 lambda r: r[0].shape[-1])
        stores = [st.run_from_sorted_unit(w, t) if unit
                  else st.run_from_sorted(w, t) for w, t in runs]
        return stores, sum(s.csum[-1].to(torch.int64) for s in stores)

    ctx.log(f"e2e build ({a.chunks} chunks, max_runs={a.max_runs})…")
    (stores, total), times, kb, cs = _time_builds(ctx, build)
    metric = ("kmers/s/chip (canonical count-index build END-TO-END: %d "
              "chunks, k=%d, LSM merges + prefix sums included)"
              % (a.chunks, a.k))
    return _result(ctx, metric, total, times, kb, cs), stores


def ingest(ctx: Context):
    """--inner chunk ingests a timing, reported per chunk.  State: the
    last chunk's (key columns, weights)."""
    inner = ctx.args.inner

    def loop():
        for i in range(inner):
            out = _ingest(ctx, i)
        return out

    t0 = time.perf_counter()
    kb = ctx.build_kernels()
    words, weights = loop()
    total = int(weights.sum())
    compile_s = time.perf_counter() - t0
    ctx.log(f"compile+first run: {compile_s:.3f} s ({inner} chunks)")
    times = [t / inner for t in _time_step(ctx, loop, f"{inner} chunks")]
    metric = "kmers/s/chip (canonical count ingest only, k=%d)" % ctx.args.k
    return (_result(ctx, metric, total, times, kb, compile_s),
            (words, weights))


def _count_index(ctx: Context, cls):
    """An index of `cls` built from the corpus, the sampled queries dealt
    over its shards, and their bucket capacity."""
    idx = cls(ctx.spec, device=ctx.device)
    ctx.log(f"building the {ctx.args.bases >> 20}M-base store…")
    idx.insert_batch(ctx.read_batch())
    qw = idx._maybe_canonicalize_queries(ctx.sample_queries())
    (wsh,), vsh, m = idx._shard_rows(qw)
    return idx, wsh, vsh, m, idx._bucket_capacity(wsh.shape[1])


def count_query(ctx: Context):
    """The routed count query over the index's runs and cached aux.
    State: (the index, counts of the sampled queries [m])."""
    kb = ctx.build_kernels()
    idx, wsh, vsh, m, cap = _count_index(ctx, CountIndex)
    size = idx.size()
    ctx.log(f"store: {size} kmers over {len(idx.runs)} runs; {m} queries")
    t0 = time.perf_counter()
    aux = idx._ensure_aux()
    while True:
        counts, ovf = dx.runs_count_query_step(
            wsh, vsh, aux, idx.mesh, cap, idx.hash_name, idx.saturate)
        if ovf == 0:
            break
        cap *= 2
    ctx.sync()
    first = time.perf_counter() - t0
    times = _time_step(ctx, lambda: dx.runs_count_query_step(
        wsh, vsh, aux, idx.mesh, cap, idx.hash_name, idx.saturate),
        "query step")
    skeys = ctx.store_keys(size)
    bq = ctx.store_queries(skeys, m)
    t0 = time.perf_counter()
    pos = np.searchsorted(skeys, bq)
    hit = skeys[np.minimum(pos, len(skeys) - 1)] == bq
    base = m / (time.perf_counter() - t0)
    assert hit.all()
    metric = ("queries/s/chip (distributed count query, %dM-row store, %dk "
              "queries, k=%d)" % (size >> 20, m >> 10, ctx.args.k))
    return (_result(ctx, metric, m, times, kb, kb + first, base),
            (idx, counts.reshape(-1)[:m]))


def erase(ctx: Context):
    """The routed erase over the index's runs, each timing on the same
    snapshot (the runs the step returns are dropped).  State: (the index,
    keys erased per call, one entry per call)."""
    kb = ctx.build_kernels()
    idx, wsh, vsh, m, cap = _count_index(ctx, CountIndex)
    nerased = []
    t0 = time.perf_counter()
    aux = idx._ensure_aux()
    while True:
        _, n, ovf = dx.runs_erase_step(idx.runs, aux, wsh, vsh, idx.mesh,
                                       cap, idx.hash_name)
        if ovf == 0:
            break
        cap *= 2
    ctx.sync()
    first = time.perf_counter() - t0
    nerased.append(n)

    def step():
        nerased.append(dx.runs_erase_step(idx.runs, aux, wsh, vsh, idx.mesh,
                                          cap, idx.hash_name)[1])

    times = _time_step(ctx, step, "erase step")
    size = idx.size()
    skeys = ctx.store_keys(size)
    bq = ctx.store_queries(skeys, m)
    t0 = time.perf_counter()
    pos = np.searchsorted(skeys, bq)
    kill = np.zeros(len(skeys) + 1, bool)
    kill[np.minimum(pos, len(skeys) - 1)] = True
    _ = skeys[~kill[:-1]]
    base = m / (time.perf_counter() - t0)
    metric = ("keys/s/chip (distributed erase, %dM-row store, %dk keys, "
              "k=%d)" % (size >> 20, m >> 10, ctx.args.k))
    return (_result(ctx, metric, m, times, kb, kb + first, base),
            (idx, nerased))


def multimap_find(ctx: Context):
    """The routed multimap find, the gather width grown to a power of two
    above the largest multiplicity.  State: (the index, multiplicity of
    each sampled query [m], the width)."""
    kb = ctx.build_kernels()
    idx, wsh, vsh, m, cap = _count_index(ctx, PositionIndex)
    idx._flush()
    ctx.log(f"store: {idx.size()} pairs; {m} queries")
    mpq = ctx.args.max_per_query
    owner = idx._owners(wsh)
    t0 = time.perf_counter()
    aux = idx._ensure_aux()
    while True:
        *_, nfound, ovf = dx.multi_find_routed(idx.store, aux, wsh, vsh,
                                               owner, idx.mesh, cap, mpq)
        if ovf != 0:
            cap *= 2
            continue
        worst = int(nfound.max())
        if worst > mpq:
            mpq = 1 << (worst - 1).bit_length()
            continue
        break
    ctx.sync()
    first = time.perf_counter() - t0
    times = _time_step(ctx, lambda: dx.multi_find_routed(
        idx.store, aux, wsh, vsh, owner, idx.mesh, cap, mpq), "find step")
    size = idx.size()
    skeys = ctx.store_keys(size)
    vals = np.arange(len(skeys), dtype=np.uint64)
    bq = ctx.store_queries(skeys, m)
    t0 = time.perf_counter()
    lo_ = np.searchsorted(skeys, bq, side="left")
    hi_ = np.searchsorted(skeys, bq, side="right")
    take = np.minimum(hi_ - lo_, mpq)
    out = vals[np.minimum(lo_[:, None] + np.arange(mpq), len(vals) - 1)]
    _ = out * (np.arange(mpq) < take[:, None])
    base = m / (time.perf_counter() - t0)
    metric = ("queries/s/chip (multimap find, %dM-pair store, %dk queries, "
              "max_per_query=%d, k=%d)" % (size >> 20, m >> 10, mpq,
                                           ctx.args.k))
    return (_result(ctx, metric, m, times, kb, kb + first, base),
            (idx, nfound.reshape(-1)[:m], mpq))


# ------------------------------------------------------- de Bruijn modes
def _graph_build(ctx: Context, quality: bool):
    """build(salt0) -> (tabled unit runs, windows): DeBruijnGraph's
    schedule for the corpus."""
    from ..debruijn.edges import edge_bytes_for_windows, revcomp_edge_byte
    a, spec = ctx.args, ctx.spec
    dqual = (torch.from_numpy(ctx.qual_np()).to(ctx.device) if quality
             else None)

    def chunk(salt):
        c = ctx.salted(salt)
        words, was_rc = kernels.extract_canonical(c, spec)
        wvalid = packing.window_valid(ctx.valid, ctx.seg, spec.k)
        edges = edge_bytes_for_windows(c, ctx.valid, ctx.seg, spec.k,
                                       spec.alphabet)
        edges = torch.where(was_rc, revcomp_edge_byte(edges), edges)
        pays = (edges.to(torch.int32),)
        if quality:
            pays += (window_quality(dqual, spec.k, ILLUMINA18).view(
                torch.int32),)
        s_words, s_pays, s_valid = sortops.sort_rows(
            words, pays, wvalid, is_stable=False,
            sentinel_ok=spec.sentinel_safe, as_cols=True)
        if not spec.sentinel_safe:
            s_words = torch.where(s_valid[None, :], s_words, SENTINEL)
        eb = torch.where(s_valid, s_pays[0], 0)
        wt = s_valid.to(torch.int32)
        if not quality:
            return (st.run_vec_from_sorted_unit(s_words, eb, wt, table=False)
                    if spec.sentinel_safe else
                    st.run_vec_from_sorted(s_words, eb, wt, table=False))
        qs = torch.where(s_valid, s_pays[1].view(torch.float32), 0.0)
        return (st.run_vecq_from_sorted_unit(s_words, eb, wt, qs, table=False)
                if spec.sentinel_safe else
                st.run_vecq_from_sorted(s_words, eb, wt, qs, table=False))

    unit = spec.sentinel_safe
    merge = (lambda x, y: st.run_vec_merge_unit(x, y, table=False)) if unit \
        else (lambda x, y: st.run_vec_merge(x, y, table=False))

    def build(salt0):
        runs = []
        for i in range(a.chunks):
            runs.append(chunk(salt0 + i))
            _lsm(runs, a.max_runs, merge, lambda r: r.capacity)
        runs = [st.run_vec_with_table(r, unit) for r in runs]
        return runs, sum(r.bsum[8, -1].to(torch.int64) for r in runs)

    return build


def _debruijn(ctx: Context, quality: bool):
    a = ctx.args
    ctx.log(f"{'quality ' if quality else ''}de Bruijn build ({a.chunks} "
            f"chunks, max_runs={a.max_runs})…")
    (runs, total), times, kb, cs = _time_builds(
        ctx, _graph_build(ctx, quality))
    if quality:
        metric = ("kmers/s/chip (QUALITY de Bruijn build END-TO-END: %d "
                  "chunks, k=%d, edge bytes + phred scores + LSM merges + "
                  "int and float prefix tables included)" % (a.chunks, a.k))
    else:
        metric = ("kmers/s/chip (de Bruijn graph build END-TO-END: %d "
                  "chunks, k=%d, edge bytes + LSM merges + prefix tables "
                  "included)" % (a.chunks, a.k))
    return _result(ctx, metric, total, times, kb, cs), runs


def debruijn(ctx: Context):
    """The de Bruijn graph build.  State: its runs (`store.RunVecStore`
    with tables, one shard)."""
    return _debruijn(ctx, False)


def debruijn_quality(ctx: Context):
    """The quality de Bruijn graph build.  State: its runs
    (`store.RunVecQStore` with tables)."""
    return _debruijn(ctx, True)


# ------------------------------------------------------- multimap modes
def _next_pow2(v: int) -> int:
    return 1 << max(1, (int(v) - 1).bit_length())


def _position(ctx: Context, quality: bool):
    a, spec = ctx.args, ctx.spec
    n = a.bases
    dqual = (torch.from_numpy(ctx.qual_np()).to(ctx.device) if quality
             else None)
    hi = ctx.seg
    lo = (torch.arange(n, device=ctx.device) % a.read_len).to(torch.int32)
    flush = (st.multi_merge_flush if spec.sentinel_safe
             else st.multi_merge_flush_flagged)

    def build(salt0):
        store = st.empty_multi_store(_next_pow2(n), spec.nwords, ctx.device)
        ovf = 0
        for i in range(a.chunks):
            words, _ = kernels.extract_canonical(ctx.salted(salt0 + i), spec)
            wvalid = packing.window_valid(ctx.valid, ctx.seg, spec.k)
            wq = (window_quality(dqual, spec.k, ILLUMINA18) if quality
                  else None)
            need = _next_pow2((i + 1) * n)
            if need > store.capacity:
                store = st.multi_grow(store, need)
            store, o = flush(store, words, hi, lo, wvalid, val_q=wq)
            ovf = ovf + o
        return (store, ovf), store.size

    ctx.log(f"{a.mode} build ({a.chunks} chunks)…")
    ((store, ovf), total), times, kb, cs = _time_builds(ctx, build)
    ovf = int(ovf)
    metric = ("pairs/s/chip (%s multimap build END-TO-END: %d chunks, k=%d, "
              "64-bit ids%s, merge-based flushes + capacity growth included)"
              % ("position-quality" if quality else "position", a.chunks,
                 a.k, " + phred scores" if quality else ""))
    return _result(ctx, metric, total, times, kb, cs), (store, ovf)


def position(ctx: Context):
    """The position multimap build.  State: (`store.MultiStore`, the
    flushes' total overflow)."""
    return _position(ctx, False)


def position_quality(ctx: Context):
    """The position-quality multimap build.  State: (`store.MultiStore`
    with window qualities, total overflow)."""
    return _position(ctx, True)


MODES = {"e2e": e2e, "ingest": ingest, "count_query": count_query,
         "erase": erase, "multimap_find": multimap_find,
         "debruijn": debruijn, "debruijn_quality": debruijn_quality,
         "position": position, "position_quality": position_quality}


def run(args: argparse.Namespace):
    """(the JSON dict, the state) of args.mode on args.device."""
    ctx = Context.create(args)
    ctx.log(f"device: {ctx.device} ({torch.cuda.get_device_name(ctx.device)}"
            f")" if ctx.device.type == "cuda" else f"device: {ctx.device}")
    return MODES[args.mode](ctx)


def main(argv=None) -> int:
    args = parse_args(argv)
    try:
        result, _ = run(args)
    except NoDevice as e:
        print(f"kmerind_tpu_torch.bench.headline: {e}", file=sys.stderr)
        return 2
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
