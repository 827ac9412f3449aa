#!/usr/bin/env python3
"""Smoke run of the PyTorch port's indexes on one NVIDIA GPU.

    python3 chip_smoke.py

Phases (each prints its seconds; every timing line carries the card's name
and power limit as nvidia-smi reports them):

* P0  device: nvidia-smi name/power limit and torch's device name.
* P1  build: nvcc compiles the four CUDA sources of
      kmerind_tpu_torch/ops/csrc (one process each, all at once) into
      kmerind_tpu_torch/_build.
* P2  every kernel against its plain PyTorch version on the card, at the
      main paths' shapes (K1 also on its 128-bit state, on the wide
      kernel at DNA k = 65, 127, 255, 512, 1024, DNA16 k = 64 and ASCII
      k = 64, and on a view 4 bytes into a larger tensor; K4 also with key
      columns off 16 bytes); bitwise equality required.  Both
      timed over many launches (`median_ms`: CUDA events around runs of
      >= 20 back-to-back calls, median of 5 runs); beside the kernel one
      call alone (`single_ms`), the host's enqueue time per call
      (`host_ms`) and the profiler's device time per call (`device_ms`).
      Beside them: the kernel's bound (the bytes it must move,
      `kernel_bytes`, over the HBM rate) and, where one PyTorch call
      computes the same function, that call's time the same way (K3:
      torch.cumsum; K2 / K2′: a stable torch.sort of the runs' packed int64
      keys — a sort, the nearest single call to a merge).  The port never
      calls those.  K2 also runs in the multimap flush's shapes: a store
      of 2^26 rows merged with a batch of 2^24, 3 payloads (id halves and
      quality bits), with 2 key words and with the flagged merge's 3 (a
      liveness flag ahead of two full 32-bit words); and in P7's shapes:
      8,388,628 + 8,388,628 rows of 8 key words (k = 127), 2^26 + 2^24
      rows of 8 words with 3 payloads, and 2^22 + 2^22 rows of 33 (DNA k =
      512 full words and the flag) with 4 payloads, past the key words
      compared in registers; and in P9's: 8,388,628 + 8,388,628 rows of 2
      words with edge bytes (0-255) as the one payload of a unit merge and
      with (edge byte, weight) as 2; and in P10's: 2 key words with
      Bimolecule's 4 payloads (weight, both id halves as full 32-bit
      patterns, strand) at 8,388,628 + 8,388,628 rows and at a flush's
      2^26 + 2^24.  K3 also runs on a 2^28 edge-bit
      stream (0 / 1, a quarter ones) of the graph's counter tables.  K2′
      (the row-major merge) runs at w = 2 and w = 8 with one payload.  The
      one-run bitonic kernels run through their public callers,
      `sortops.bitonic_merge` (rows) and `bitonic_merge_cols`, on a
      [2^24, 2] bitonic run with one payload against the plain
      half-cleaner network on the card (keys bitwise, payloads per key
      run); the profiler must see no device kernel in a call but their
      split, partition and tile launches (no flipped or sliced copies).
* P3  exact reference: ~12M bases of synthetic reads indexed through
      CountIndex.insert_batch in 2^20-base chunks with max_runs=2 (many K2
      merges), then compact(); to_dict() must equal an independent numpy
      canonical 21-mer counter.
* P3s the same reads through SortedCountIndex with 4 shards: to_dict()
      equals the numpy counter, the shards hold contiguous key ranges that
      obey the splitter owner rule, items_in_range() of a slice equals
      numpy, and erasing 1,000 keys erases 1,000 that then count 0.
* P3p the same reads over 4 hash-partitioned shards: CountIndex with the
      "murmur" and the "farm" owner hash, to_dict() equal to the numpy
      counter and (murmur) every key on the shard an independent numpy
      MurmurHash3_x86_32 names; PositionIndex at k=21 and k=32 (the flagged
      merge) and SortedPositionQualityIndex at k=21, non-canonical, short
      ids: their pairs (the to_dict content) equal one pair per window of
      the reads, the ids derived from the fixed-width records, the
      qualities a float64 numpy window quality at rtol 1e-5.
* P4  full size, one bacterial sequencing run: reads at 30x coverage of a
      random genome of E. coli K-12 length (4,641,652 bp), 150 bp, half
      reverse-complemented, 0.5% substitutions, 0.1% N — about 139M bases,
      ~290 MB of FASTQ (phred 2-41, mostly high, drawn from the seed;
      `make_quals`) — built through CountIndex.build (the streaming
      path), 1M count() queries (900k read windows, 100k random k-mers)
      held exactly against a numpy count of all windows, items() (counts
      must sum to the window count), compact().  The kernel launch
      counters are zeroed just before and read just after: K1, K2 and K3
      must all have run.
* P5  the same FASTQ through SortedCountIndex.build on one shard: the 1M
      queries return P4's numpy reference counts, size() equals P4's
      distinct count, the store's counts sum to the window count,
      histogram() equals the numpy spectrum of the canonical 21-mer counts.
      Counters zeroed just before, read just after: K1 and K4 ran once per
      chunk.
* P6  the same FASTQ through PositionQualityIndex(canonical=True).build on
      one shard (K1 extracts, K2 flushes with 3 payloads): size() equals
      the window count, count() of the 1M queries P4's numpy counts, find
      (with_quality) of 10,000 sampled queries the numpy set of window ids
      per query with qualities at rtol 1e-4, erasing 1,000 keys erases
      exactly their pairs, and erase_if(window quality < a threshold that
      no numpy window quality lies within rtol 1e-5 of) erases numpy's
      count of such pairs, size() following; find of all 1M queries is
      timed.  Counters zeroed just before, read just after: K1 ran once
      per chunk, K2 at least once per flush.
* P7  wide k-mers: the same FASTQ at k = 127 DNA (8 key words, K1's wide
      kernel) on one shard.  CountIndex(max_runs=8).build: 1M count()
      queries (900k read windows, 100k random 127-mers) equal an
      independent numpy count of every canonical 127-mer window (4 uint64
      limbs a window, looked up by a 64-bit hash and checked limb by
      limb), items() counts sum to the window count;
      PositionQualityIndex(canonical=True).build: size() equals the window
      count, find(with_quality) of 10,000 sampled queries the numpy id
      sets with qualities at rtol 1e-4.  Counters zeroed just before, read
      just after: K1 ran once per chunk, all on the wide kernel; K2 at
      least once per merge or flush (w = 8, no payloads; w = 8, 3
      payloads).
* P8  the index surface at P4's size (runs after P6, before P7, while P4's
      numpy reference is held): CountIndex(KmerSpec(21, DNA)) on one shard
      over P4's FASTQ, each step timed and checked exactly against a numpy
      model of the contents — build, histogram(255) == the numpy spectrum;
      insert_counts of 1M (k-mer, count) pairs (500k read k-mers, 500k
      random, counts 1-1000 from the seed), then count() of the 1M P4
      queries == numpy counts plus the added ones; erase of 1M keys (half
      present) returns numpy's number of distinct present keys, which then
      count 0, and size() / the items() count sum follow; filter(c >= 2)
      drops numpy's singletons and empties bin 1; count_if(c >= t), t the
      lowest threshold selecting at most 1M keys, == numpy's selection; npz
      save -> CountIndex.load and save_index -> load_index answer the 1M
      queries like the saved index; CountIndex(saturate=20) over the same
      FASTQ: count() == min(numpy, 20), histogram == the clamped spectrum.
      Counters zeroed just before, read just after: K2 and K3 ran, K2 at
      least once with one payload (the weights; `kernels.
      K2_PAYLOAD_LAUNCHES` counts K2's launches by payload count).
* P9  the de Bruijn graphs over P4's FASTQ (after P8, while its queries
      are held; `phase_p9`), held exactly against a numpy model of every
      node's 9 counters under the dual-LUT rule (`graph_windows`: the
      k-mer reads N as A, an edge nibble is the neighbour's DNA16 code, N
      -> 0xF, flipped with the canonical strand).
      DeBruijnGraph(KmerSpec(21, DNA), max_runs=8).build (the streaming
      path): size() == the numpy node count; node_counts of P4's 1M
      queries == numpy (twice: the first call builds the counter tables
      and the query aux); items() == every numpy node and its counters,
      the self counters summing to the window count; edge_exists and
      neighbors of 1,000 nodes; compact(), then the same counts; an npz
      save / load round trip; a build of the first 50,000 reads again and
      its merge with the compacted run (counts == numpy's sum).
      QualityDeBruijnGraph on the same file: node_counts exact,
      node_quality of 10,000 nodes at rtol 1e-5 against float64 numpy
      window qualities.  Counters zeroed before each build and read after:
      K1 once per chunk, K2 with 1 payload (unit merges of the edge byte)
      at least once per merge of the first build, K3 at least 8 per
      counter table, K2 with 2 payloads (edge byte, weight) after the
      compaction and the further ingest, and the quality graph's unit merges
      with 2 (edge byte, quality bits).

* P10 Bimolecule and the value maps over P4's FASTQ (after P9, while P4's
      numpy reference is held; `phase_p10`), held exactly against a numpy
      model (`p10_model`: each canonical 21-mer's count, the input strand
      of its first window in file order, the short ids of its first and
      last windows).  BimoleculeCountIndex(KmerSpec(21, DNA)).build (the
      streaming path): size() == distinct; count() of the 1M queries as
      given (twice) and reverse-complemented == numpy; items() == every
      key in its stored orientation with its count; find of 10,000
      sampled read windows, half reverse-complemented, == the stored
      orientations and counts; insert of 1,000 present keys in their other
      orientation keeps every orientation, adds 1; erase of 1M keys (half
      present) == numpy's distinct present keys, size() follows;
      compact() and an npz save / load keep every answer.
      KmerValueIndex(reduce="min") and SortedKmerValueIndex(reduce="max")
      over the same FASTQ (short ids): size(), find of the 1M queries
      (found, and the value == numpy's min / max id), erase_if(id in the
      first tenth of the reads) == numpy's count, an npz round trip.
      Counters zeroed before each build and read after its checks: K1
      once per chunk in all three, K2 with 4 payloads at least once per
      Bimolecule merge, K3 > 0.  Then over 4 shards at P3's size
      (`phase_p10p`): the three classes' to_dict() == the model.
* P11 several processes (after P10, while P4's queries are held;
      `phase_p11`): 2 rank processes started by `parallel.multihost.
      launch` — one rank per card over NCCL with 2 or more cards, else
      both on cuda:0 over gloo (the exchanges staged through host memory;
      the phase's lines name the backend and `torch.cuda.device_count()`).
      Every index holds 2 shards, one a rank, and each rank parses only
      its own byte blocks (`p11_rank`): CountIndex.build over P4's FASTQ
      (the lockstep streamed path): the 1M queries == P4's numpy counts,
      size() == the distinct count, items() counts sum to the windows,
      every key of a rank's shard on the shard its numpy murmur3 names;
      SortedCountIndex the same queries and size; at P3's size
      PositionIndex's pairs == the numpy multimap, KmerValueIndex("min")
      and BimoleculeCountIndex to_dict == the P10 model, DeBruijnGraph's
      items() == the numpy nodes; the CLI over both ranks (-S 100
      --json) and, on rank 0, the micro bench at its default n.  Each rank
      zeroes its counters before each build and reads them after it: K1,
      K2 and K3 ran on every rank in the count build, K1 and K4 in the
      sorted one; the per-rank counts join the kernels line.  A rank that
      fails or outlives 600 s fails the smoke.
* P12 the headline bench (`kmerind_tpu_torch.bench.headline`, `bench.py`'s
      counterpart) in this process, after P7: its nine modes at bench.py's
      defaults (2^24 bases a chunk, 8 chunks, max_runs 4, 2^20 queries, 3
      iterations) and e2e at k = 63 and k = 16, each JSON line printed
      with the card, the iterations' times and the peak device memory;
      answers held: e2e / ingest / the graphs / the multimaps store the
      closed-form count of in-read windows (the multimaps without
      overflow), every sampled query counts > 0 (counts summing to >= m),
      the erase takes the same positive count from the same snapshot every
      time, the multimap finds >= m pairs.  Then `sortops.bitonic_merge`
      and `bitonic_merge_cols` (the one-run kernels) on a [2^24, 2]
      bitonic run, and `sortops.merge_sorted_runs` (K2′) on its two
      halves: each a sorted permutation of its input.  Then
      `p12_exact`: e2e, debruijn and position_quality at 2^20 bases x 3
      chunks, held exactly against numpy (counts per canonical 21-mer,
      each node's 9 counters and each run's table totals, every pair with
      its quality at rtol 1e-5).  Counters zeroed before P12, read after:
      K1, K2, K2′, both one-run kernels and K3 ran.

Exits non-zero, printing no result, when there is no CUDA device, a build
fails or any check fails.  The last line of standard output is the
contract JSON; the line before it lists the kernels with their launches
in the main-path runs P4 + P5 + P6 + P7 + P8 + P9 + P10 + P11 + P12 (P11:
the ranks' sum; `p11_launches_by_rank` per rank; K2′'s and the one-run
kernels' all in P12).
"""

from __future__ import annotations

import collections
import json
import math
import pathlib
import re
import statistics
import subprocess
import sys
import tempfile
import time

import numpy as np

K = 21
K_WIDE = 127                       # P7: DNA k-mers of 8 key words
CHUNK = (1 << 23) + K - 1          # default_chunk_bases + the k-1 halo
GENOME_LEN = 4_641_652             # E. coli K-12 MG1655
READ_LEN = 150
COVERAGE = 30
HBM_BYTES_PER_S = 3.35e12          # H100 SXM HBM3, NVIDIA's data sheet
SEQ_OFFSET = 10                    # "@r0000000\n" before each sequence
RECORD_BYTES = SEQ_OFFSET + 2 * (READ_LEN + 1) + 2


def kernel_bytes(kname: str, **shape) -> int:
    """Bytes a kernel must move at the least: each input read once, each
    output written once, from the call's shapes.

    extract_canonical(n, nwords): uint8 codes in; int32 [nwords, n] words
    and bool [n] was_rc out.  merge_runs_cols(na, nb, n_out, w, npay): w
    key words ([w, n] column-major) and npay payloads of int32 per row, na
    + nb rows in, n_out out; merge_sorted_runs the same with row-major [n,
    w] keys (the same bytes).  bitonic_merge_rows / bitonic_merge_cols(n,
    w, npay): one run of n rows of w key words and npay int32 payloads in,
    n rows out.  prefix_sum_i32(n): int32 in and out.
    run_length_weights(n, w): int32 [w, n] keys and the int32 valid count
    in, int32 [n] weights out."""
    if kname == "extract_canonical":
        return shape["n"] * (1 + 4 * shape["nwords"] + 1)
    if kname in ("merge_runs_cols", "merge_sorted_runs"):
        row = 4 * (shape["w"] + shape["npay"])
        return (shape["na"] + shape["nb"] + shape["n_out"]) * row
    if kname in ("bitonic_merge_rows", "bitonic_merge_cols"):
        return 2 * shape["n"] * 4 * (shape["w"] + shape["npay"])
    if kname == "prefix_sum_i32":
        return 8 * shape["n"]
    if kname == "run_length_weights":
        return 4 * shape["w"] * shape["n"] + 4 + 4 * shape["n"]
    raise KeyError(kname)


def bound_ms(nbytes: int) -> float:
    """Least milliseconds to move `nbytes` at the HBM rate."""
    return nbytes / HBM_BYTES_PER_S * 1e3


def murmur3_x86_32(rows: np.ndarray, seed: int = 42) -> np.ndarray:
    """uint32[n] MurmurHash3_x86_32 of each row of uint32[n, w] key words,
    each word one little-endian 4-byte block (4 * w bytes, no tail) —
    written from the published algorithm in plain numpy uint32 arithmetic,
    independent of the port, to check the owner of every stored key."""
    with np.errstate(over="ignore"):
        rows = np.asarray(rows, np.uint32)
        h = np.full(rows.shape[0], seed, np.uint32)
        def rotl(x, r):
            return (x << np.uint32(r)) | (x >> np.uint32(32 - r))
        for j in range(rows.shape[1]):
            k1 = rows[:, j] * np.uint32(0xCC9E2D51)
            k1 = rotl(k1, 15) * np.uint32(0x1B873593)
            h = rotl(h ^ k1, 13) * np.uint32(5) + np.uint32(0xE6546B64)
        h ^= np.uint32(4 * rows.shape[1])
        h ^= h >> np.uint32(16)
        h *= np.uint32(0x85EBCA6B)
        h ^= h >> np.uint32(13)
        h *= np.uint32(0xC2B2AE35)
        return h ^ (h >> np.uint32(16))


def log(msg: str):
    print(msg, flush=True)


def median_ms(fn, reps: int = 5, calls: int = 20,
              min_run_ms: float = 2.0) -> float:
    """Milliseconds per call of fn(), timed over many launches: one warm-up
    call; a first run of `calls` back-to-back calls between two CUDA
    events, and if it took less than `min_run_ms`, enough calls to pass
    it; then `reps` such runs, each run's time over its calls.  Returns
    the median of the `reps` per-call times.  The host enqueues the calls
    while the device runs earlier ones, so a call's dispatch lands inside a
    run only where it is slower than the device work."""
    import torch
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)

    def run(m):
        start.record()
        for _ in range(m):
            fn()
        end.record()
        end.synchronize()
        return start.elapsed_time(end)

    fn()
    first = run(calls)
    if first < min_run_ms:
        calls = math.ceil(calls * min_run_ms / max(first, 1e-3))
    return statistics.median(run(calls) / calls for _ in range(reps))


def single_ms(fn, reps: int = 5) -> float:
    """Median CUDA-event time of ONE call of fn() over reps calls, after a
    warm-up: the host's dispatch of the call lies inside the events."""
    import torch
    fn()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def host_ms(fn, calls: int = 50) -> float:
    """Host milliseconds per call of fn() while the calls are enqueued (the
    device may still run them): where this exceeds the device time of a
    call, `median_ms` measures the host."""
    import torch
    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(calls):
        fn()
    t1 = time.perf_counter()
    torch.cuda.synchronize()
    return (t1 - t0) / calls * 1e3


def per_call_us(trace: dict, calls: int) -> dict:
    """{CUDA kernel name: device us per call} from a chrome trace of
    `calls` calls: each name's mean recorded launch times its launches per
    call, so a launch record the profiler drops (seen now and then on an
    H100) does not lower the time."""
    durs = {}
    for ev in trace["traceEvents"]:
        if ev.get("cat") == "kernel" and "dur" in ev:
            m = re.search(r"(\w+)(?:<[^>]*>)?\(", ev["name"])
            name = m.group(1) if m else ev["name"]
            durs.setdefault(name, []).append(float(ev["dur"]))
    return {name: sum(d) / len(d) * max(1, round(len(d) / calls))
            for name, d in durs.items()}


def kernel_us_per_call(fn, calls: int = 3, attempts: int = 3) -> dict:
    """{CUDA kernel name: device us per call} of fn() under torch.profiler
    (the kernels' own time on the device, without the gaps between them;
    memsets and copies are not kernels and do not count), `per_call_us` of
    the trace.  A pass that records no kernel at all is run again, up to
    `attempts` passes ({} if none records any)."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    fn()
    us = {}
    for _ in range(attempts):
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(calls):
                fn()
            torch.cuda.synchronize()
        with tempfile.TemporaryDirectory() as tmp:
            path = pathlib.Path(tmp) / "t.json"
            prof.export_chrome_trace(str(path))
            us = per_call_us(json.loads(path.read_text()), calls)
        if us:
            break
    return us


def make_reads(genome_len: int, n_reads: int, seed: int) -> np.ndarray:
    """uint8[n_reads, READ_LEN] codes (A,C,G,T = 0..3, N = 4): reads of a
    random genome, half reverse-complemented, 0.5% substitutions, 0.1% N."""
    rng = np.random.default_rng(seed)
    genome = rng.integers(0, 4, genome_len, dtype=np.uint8)
    windows = np.lib.stride_tricks.sliding_window_view(genome, READ_LEN)
    codes = windows[rng.integers(0, genome_len - READ_LEN + 1, n_reads)]
    flip = rng.random(n_reads) < 0.5
    codes[flip] = 3 - codes[flip, ::-1]
    flat = codes.reshape(-1)
    nsub = rng.binomial(flat.size, 0.005)
    pos = rng.integers(0, flat.size, nsub)
    flat[pos] = (flat[pos] + rng.integers(1, 4, nsub, dtype=np.uint8)) % 4
    flat[rng.integers(0, flat.size, rng.binomial(flat.size, 0.001))] = 4
    return codes


def make_quals(codes: np.ndarray, seed: int) -> np.ndarray:
    """uint8[n_reads, READ_LEN] phred scores for the reads `codes`, drawn
    from the seed after the reads (which they do not change): 2-41, mostly
    high, 2 ('#') on every N, and 0 ('!', a base the codec reads as
    incorrect, whose windows have quality exactly 0) at a rate of 0.05 %."""
    rng = np.random.default_rng(seed + 1000)
    q = 41 - np.minimum(rng.geometric(0.15, codes.shape) - 1, 39)
    q[codes == 4] = 2
    q[rng.random(codes.shape) < 0.0005] = 0
    return q.astype(np.uint8)


def window_quality(quals: np.ndarray, k: int = K) -> np.ndarray:
    """float64[n_reads, READ_LEN - k + 1] quality of every k-window of the
    phred scores `quals`: the product of its bases' probabilities of being
    right, 1 - 10^(-q/10), or 0 where a base has phred 0 — from float64
    prefix sums of the log2 probabilities, independent of the port's
    tables and float32 sums."""
    with np.errstate(divide="ignore"):
        logp = np.where(quals == 0, 0.0, np.log2(
            1.0 - 10.0 ** (-quals.astype(np.float64) / 10.0)))
    nwin = quals.shape[1] - k + 1
    pad = ((0, 0), (1, 0))
    cs = np.pad(np.cumsum(logp, axis=1), pad)
    zeros = np.pad(np.cumsum(quals == 0, axis=1), pad)
    bad = zeros[:, k:k + nwin] > zeros[:, :nwin]
    return np.where(bad, 0.0, np.exp2(cs[:, k:k + nwin] - cs[:, :nwin]))


def write_fastq(codes: np.ndarray, quals: np.ndarray, path: pathlib.Path):
    """Fixed-width FASTQ records (RECORD_BYTES each, the sequence at byte
    SEQ_OFFSET of its record), written in one vectorized pass."""
    n = codes.shape[0]
    width = RECORD_BYTES
    rec = np.empty((n, width), np.uint8)
    rec[:, 0], rec[:, 1] = ord("@"), ord("r")
    ids = np.arange(n)
    for p in range(7):
        rec[:, 2 + p] = 48 + (ids // 10 ** (6 - p)) % 10
    s = 10 + READ_LEN
    rec[:, 9] = rec[:, s] = rec[:, s + 2] = rec[:, width - 1] = 10
    rec[:, 10:s] = np.frombuffer(b"ACGTN", np.uint8)[codes]
    rec[:, s + 1] = ord("+")
    rec[:, s + 3:width - 1] = 33 + quals
    rec.tofile(path)


def short_ids(starts: np.ndarray) -> np.ndarray:
    """uint64 position id (the short-read id: record start << 16 | offset
    in the record) of the windows at (read, offset) rows `starts` of a
    `write_fastq` file."""
    rec = starts[:, 0].astype(np.uint64) * np.uint64(RECORD_BYTES)
    return (rec << np.uint64(16)) | (starts[:, 1].astype(np.uint64)
                                     + np.uint64(SEQ_OFFSET))


def canonical_codes(codes: np.ndarray):
    """(uint64 canonical 2-bit codes of every k-window, window has N)."""
    c = codes.astype(np.int64)
    nwin = codes.shape[1] - K + 1
    fwd = np.zeros((codes.shape[0], nwin), np.int64)
    rc = np.zeros_like(fwd)
    has_n = np.zeros(fwd.shape, bool)
    for j in range(K):
        fwd = fwd * 4 + c[:, j:j + nwin]
        has_n |= codes[:, j:j + nwin] == 4
    for j in range(K - 1, -1, -1):
        rc = rc * 4 + (3 - c[:, j:j + nwin])
    return np.minimum(fwd, rc).astype(np.uint64), has_n


def window_codes(codes: np.ndarray, k: int = K,
                 canonical: bool = True) -> np.ndarray:
    """uint64[n_reads, READ_LEN - k + 1] 2-bit codes of every k-window of
    the reads, N read as A (the DNA alphabet's encoding): canonical (the
    smaller of the window and its reverse complement) or forward.  Blocks
    of 100,000 reads keep the temporaries small."""
    out = []
    two = np.uint64(2)
    for lo in range(0, codes.shape[0], 100_000):
        c = codes[lo:lo + 100_000].astype(np.uint64)
        c[c == 4] = 0
        nwin = c.shape[1] - k + 1
        fwd = np.zeros((c.shape[0], nwin), np.uint64)
        for j in range(k):
            fwd = (fwd << two) | c[:, j:j + nwin]
        if canonical:
            rc = np.zeros_like(fwd)
            for j in range(k - 1, -1, -1):
                rc = (rc << two) | (np.uint64(3) - c[:, j:j + nwin])
            fwd = np.minimum(fwd, rc)
        out.append(fwd)
    return np.concatenate(out)


def expected_counts(sorted_codes: np.ndarray, qcodes: np.ndarray
                    ) -> np.ndarray:
    """Exact count of each query k-mer (rows of codes, canonicalised) among
    the sorted canonical codes of all windows (`window_codes`)."""
    q = window_codes(qcodes)[:, 0]
    return (np.searchsorted(sorted_codes, q, "right")
            - np.searchsorted(sorted_codes, q, "left"))


def distinct_counts(sorted_codes: np.ndarray):
    """(distinct keys, int64 count of each) of a sorted 1-d key array: the
    lengths of its runs of equal values."""
    if sorted_codes.size == 0:
        return sorted_codes[:0], np.zeros(0, np.int64)
    heads = np.flatnonzero(np.diff(sorted_codes)) + 1
    starts = np.concatenate([[0], heads])
    return sorted_codes[starts], np.diff(np.append(starts, sorted_codes.size))


def add_counts(keys, cnts, add_keys, add_cnts):
    """(sorted distinct keys, summed int64 counts) of two (key, count) sets:
    a counting map's contents after inserting (add_keys, add_cnts)."""
    all_keys = np.concatenate([keys, add_keys])
    order = np.argsort(all_keys, kind="stable")
    out, runs = distinct_counts(all_keys[order])
    starts = np.concatenate([[0], np.cumsum(runs)[:-1]])
    summed = np.concatenate([cnts, add_cnts]).astype(np.int64)[order]
    return out, np.add.reduceat(summed, starts) if out.size else runs


def spectrum(counts: np.ndarray, max_count: int = 255) -> np.ndarray:
    """int64[max_count + 1] k-mer spectrum of per-key counts: how many keys
    have each count, counts above max_count in the last bin (what
    CountIndex.histogram returns)."""
    return np.bincount(np.minimum(counts, max_count),
                       minlength=max_count + 1).astype(np.int64)


def code_rows(codes: np.ndarray) -> np.ndarray:
    """uint32[m, 2] DNA words (`pack_rows` layout) of 2-bit 21-mer codes
    (uint64, base 0 most significant)."""
    codes = np.asarray(codes, np.uint64)
    return np.stack([(codes >> np.uint64(10)).astype(np.uint32),
                     (codes & np.uint64(0x3FF)).astype(np.uint32)], axis=1)


def pack_rows(codes: np.ndarray) -> np.ndarray:
    """uint32[m, ceil(k / 16)] DNA words (kmer.py layout: 16 bases a word,
    the last word right-aligned) of [m, k] codes."""
    c = codes.astype(np.uint32)
    k = codes.shape[1]
    words = []
    for lo in range(0, k, 16):
        w = np.zeros(codes.shape[0], np.uint32)
        for j in range(lo, min(lo + 16, k)):
            w = (w << np.uint32(2)) | c[:, j]
        words.append(w)
    return np.stack(words, axis=1)


def canonical_limbs(codes: np.ndarray, k: int = K_WIDE) -> np.ndarray:
    """uint64[n_reads * (READ_LEN - k + 1), 4] canonical k-mer (96 < k <=
    128) of every k-window of the reads, N read as A: the smaller of the
    window and its reverse complement as a number of 2k bits, in 4 limbs,
    most significant first (their lexicographic order is the bases' order).
    Each read's first window is packed base by base, the next ones rolled
    in one base at a time (both strands, carries across the limbs); blocks
    of 100,000 reads keep the temporaries small."""
    assert 96 < k <= 128
    u = np.uint64
    top = 2 * (k - 1) - 192                  # bit of base 0 in limb 0
    mask0 = u((1 << (2 * k - 192)) - 1)
    out = []
    for lo in range(0, codes.shape[0], 100_000):
        c = codes[lo:lo + 100_000].astype(np.uint64)
        c[c == 4] = 0
        nwin = c.shape[1] - k + 1
        f = [np.zeros(c.shape[0], np.uint64) for _ in range(4)]
        r = [np.zeros(c.shape[0], np.uint64) for _ in range(4)]
        # the first window; base j of its reverse complement is 3 - base
        # k-1-j
        for j in range(k):
            t = 3 - (k - 1 - j) // 32          # the limb base j falls in
            f[t] = (f[t] << u(2)) | c[:, j]
            r[t] = (r[t] << u(2)) | (u(3) - c[:, k - 1 - j])
        win = np.empty((c.shape[0], nwin, 4), np.uint64)
        for o in range(nwin):
            if o:
                x = c[:, o + k - 1]
                f[0] = ((f[0] << u(2)) | (f[1] >> u(62))) & mask0
                f[1] = (f[1] << u(2)) | (f[2] >> u(62))
                f[2] = (f[2] << u(2)) | (f[3] >> u(62))
                f[3] = (f[3] << u(2)) | x
                r[3] = (r[3] >> u(2)) | ((r[2] & u(3)) << u(62))
                r[2] = (r[2] >> u(2)) | ((r[1] & u(3)) << u(62))
                r[1] = (r[1] >> u(2)) | ((r[0] & u(3)) << u(62))
                r[0] = (r[0] >> u(2)) | ((u(3) - x) << u(top))
            rc_less = np.zeros(c.shape[0], bool)
            for t in range(3, -1, -1):
                rc_less = np.where(r[t] != f[t], r[t] < f[t], rc_less)
            for t in range(4):
                win[:, o, t] = np.where(rc_less, r[t], f[t])
        out.append(win.reshape(-1, 4))
    return np.concatenate(out)


def limb_hash(limbs: np.ndarray) -> np.ndarray:
    """uint64 hash of each row of uint64[n, 4] limbs (splitmix64 finalizer
    over a running combination); equal rows hash equal."""
    with np.errstate(over="ignore"):
        h = np.zeros(limbs.shape[0], np.uint64)
        for t in range(limbs.shape[1]):
            h = (h ^ limbs[:, t]) * np.uint64(0x9E3779B97F4A7C15)
            h ^= h >> np.uint64(31)
            h *= np.uint64(0xBF58476D1CE4E5B9)
            h ^= h >> np.uint64(27)
        return h


class LimbCounter:
    """Exact multiset of canonical limb rows: rows sorted by `limb_hash`
    (`order`: their indices in the input); counts of query rows by a binary
    search of their hashes, each hit checked limb by limb (a hash shared by
    two different rows raises)."""

    def __init__(self, limbs: np.ndarray):
        h = limb_hash(limbs)
        self.order = np.argsort(h)
        self.h, self.rows = h[self.order], limbs[self.order]
        same = self.h[1:] == self.h[:-1]
        if (self.rows[1:][same] != self.rows[:-1][same]).any():
            raise AssertionError("limb_hash collision in the reference")

    def span(self, q: np.ndarray):
        """(first index, count) of each query row among the rows."""
        hq = limb_hash(q)
        lo = np.searchsorted(self.h, hq, "left")
        cnt = np.searchsorted(self.h, hq, "right") - lo
        hit = cnt > 0
        if (self.rows[lo[hit]] != q[hit]).any():
            raise AssertionError("limb_hash collision with a query")
        return lo, cnt


def sync(dev):
    """Wait for the device's queued work (nothing to wait for on the CPU)."""
    import torch
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def peak_bytes(dev) -> int | None:
    """Peak bytes allocated on the device since the last reset (None on the
    CPU)."""
    import torch
    return torch.cuda.max_memory_allocated(dev) if dev.type == "cuda" else None


def phase_p3p(dev, codes, quals, path, batch, want, smi):
    """P3p: P3's reads through 4 hash-partitioned shards and the multimaps
    (the module docstring); raises on any difference from numpy."""
    from kmerind_tpu_torch import (DNA, CountIndex, KmerSpec, PositionIndex,
                                   SortedPositionQualityIndex)
    from kmerind_tpu_torch.io import read_file
    spec = KmerSpec(K, DNA)
    t0 = time.perf_counter()
    for hash_name in ("murmur", "farm"):
        hidx = CountIndex(spec, device=dev, nparts=4, max_runs=2,
                          hash_name=hash_name)
        hidx.insert_batch(batch, chunk_bases=1 << 20)
        if hidx.to_dict() != want:
            raise AssertionError(f"P3p CountIndex(nparts=4, {hash_name}):"
                                 " to_dict != numpy counter")
        sizes = hidx.local_sizes()
        if hash_name == "murmur":
            # p = 4: the owner is the hash's top 2 bits
            rows, _ = hidx.items()
            owner = murmur3_x86_32(rows) >> np.uint32(30)
            if not np.array_equal(owner, np.repeat(np.arange(4), sizes)):
                raise AssertionError("P3p: a key lies off the shard its "
                                     "numpy murmur3 owner names")
        log(f"P3p CountIndex(nparts=4, hash_name={hash_name!r}): shard "
            f"sizes {sizes} == numpy counter"
            + (", every key on its numpy murmur3 owner"
               if hash_name == "murmur" else "") + f" [{smi}]")
        del hidx

    def same_pairs(tag, got, keys, quals=None):
        """The index's pairs (kmer ints, ids, qualities) == one pair
        per window of the P3 reads: the to_dict content, compared as
        arrays in id order (every window has its own id)."""
        gk, gi, gq = got
        nw = keys.shape[1]
        r, o = np.divmod(np.arange(keys.size), nw)
        order = np.argsort(gi)
        if not (np.array_equal(gi[order], short_ids(np.stack([r, o], 1)))
                and np.array_equal(gk[order].astype(np.uint64),
                                   keys.ravel())):
            raise AssertionError(f"P3p {tag}: pairs != numpy multimap")
        if quals is None:
            return ""
        gq, wq = gq[order], quals.ravel()
        if not (np.array_equal(gq == 0, wq == 0)
                and np.allclose(gq, wq, rtol=1e-5, atol=0)):
            raise AssertionError(f"P3p {tag}: qualities off by more "
                                 "than rtol 1e-5")
        live = wq > 0
        return (f", {int((~live).sum())} exact zeros, qualities max rel "
                f"err {np.max(np.abs(gq[live] - wq[live]) / wq[live]):.3e}")

    plain = read_file(path, DNA)      # N read as A: every window valid
    for k, cls in ((21, PositionIndex), (32, PositionIndex),
                   (21, SortedPositionQualityIndex)):
        pidx = cls(KmerSpec(k, DNA), device=dev, nparts=4,
                   canonical=False)
        pidx.insert_batch(plain, chunk_bases=1 << 20)
        tag = f"{cls.__name__}(nparts=4) k={k}"
        extra = same_pairs(tag, pidx.pairs(),
                           window_codes(codes, k, canonical=False),
                           window_quality(quals, k)
                           if pidx.with_quality else None)
        log(f"P3p {tag}: {pidx.size()} pairs == numpy multimap of every "
            f"window (short ids){extra} [{smi}]")
        del pidx
    del plain
    log(f"P3p seconds {time.perf_counter() - t0:.2f} [{smi}]")


def phase_p6(dev, path, quals, qcodes, queries, canon_all, want_counts, smi,
             n_sample: int = 10_000, n_erase: int = 1000) -> dict:
    """P6: P4's FASTQ through PositionQualityIndex (the module docstring):
    `n_sample` finds are checked against numpy and `n_erase` keys erased.
    Returns the kernel launches of its run; raises on any difference from
    numpy."""
    import torch
    from kmerind_tpu_torch import DNA, KmerSpec, PositionQualityIndex
    from kmerind_tpu_torch.ops import kernels
    spec = KmerSpec(K, DNA)
    n_windows = canon_all.size
    # the numpy reference first: every window with the canonical key of one
    # of the sampled queries (all read windows: the first 90 %), its id and
    # quality
    rng = np.random.default_rng(6)
    sample = rng.choice(queries.shape[0] * 9 // 10, n_sample, replace=False)
    uq, inv = np.unique(window_codes(qcodes[sample])[:, 0],
                        return_inverse=True)
    flat = canon_all.reshape(-1)
    pos = np.searchsorted(uq, flat).clip(max=uq.size - 1)
    widx = np.flatnonzero(uq[pos] == flat)
    nwin = READ_LEN - K + 1
    w_key = pos[widx]
    w_id = short_ids(np.stack(np.divmod(widx, nwin), 1))
    wq_all = window_quality(quals).reshape(-1)
    w_q = wq_all[widx]
    order = np.lexsort((w_id, w_key))
    w_key, w_id, w_q = w_key[order], w_id[order], w_q[order]
    bounds = np.searchsorted(w_key, np.arange(uq.size + 1))
    del flat, pos, widx, order

    pq = PositionQualityIndex(spec, canonical=True, device=dev)
    sync(dev)
    if dev.type == "cuda":
        torch.cuda.reset_peak_memory_stats(dev)
    kernels.reset_launches()
    t0 = time.perf_counter()
    pq.build(path)
    sync(dev)
    build_s = time.perf_counter() - t0
    chunks = pq.timer.count("insert")
    t0 = time.perf_counter()
    size = pq.size()
    flush_s = time.perf_counter() - t0
    merges = pq.timer.count("merge")
    build_peak = peak_bytes(dev)
    if size != n_windows:
        raise AssertionError(f"P6: size {size} != {n_windows} windows")
    t0 = time.perf_counter()
    counts = pq.count(queries)
    count_s = time.perf_counter() - t0
    if not np.array_equal(counts, want_counts):
        raise AssertionError(
            f"P6: {int((counts != want_counts).sum())} of {counts.size} "
            "counts differ from the numpy reference")
    f_s = []
    for _ in range(2):
        t0 = time.perf_counter()
        f_ids, f_q, f_mask = pq.find(queries, with_quality=True)
        f_s.append(time.perf_counter() - t0)
    width = f_ids.shape[1]
    del f_ids, f_q, f_mask
    f_ids, f_q, f_mask = pq.find(queries[sample], with_quality=True)
    worst = 0.0
    for i in range(sample.size):
        lo, hi = bounds[inv[i]], bounds[inv[i] + 1]
        got_ids, got_q = f_ids[i][f_mask[i]], f_q[i][f_mask[i]]
        o = np.argsort(got_ids)
        got_ids, got_q = got_ids[o], got_q[o].astype(np.float64)
        if not np.array_equal(got_ids, w_id[lo:hi]):
            raise AssertionError(f"P6: find of sampled query {i}: ids != "
                                 "the numpy window ids")
        want_q = w_q[lo:hi]
        if not (np.array_equal(got_q == 0, want_q == 0) and np.allclose(
                got_q, want_q, rtol=1e-4, atol=0)):
            raise AssertionError(f"P6: find of sampled query {i}: "
                                 "qualities off by more than rtol 1e-4")
        live = want_q > 0
        if live.any():
            worst = max(worst, float(np.max(
                np.abs(got_q[live] - want_q[live]) / want_q[live])))
    # erase n_erase distinct sampled keys: exactly their pairs go
    first = np.unique(inv, return_index=True)[1][:n_erase]
    gone_pairs = int(np.diff(bounds)[inv[first]].sum())
    t0 = time.perf_counter()
    erased = pq.erase(queries[sample[first]])
    erase_s = time.perf_counter() - t0
    if (erased != gone_pairs or pq.count(queries[sample[first]]).any()
            or pq.size() != n_windows - gone_pairs):
        raise AssertionError(f"P6: erase of {first.size} keys took {erased} "
                             f"pairs, not their {gone_pairs}")
    # a quality-aware cut: erase_if every pair whose window quality is under
    # a threshold that no window's numpy quality lies within rtol 1e-5 of
    # (the port's float32 qualities agree to rtol 1e-5), less the windows
    # of the keys erased above
    thr = next(t for t in (0.5, 0.25, 0.1, 0.05, 0.01, 1e-3, 1e-6)
               if not ((wq_all > t * (1 - 1e-5))
                       & (wq_all < t * (1 + 1e-5))).any())
    gone_q = np.concatenate([w_q[bounds[e]:bounds[e + 1]]
                             for e in inv[first]])
    want_cut = int((wq_all < thr).sum()) - int((gone_q < thr).sum())
    del wq_all
    t0 = time.perf_counter()
    cut = pq.erase_if(lambda k, h, l, q: q < thr)
    cut_s = time.perf_counter() - t0
    if cut != want_cut or pq.size() != n_windows - gone_pairs - want_cut:
        raise AssertionError(f"P6: erase_if(quality < {thr}) took {cut} "
                             f"pairs, numpy {want_cut}")
    p6 = dict(kernels.LAUNCHES)
    peak = peak_bytes(dev)
    nq = queries.shape[0]
    log(f"P6 PositionQualityIndex, canonical, 1 shard: build "
        f"{build_s:.3f} s = {n_windows / build_s:.0f} k-mers/s, {chunks} "
        f"chunks, {merges} flushes (the first size(), flushing what was "
        f"left pending, {flush_s:.3f} s), size {size} == windows; peak "
        f"device memory "
        f"{build_peak} bytes after the build, {peak} in all [{smi}]")
    log(f"P6 queries: count {nq} {count_s:.3f} s = {nq / count_s:.0f} "
        f"q/s == P4 numpy counts; find(with_quality) of {nq}, width "
        f"{width}: first {f_s[0]:.3f} s = {nq / f_s[0]:.0f} q/s, second "
        f"{f_s[1]:.3f} s = {nq / f_s[1]:.0f} q/s; {sample.size} sampled "
        f"finds == numpy id sets ({bounds[-1]} pairs), qualities max rel "
        f"err {worst:.3e} (rtol 1e-4); erase of {first.size} keys took "
        f"their {erased} pairs in {erase_s:.3f} s; erase_if(window quality "
        f"< {thr}) took numpy's {cut} pairs in {cut_s:.3f} s [{smi}]")
    log("P6 phases:\n" + pq.timer.report("P6"))
    log(f"P6 launches: {p6}")
    if p6["extract_canonical"] != chunks:
        raise AssertionError(f"P6: K1 launches != {chunks} chunks")
    if p6["merge_runs_cols"] < merges or not merges:
        raise AssertionError(f"P6: K2 launches < {merges} flushes")
    return p6


def phase_p7(dev, path, codes, quals, smi, n_queries: int = 1_000_000,
             n_sample: int = 10_000) -> dict:
    """P7: P4's FASTQ at k = 127 (the module docstring) through CountIndex
    and PositionQualityIndex on one shard.  Returns the kernel launches of
    its run; raises on any difference from numpy."""
    import torch
    from kmerind_tpu_torch import DNA, CountIndex, KmerSpec, PositionQualityIndex
    from kmerind_tpu_torch.ops import kernels
    spec = KmerSpec(K_WIDE, DNA)
    nwin = READ_LEN - K_WIDE + 1
    n_reads = codes.shape[0]
    n_windows = n_reads * nwin
    # the numpy reference: canonical limbs of every window, and the queries
    t0 = time.perf_counter()
    limbs = canonical_limbs(codes)
    ref = LimbCounter(limbs)
    rng = np.random.default_rng(7)
    n_read_q = n_queries * 9 // 10
    r = rng.integers(0, n_reads, n_read_q)
    o = rng.integers(0, nwin, n_read_q)
    qcodes = np.concatenate([
        codes[r[:, None], o[:, None] + np.arange(K_WIDE)],
        rng.integers(0, 4, (n_queries - n_read_q, K_WIDE), dtype=np.uint8)])
    qcodes[qcodes == 4] = 0               # DNA encodes N as A
    queries = pack_rows(qcodes)
    qlimbs = canonical_limbs(qcodes)
    want_counts = ref.span(qlimbs)[1]
    ref_s = time.perf_counter() - t0
    log(f"P7 numpy reference: {n_windows} canonical {K_WIDE}-mer windows, "
        f"{n_queries} queries, {ref_s:.2f} s [{smi}]")

    sync(dev)
    if dev.type == "cuda":
        torch.cuda.reset_peak_memory_stats(dev)
    kernels.reset_launches()
    idx = CountIndex(spec, device=dev, max_runs=8)
    t0 = time.perf_counter()
    idx.build(path)
    sync(dev)
    build_s = time.perf_counter() - t0
    chunks, merges = idx.timer.count("insert"), idx.timer.count("merge")
    t0 = time.perf_counter()
    counts = idx.count(queries)
    count_s = time.perf_counter() - t0
    if not np.array_equal(counts, want_counts):
        raise AssertionError(
            f"P7: {int((counts != want_counts).sum())} of {counts.size} "
            "counts differ from the numpy reference")
    if not (counts[:n_read_q] >= 1).all():
        raise AssertionError("P7: a sampled read window counted 0")
    rows, cnts = idx.items()
    if int(cnts.sum()) != n_windows or rows.shape[0] != idx.size():
        raise AssertionError(f"P7 items: sum {int(cnts.sum())} != "
                             f"{n_windows} windows")
    peak = peak_bytes(dev)
    log(f"P7 CountIndex k={K_WIDE}, 1 shard: build {build_s:.3f} s = "
        f"{n_windows / build_s:.0f} k-mers/s, {chunks} chunks, {merges} "
        f"merges; count of {n_queries}: {count_s:.3f} s = "
        f"{n_queries / count_s:.0f} q/s == numpy counts; items: "
        f"{rows.shape[0]} distinct, count sum == {n_windows} windows; peak "
        f"device memory {peak} bytes [{smi}]")
    log("P7 CountIndex phases:\n" + idx.timer.report("P7"))
    del idx, rows, cnts
    if dev.type == "cuda":
        torch.cuda.empty_cache()

    # the sampled finds: every window whose canonical key is a sampled
    # read-window query's, its id and quality
    sample = rng.choice(n_read_q, n_sample, replace=False)
    first, cnt = ref.span(qlimbs[sample])
    wq_all = window_quality(quals, K_WIDE).reshape(-1)
    del limbs
    pq = PositionQualityIndex(spec, canonical=True, device=dev)
    sync(dev)
    if dev.type == "cuda":
        torch.cuda.reset_peak_memory_stats(dev)
    t0 = time.perf_counter()
    pq.build(path)
    sync(dev)
    pq_build_s = time.perf_counter() - t0
    pq_chunks = pq.timer.count("insert")
    size = pq.size()
    flushes = pq.timer.count("merge")
    if size != n_windows:
        raise AssertionError(f"P7: size {size} != {n_windows} windows")
    t0 = time.perf_counter()
    f_ids, f_q, f_mask = pq.find(queries[sample], with_quality=True)
    find_s = time.perf_counter() - t0
    worst, pairs = 0.0, 0
    for i in range(n_sample):
        widx = ref.order[first[i]:first[i] + cnt[i]]
        want_ids = short_ids(np.stack(np.divmod(widx, nwin), 1))
        want_q = wq_all[widx]
        o = np.argsort(want_ids)
        want_ids, want_q = want_ids[o], want_q[o]
        got_ids, got_q = f_ids[i][f_mask[i]], f_q[i][f_mask[i]]
        g = np.argsort(got_ids)
        got_ids, got_q = got_ids[g], got_q[g].astype(np.float64)
        if not np.array_equal(got_ids, want_ids):
            raise AssertionError(f"P7: find of sampled query {i}: ids != "
                                 "the numpy window ids")
        if not (np.array_equal(got_q == 0, want_q == 0) and np.allclose(
                got_q, want_q, rtol=1e-4, atol=0)):
            raise AssertionError(f"P7: find of sampled query {i}: "
                                 "qualities off by more than rtol 1e-4")
        live = want_q > 0
        if live.any():
            worst = max(worst, float(np.max(
                np.abs(got_q[live] - want_q[live]) / want_q[live])))
        pairs += want_ids.size
    p7 = dict(kernels.LAUNCHES)
    k1 = dict(kernels.K1_LAUNCHES)
    peak = peak_bytes(dev)
    log(f"P7 PositionQualityIndex k={K_WIDE}, canonical, 1 shard: build "
        f"{pq_build_s:.3f} s = {n_windows / pq_build_s:.0f} k-mers/s, "
        f"{pq_chunks} chunks, {flushes} flushes, size {size} == windows; "
        f"find(with_quality) of {n_sample} sampled queries {find_s:.3f} s "
        f"= {n_sample / find_s:.0f} q/s == numpy id sets ({pairs} pairs), "
        f"qualities max rel err {worst:.3e} (rtol 1e-4); peak device memory "
        f"{peak} bytes [{smi}]")
    log("P7 PositionQualityIndex phases:\n" + pq.timer.report("P7"))
    log(f"P7 launches: {p7}")
    log(f"P7 K1 launches by kernel: {k1}")
    if not p7["extract_canonical"] == k1["wide"] == chunks + pq_chunks:
        raise AssertionError(f"P7: K1 launches {p7['extract_canonical']} "
                             f"(wide {k1['wide']}) != {chunks + pq_chunks} "
                             "chunks")
    if p7["merge_runs_cols"] < merges + flushes or not merges or not flushes:
        raise AssertionError(f"P7: K2 launches < {merges} merges + "
                             f"{flushes} flushes")
    return p7


def phase_p8(dev, path, tmp, qcodes, queries, keys, cnts, want_counts,
             smi, n_pairs: int = 1_000_000, max_count: int = 255,
             saturate: int = 20) -> dict:
    """P8: the index surface at P4's size (the module docstring), each step
    timed and held exactly against a numpy model of the contents (sorted
    canonical codes and their counts).  Returns the kernel launches of its
    run, with K2's by payload count under "K2 payloads"; raises on any
    difference from numpy."""
    import torch
    from kmerind_tpu_torch import DNA, CountIndex, KmerSpec
    from kmerind_tpu_torch.ops import kernels
    from kmerind_tpu_torch.utils.checkpoint import load_index, save_index
    spec = KmerSpec(K, DNA)
    rng = np.random.default_rng(8)
    times = {}

    def timed(name, fn):
        t0 = time.perf_counter()
        out = fn()
        sync(dev)
        times[name] = time.perf_counter() - t0
        return out

    def lookup(keys, cnts, q):
        """Counts of the canonical codes q in the model (0 if absent)."""
        pos = np.searchsorted(keys, q).clip(max=max(keys.size - 1, 0))
        return np.where(keys[pos] == q, cnts[pos], 0)

    def check(cond, what):
        if not cond:
            raise AssertionError(f"P8: {what}")

    # the model: P4's distinct canonical 21-mers (keys) and counts (cnts)
    n_windows = int(cnts.sum())
    want_spec = spectrum(cnts, max_count)
    half = n_pairs // 2
    rand = rng.integers(0, 4, (n_pairs - half, K), dtype=np.uint8)
    add_keys = np.concatenate([rng.choice(keys, half, replace=False),
                               window_codes(rand)[:, 0]])
    add_rows = np.concatenate([code_rows(add_keys[:half]), pack_rows(rand)])
    add_cnts = rng.integers(1, 1001, n_pairs)
    rand = rng.integers(0, 4, (n_pairs - half, K), dtype=np.uint8)
    erase_keys = np.concatenate([rng.choice(keys, half),
                                 window_codes(rand)[:, 0]])
    erase_rows = np.concatenate([code_rows(erase_keys[:half]),
                                 pack_rows(rand)])
    qcanon = window_codes(qcodes)[:, 0]
    del rand

    sync(dev)
    if dev.type == "cuda":
        torch.cuda.reset_peak_memory_stats(dev)
    kernels.reset_launches()
    idx = CountIndex(spec, device=dev)
    timed("build", lambda: idx.build(path))
    hist = timed("histogram", lambda: idx.histogram(max_count))
    check(np.array_equal(hist, want_spec), "histogram != numpy spectrum")

    # (kmer, count) pairs: weighted runs adopted with the K3 prefix sum
    timed("insert_counts", lambda: idx.insert_counts(add_rows, add_cnts))
    keys, cnts = add_counts(keys, cnts, add_keys, add_cnts)
    got = timed("count", lambda: idx.count(queries))
    check(np.array_equal(got, lookup(keys, cnts, qcanon)),
          "counts after insert_counts != numpy counts + added counts")
    check(np.array_equal(idx.count(add_rows), lookup(
        keys, cnts, add_keys)), "counts of the inserted pairs")

    # erase: distinct present keys, over the adopted runs and the build's
    erased = timed("erase", lambda: idx.erase(erase_rows))
    pos = np.searchsorted(keys, erase_keys).clip(max=keys.size - 1)
    gone = np.unique(pos[keys[pos] == erase_keys])
    check(erased == gone.size, f"erase returned {erased}, numpy "
          f"{gone.size} distinct present keys")
    check(not idx.count(erase_rows).any(), "an erased key still counts")
    keep = np.ones(keys.size, bool)
    keep[gone] = False
    keys, cnts = keys[keep], cnts[keep]
    size = timed("size", idx.size)
    _, item_cnts = idx.items()
    check(size == keys.size and int(item_cnts.sum()) == int(cnts.sum()),
          f"size {size} / count sum {int(item_cnts.sum())} != numpy "
          f"{keys.size} / {int(cnts.sum())}")

    # drop the singletons
    singles = int((cnts == 1).sum())
    dropped = timed("filter", lambda: idx.filter(lambda k, c: c >= 2))
    keys, cnts = keys[cnts >= 2], cnts[cnts >= 2]
    hist = idx.histogram(max_count)
    check(dropped == singles and hist[1] == 0
          and np.array_equal(hist, spectrum(cnts, max_count)),
          f"filter dropped {dropped}, numpy {singles} singletons")

    # count_if at the lowest threshold selecting at most n_pairs keys
    t = int(np.sort(cnts)[-n_pairs]) + 1 if cnts.size >= n_pairs else 0
    sel = timed("count_if", lambda: idx.count_if(lambda k, c: c >= t))
    pick = cnts >= t
    check(sorted(sel) == list(zip(keys[pick].tolist(), cnts[pick].tolist())),
          f"count_if(c >= {t}) != numpy's {int(pick.sum())} entries")

    # persistence: npz (the JAX package's format) and the sharded checkpoint
    want = lookup(keys, cnts, qcanon)
    timed("save", lambda: idx.save(tmp / "p8.npz"))
    back = timed("load", lambda: CountIndex.load(tmp / "p8.npz", dev))
    check(np.array_equal(back.count(queries), want), "npz reload's counts")
    del back
    timed("save_index", lambda: save_index(idx, tmp / "p8_ckpt"))
    back = timed("load_index", lambda: load_index(tmp / "p8_ckpt", dev))
    check(np.array_equal(back.count(queries), want)
          and np.array_equal(idx.count(queries), want),
          "checkpoint reload's counts")
    del back, idx
    if dev.type == "cuda":
        torch.cuda.empty_cache()

    # a saturating map over the same FASTQ: every reader clamps
    sat = CountIndex(spec, device=dev, saturate=saturate)
    timed("build saturate", lambda: sat.build(path))
    got = sat.count(queries)
    clamped = want_spec.copy()
    clamped[saturate] = clamped[saturate:].sum()
    clamped[saturate + 1:] = 0
    check(np.array_equal(got, np.minimum(want_counts, saturate))
          and np.array_equal(sat.histogram(max_count), clamped),
          f"saturate={saturate}: counts or spectrum != numpy, clamped")
    launches = dict(kernels.LAUNCHES)
    launches["K2 payloads"] = dict(kernels.K2_PAYLOAD_LAUNCHES)
    peak = peak_bytes(dev)
    del sat
    log(f"P8 CountIndex surface, 1 shard: build {times['build']:.3f} s = "
        f"{n_windows / times['build']:.0f} k-mers/s; histogram({max_count}) "
        f"{times['histogram']:.3f} s == numpy spectrum; insert_counts of "
        f"{n_pairs} pairs {times['insert_counts']:.3f} s; count of "
        f"{queries.shape[0]} {times['count']:.3f} s == numpy + added; erase "
        f"of {n_pairs} keys {times['erase']:.3f} s ({erased} distinct "
        f"present); size {times['size']:.3f} s ({size}); filter(c >= 2) "
        f"{times['filter']:.3f} s ({dropped} singletons); count_if(c >= {t})"
        f" {times['count_if']:.3f} s ({len(sel)} entries); npz save "
        f"{times['save']:.3f} s, load {times['load']:.3f} s; save_index "
        f"{times['save_index']:.3f} s, load_index {times['load_index']:.3f}"
        f" s; saturate={saturate} build {times['build saturate']:.3f} s, "
        f"counts and spectrum == numpy clamped; peak device memory {peak} "
        f"bytes [{smi}]")
    log(f"P8 launches: {launches}")
    check(launches["merge_runs_cols"] and launches["prefix_sum_i32"],
          f"K2 and K3 must both run: {launches}")
    check(launches["K2 payloads"].get(1, 0) > 0,
          f"K2 never merged with the weights as its payload: {launches}")
    return launches


DNA16_NIBBLE = np.array([1, 2, 4, 8, 15], np.uint8)   # A C G T N


def rev4(x: np.ndarray) -> np.ndarray:
    """4-bit reversal of DNA16 nibbles (their complement)."""
    return ((x & 1) << 3) | ((x & 2) << 1) | ((x & 4) >> 1) | ((x & 8) >> 3)


def graph_windows(codes: np.ndarray, k: int = K) -> np.ndarray:
    """uint64[n_reads * (READ_LEN - k + 1)] canonical 2-bit code << 8 |
    edge byte of every k-window of the reads, in window order, by the
    de Bruijn graph's dual-LUT rule: the k-mer reads N as A, the edge
    nibbles are the neighbours' DNA16 codes (A 1, C 2, G 4, T 8, N 0xF; 0
    past the read's ends), the left one in the high half; where the
    reverse complement is the smaller strand, the halves swap and each is
    4-bit reversed.  Blocks of 100,000 reads keep the temporaries small."""
    nwin = codes.shape[1] - k + 1
    out = np.empty(codes.shape[0] * nwin, np.uint64)
    two = np.uint64(2)
    for lo in range(0, codes.shape[0], 100_000):
        raw = codes[lo:lo + 100_000]
        c = raw.astype(np.uint64)
        c[c == 4] = 0
        fwd = np.zeros((c.shape[0], nwin), np.uint64)
        rc = np.zeros_like(fwd)
        for j in range(k):
            fwd = (fwd << two) | c[:, j:j + nwin]
        for j in range(k - 1, -1, -1):
            rc = (rc << two) | (np.uint64(3) - c[:, j:j + nwin])
        nib = DNA16_NIBBLE[raw]
        left = np.zeros(fwd.shape, np.uint8)
        right = np.zeros(fwd.shape, np.uint8)
        left[:, 1:] = nib[:, :nwin - 1]
        right[:, :nwin - 1] = nib[:, k:k + nwin - 1]
        flip = rc < fwd
        eb = np.where(flip, (rev4(right) << 4) | rev4(left),
                      (left << 4) | right).astype(np.uint64)
        out[lo * nwin:(lo + c.shape[0]) * nwin] = (
            (np.minimum(fwd, rc) << np.uint64(8)) | eb).ravel()
    return out


def graph_nodes(windows: np.ndarray):
    """(sorted distinct canonical codes, int64 [nodes, 9] counters) of the
    `graph_windows` output: out A, C, G, T, in A, C, G, T (one per set
    edge bit of each window) and self (the windows)."""
    srt = np.sort(windows)
    keys = srt >> np.uint64(8)
    starts = np.concatenate([[0], np.flatnonzero(keys[1:] != keys[:-1]) + 1])
    cnt = np.empty((starts.size, 9), np.int64)
    for j in range(8):
        bits = ((srt >> np.uint64(j)) & np.uint64(1)).astype(np.uint8)
        cnt[:, j] = np.add.reduceat(bits, starts, dtype=np.int64)
    cnt[:, 8] = np.diff(np.append(starts, srt.size))
    return keys[starts], cnt


def node_lookup(node_keys: np.ndarray, cnt: np.ndarray, q: np.ndarray):
    """([m, 9] counters of the canonical codes q, zeros where absent;
    found bool[m])."""
    pos = np.searchsorted(node_keys, q).clip(max=node_keys.size - 1)
    hit = node_keys[pos] == q
    return np.where(hit[:, None], cnt[pos], 0), hit


def code_string(code: int, k: int = K) -> str:
    """The k-mer string of a 2-bit code (base 0 most significant)."""
    return "".join("ACGT"[(code >> (2 * (k - 1 - i))) & 3] for i in range(k))


def phase_p9(dev, path, tmp, codes, quals, qcodes, queries, smi,
             n_nbr: int = 1000, n_sample: int = 10_000,
             n_more: int = 50_000) -> dict:
    """P9: the de Bruijn graphs over P4's FASTQ (the module docstring),
    checked exactly against a numpy model of every node's 9 counters under
    the dual-LUT rule.  Returns the kernel launches of its runs, with K2's
    by payload count under "K2 payloads"; raises on any difference from
    numpy."""
    import torch
    from kmerind_tpu_torch import (DNA, DeBruijnGraph, KmerSpec,
                                   QualityDeBruijnGraph)
    from kmerind_tpu_torch.ops import kernels
    spec = KmerSpec(K, DNA)
    nwin = READ_LEN - K + 1
    n_windows = codes.shape[0] * nwin
    times, k2p = {}, collections.Counter()

    def check(cond, what):
        if not cond:
            raise AssertionError(f"P9: {what}")

    def timed(name, fn):
        t0 = time.perf_counter()
        out = fn()
        sync(dev)
        times[name] = time.perf_counter() - t0
        return out

    t0 = time.perf_counter()
    windows = graph_windows(codes)
    node_keys, cnt = graph_nodes(windows)
    qcanon = window_codes(qcodes)[:, 0]
    want, want_found = node_lookup(node_keys, cnt, qcanon)
    log(f"P9 numpy reference: {n_windows} windows, {node_keys.size} nodes, "
        f"{time.perf_counter() - t0:.2f} s [{smi}]")
    check(int(cnt[:, 8].sum()) == n_windows, "numpy self counters")

    sync(dev)
    if dev.type == "cuda":
        torch.cuda.reset_peak_memory_stats(dev)
    kernels.reset_launches()
    g = DeBruijnGraph(spec, device=dev, max_runs=8)
    timed("build", lambda: g.build(path))
    chunks, merges = g.timer.count("insert"), g.timer.count("merge")
    got = [timed(f"count{i}", lambda: g.node_counts(queries))
           for i in range(2)]
    for vals, found in got:
        check(np.array_equal(vals, want) and np.array_equal(found,
                                                            want_found),
              f"node_counts of {queries.shape[0]}: "
              f"{int((vals != want).any(1).sum())} differ from numpy")
    tables = g.timer.count("table")
    build = dict(kernels.LAUNCHES)
    k2p.update(kernels.K2_PAYLOAD_LAUNCHES)
    size = timed("size", g.size)
    check(size == node_keys.size, f"size {size} != {node_keys.size} nodes")
    words, vecs = timed("items", g.items)
    order = np.argsort((words[:, 0].astype(np.uint64) << np.uint64(10))
                       | words[:, 1])
    check(np.array_equal(code_rows(node_keys), words[order])
          and np.array_equal(vecs[order], cnt),
          "items() != the numpy nodes and counters")
    check(int(vecs[:, 8].sum()) == n_windows, "self counters != windows")
    del words, vecs, order
    # edge_exists and neighbors of n_nbr present nodes
    pick = np.random.default_rng(9).choice(node_keys.size, n_nbr,
                                           replace=False)
    strs = [code_string(int(c)) for c in node_keys[pick]]
    flags = timed("edge_exists", lambda: g.edge_exists(strs))
    check(np.array_equal(flags, cnt[pick, :8] > 0), "edge_exists")
    t0 = time.perf_counter()
    for s_, c in zip(strs, cnt[pick]):
        outs = [(s_[1:] + "ACGT"[b], int(c[b])) for b in range(4) if c[b]]
        ins = [("ACGT"[b] + s_[:-1], int(c[4 + b])) for b in range(4)
               if c[4 + b]]
        check(g.neighbors(s_) == (ins, outs), f"neighbors of {s_}")
    times["neighbors"] = time.perf_counter() - t0
    # compact, then the same answers; more ingest and a merge with the
    # compacted (weighted) run: K2 with 2 payloads
    timed("compact", g.compact)
    check(np.array_equal(g.node_counts(queries)[0], want),
          "node_counts after compact()")
    kernels.reset_launches()
    timed("save", lambda: g.save(tmp / "p9.npz"))
    back = timed("load", lambda: DeBruijnGraph.load(tmp / "p9.npz", dev))
    check(np.array_equal(back.node_counts(queries)[0], want)
          and back.size() == node_keys.size, "npz reload's answers")
    del back
    # more ingest: the first n_more reads again, as their own FASTQ
    more_path = tmp / "p9_more.fastq"
    write_fastq(codes[:n_more], quals[:n_more], more_path)
    more, _ = node_lookup(*graph_nodes(graph_windows(codes[:n_more])),
                          qcanon)
    timed("ingest", lambda: g.build(more_path))
    timed("merge", g.size)
    check(np.array_equal(g.node_counts(queries)[0], want + more)
          and g.size() == node_keys.size,
          "node_counts after more ingest != numpy")
    again = dict(kernels.LAUNCHES)
    k2p_again = dict(kernels.K2_PAYLOAD_LAUNCHES)
    k2p.update(k2p_again)
    peak = peak_bytes(dev)
    log(f"P9 DeBruijnGraph k={K}, 1 shard, max_runs=8: build "
        f"{times['build']:.3f} s = {n_windows / times['build']:.0f} "
        f"windows/s, {chunks} chunks, {merges} merges; node_counts of "
        f"{queries.shape[0]}: first (tables, aux) {times['count0']:.3f} s, "
        f"second {times['count1']:.3f} s = "
        f"{queries.shape[0] / times['count1']:.0f} q/s == numpy; size "
        f"{times['size']:.3f} s ({size} nodes); items {times['items']:.3f} "
        f"s == numpy, self sum == {n_windows} windows; edge_exists of "
        f"{n_nbr} {times['edge_exists']:.3f} s, {n_nbr} neighbors "
        f"{times['neighbors']:.3f} s == numpy; compact "
        f"{times['compact']:.3f} s; npz save {times['save']:.3f} s, load "
        f"{times['load']:.3f} s; ingest of {n_more} more reads "
        f"{times['ingest']:.3f} s, merge with the compacted run "
        f"{times['merge']:.3f} s, counts == numpy; peak device memory "
        f"{peak} bytes [{smi}]")
    log("P9 DeBruijnGraph phases:\n" + g.timer.report("P9"))
    log(f"P9 launches, build + first queries: {build}; K3 per table: "
        f"{tables} tables; after compact (save, load, more ingest, merge): "
        f"{again}, K2 by payloads {k2p_again}")
    # the launch checks come last, after the quality graph's answers
    launch_checks = [
        (build["extract_canonical"] == chunks,
         f"K1 launches {build['extract_canonical']} != {chunks} chunks"),
        (merges and k2p.get(1, 0) >= merges,
         f"K2 with 1 payload < {merges} unit merges: {dict(k2p)}"),
        (build["prefix_sum_i32"] >= 8 * tables > 0,
         f"K3 launches {build['prefix_sum_i32']} < 8 x {tables} tables"),
        (k2p_again.get(2, 0) > 0,
         f"K2 never merged with (edge byte, weight) payloads: {k2p_again}")]
    del g
    if dev.type == "cuda":
        torch.cuda.empty_cache()

    # the quality graph: counters exact, node_quality of n_sample nodes
    # against float64 numpy window qualities
    sample = node_keys[np.random.default_rng(10).choice(
        node_keys.size, n_sample, replace=False)]
    uq = np.sort(sample)
    canon = windows >> np.uint64(8)
    del windows
    pos = np.searchsorted(uq, canon).clip(max=uq.size - 1)
    hit = uq[pos] == canon
    del canon
    wq = window_quality(quals).reshape(-1)
    q_sum = np.bincount(pos[hit], weights=wq[hit], minlength=uq.size)
    q_n = np.bincount(pos[hit], minlength=uq.size)
    del pos, hit, wq
    kernels.reset_launches()
    if dev.type == "cuda":
        torch.cuda.reset_peak_memory_stats(dev)
    qg = QualityDeBruijnGraph(spec, device=dev, max_runs=8)
    timed("qbuild", lambda: qg.build(path))
    qchunks = qg.timer.count("insert")
    vals, _ = timed("qcount", lambda: qg.node_counts(queries))
    check(np.array_equal(vals, want), "quality graph node_counts")
    ustr = [code_string(int(c)) for c in uq]
    mean, n, found = timed("qmean", lambda: qg.node_quality(ustr))
    want_mean = q_sum / q_n
    check(found.all() and np.array_equal(n, q_n), "node_quality windows")
    check(np.allclose(mean, want_mean, rtol=1e-5, atol=0),
          "node_quality off by more than rtol 1e-5")
    live = want_mean > 0
    worst = float(np.max(np.abs(mean[live] - want_mean[live])
                         / want_mean[live]))
    ql = dict(kernels.LAUNCHES)
    qk2 = dict(kernels.K2_PAYLOAD_LAUNCHES)
    k2p.update(qk2)
    qpeak = peak_bytes(dev)
    log(f"P9 QualityDeBruijnGraph, 1 shard: build {times['qbuild']:.3f} s "
        f"= {n_windows / times['qbuild']:.0f} windows/s, {qchunks} chunks, "
        f"{qg.timer.count('merge')} merges; node_counts of "
        f"{queries.shape[0]} {times['qcount']:.3f} s == numpy; node_quality "
        f"of {n_sample} nodes {times['qmean']:.3f} s, max rel err "
        f"{worst:.3e} (rtol 1e-5); peak device memory {qpeak} bytes; "
        f"launches {ql}, K2 by payloads {qk2} [{smi}]")
    log("P9 QualityDeBruijnGraph phases:\n" + qg.timer.report("P9q"))
    del qg
    launch_checks += [
        (ql["extract_canonical"] == qchunks, "quality graph: K1 launches"),
        (qk2.get(2, 0) > 0, "quality graph: K2 never ran on its unit "
         "merges (edge byte, quality bits)")]
    for cond, what in launch_checks:
        check(cond, what)
    launches = {kn: build[kn] + again[kn] + ql[kn] for kn in build}
    launches["K2 payloads"] = dict(k2p)
    return launches


# ------------------------------------------------- P10: Bimolecule, values
def revcomp_codes(c: np.ndarray, k: int = K) -> np.ndarray:
    """uint64 2-bit codes of the reverse complements of k-mer codes c."""
    c = np.asarray(c, np.uint64).copy()
    out = np.zeros_like(c)
    for _ in range(k):
        out = (out << np.uint64(2)) | (np.uint64(3) - (c & np.uint64(3)))
        c >>= np.uint64(2)
    return out


def occurrences(canon: np.ndarray):
    """(distinct keys ascending, int64 counts, first index, last index) of
    a 1-d array of canonical codes in file order.  Each code and its index
    pack into one uint64 — the code's low bits above the index's — which
    plain sorts order by (code, index): a stable bucketing by the code's
    top bits first (a radix argsort of small ints), then one sort per
    bucket, much faster than a stable argsort of the codes."""
    canon = np.ascontiguousarray(canon, np.uint64)
    n = canon.size
    ib = max(1, (n - 1).bit_length())
    kb = np.uint64(64 - ib)
    top = (canon >> kb).astype(np.int64)
    if top.max(initial=0) >= 1 << 16:
        raise ValueError("codes too wide for occurrences()")
    order = np.argsort(top.astype(np.uint16), kind="stable")
    packed = (((canon & ((np.uint64(1) << kb) - np.uint64(1)))
               << np.uint64(ib)) | np.arange(n, dtype=np.uint64))[order]
    top = top[order]
    del order
    edges = np.concatenate([[0], np.flatnonzero(top[1:] != top[:-1]) + 1,
                            [n]])
    for a, b in zip(edges[:-1], edges[1:]):
        packed[a:b].sort()
    keys = (top.astype(np.uint64) << kb) | (packed >> np.uint64(ib))
    idx = (packed & np.uint64((1 << ib) - 1)).astype(np.int64)
    heads = np.flatnonzero(keys[1:] != keys[:-1]) + 1
    starts = np.concatenate([[0], heads])
    ends = np.concatenate([heads - 1, [n - 1]])
    return keys[starts], np.diff(np.append(starts, n)), idx[starts], \
        idx[ends]


def window_ids(idx: np.ndarray) -> np.ndarray:
    """uint64 short position ids of the windows with file-order index idx
    (read * (READ_LEN - K + 1) + offset) of a `write_fastq` file."""
    nwin = READ_LEN - K + 1
    return short_ids(np.stack(np.divmod(idx, nwin), axis=1))


def p10_model(codes: np.ndarray, canon: np.ndarray | None = None):
    """The numpy reference of P10 over the reads `codes` (N read as A):
    (distinct canonical 21-mer codes ascending, their counts, their STORED
    orientation — the input strand of the first window holding the key, in
    file order (the Bimolecule preset) —, the short id of that first window
    and of the last one (the value maps' min / max)).  canon: the reads'
    `window_codes`, if already computed."""
    nwin = codes.shape[1] - K + 1
    if canon is None:
        canon = window_codes(codes)
    keys, cnts, first, last = occurrences(canon.reshape(-1))
    r, o = np.divmod(first, nwin)
    stored = window_codes(codes[r[:, None], o[:, None] + np.arange(K)],
                          canonical=False)[:, 0]
    return keys, cnts, stored, window_ids(first), window_ids(last)


def phase_p10(dev, path, tmp, codes, qcodes, queries, want_counts, smi,
              n_find: int = 10_000, n_insert: int = 1000,
              n_erase: int = 1_000_000, n_read_q: int = 900_000,
              canon: np.ndarray | None = None) -> dict:
    """P10: BimoleculeCountIndex and both value maps over P4's FASTQ on one
    shard (the module docstring), every answer held exactly against
    `p10_model` (canon: the reads' `window_codes`, if held); the first
    n_read_q queries are read windows.  Returns
    the kernel launches of its runs, with K2's by payload count under "K2
    payloads"; raises on any difference from numpy."""
    import torch
    from kmerind_tpu_torch import (DNA, BimoleculeCountIndex, KmerSpec,
                                   KmerValueIndex, SortedKmerValueIndex)
    from kmerind_tpu_torch.ops import kernels
    spec = KmerSpec(K, DNA)
    rng = np.random.default_rng(10)
    n_windows = codes.shape[0] * (READ_LEN - K + 1)
    times, launches = {}, collections.Counter()
    k2p = collections.Counter()

    def check(cond, what):
        if not cond:
            raise AssertionError(f"P10: {what}")

    def timed(name, fn):
        t0 = time.perf_counter()
        out = fn()
        sync(dev)
        times[name] = time.perf_counter() - t0
        return out

    def at(keys, q):
        """(position of each code q among the sorted keys, present)."""
        pos = np.searchsorted(keys, q).clip(max=max(keys.size - 1, 0))
        return pos, keys[pos] == q

    def codes_of(rows):
        return (rows[:, 0].astype(np.uint64) << np.uint64(10)) | rows[:, 1]

    def take_launches():
        launches.update(kernels.LAUNCHES)
        k2p.update(kernels.K2_PAYLOAD_LAUNCHES)
        return dict(kernels.LAUNCHES), dict(kernels.K2_PAYLOAD_LAUNCHES)

    t0 = time.perf_counter()
    keys, cnts, stored, id_first, id_last = p10_model(codes, canon)
    vkeys = keys                     # the value maps' model keeps them
    qcanon = window_codes(qcodes)[:, 0]
    qpos, qhit = at(keys, qcanon)
    check(np.array_equal(np.where(qhit, cnts[qpos], 0), want_counts),
          "the model's counts != P4's numpy counts")
    log(f"P10 numpy reference: {keys.size} keys, first / last occurrences "
        f"{time.perf_counter() - t0:.2f} s [{smi}]")

    # ---------------------------------------------- BimoleculeCountIndex
    sync(dev)
    if dev.type == "cuda":
        torch.cuda.reset_peak_memory_stats(dev)
    kernels.reset_launches()
    idx = BimoleculeCountIndex(spec, device=dev)
    timed("build", lambda: idx.build(path))
    size = timed("size", idx.size)
    chunks, merges = idx.timer.count("insert"), idx.timer.count("merge")
    check(size == keys.size, f"size {size} != {keys.size} distinct")
    rc_queries = pack_rows(3 - qcodes[:, ::-1])
    for name, q in (("count", queries), ("count again", queries),
                    ("count rc", rc_queries)):
        got = timed(name, lambda: idx.count(q))
        check(np.array_equal(got, want_counts),
              f"{name}: {int((got != want_counts).sum())} of {got.size} "
              "counts differ from numpy")
    rows, got_cnts = timed("items", idx.items)
    got_codes = codes_of(rows)
    check(np.array_equal(np.minimum(got_codes, revcomp_codes(got_codes)),
                         keys) and np.array_equal(got_codes, stored)
          and np.array_equal(got_cnts, cnts),
          "items() != the first-occurrence model")
    check(int(got_cnts.sum()) == n_windows, "item counts != windows")
    del rows, got_cnts, got_codes
    # find: sampled read windows, half given reverse-complemented
    pick = rng.choice(n_read_q, n_find, replace=False)
    fcodes = qcodes[pick].copy()
    fcodes[::2] = 3 - fcodes[::2, ::-1]
    words, fcnts = timed("find", lambda: idx.find(pack_rows(fcodes)))
    fpos = qpos[pick]
    check(np.array_equal(codes_of(words), stored[fpos])
          and np.array_equal(fcnts, cnts[fpos]),
          "find != the stored orientations and counts")
    # insert present keys in their other orientation: kept, counts + 1
    ins = rng.choice(keys.size, n_insert, replace=False)
    other = code_rows(revcomp_codes(stored[ins]))
    timed("insert", lambda: idx.insert(other))
    cnts[ins] += 1
    words, fcnts = idx.find(other)
    check(np.array_equal(codes_of(words), stored[ins])
          and np.array_equal(fcnts, cnts[ins]),
          "insert of the other orientation changed a stored orientation")
    # erase n_erase keys, half present
    half = n_erase // 2
    rand = rng.integers(0, 4, (n_erase - half, K), dtype=np.uint8)
    erase_keys = np.concatenate([rng.choice(keys, half),
                                 window_codes(rand)[:, 0]])
    erase_rows = np.concatenate([code_rows(erase_keys[:half]),
                                 pack_rows(rand)])
    erased = timed("erase", lambda: idx.erase(erase_rows))
    epos, ehit = at(keys, erase_keys)
    gone = np.unique(epos[ehit])
    check(erased == gone.size, f"erase returned {erased}, numpy "
          f"{gone.size} distinct present keys")
    keep = np.ones(keys.size, bool)
    keep[gone] = False
    keys, cnts, stored = keys[keep], cnts[keep], stored[keep]
    size = timed("size after erase", idx.size)
    check(size == keys.size, f"size after erase {size} != {keys.size}")
    qpos, qhit = at(keys, qcanon)
    want_after = np.where(qhit, cnts[qpos], 0)

    def same_answers(ix, what):
        rows, c = ix.items()
        check(np.array_equal(codes_of(rows), stored)
              and np.array_equal(c, cnts)
              and np.array_equal(ix.count(queries), want_after)
              and np.array_equal(ix.count(rc_queries), want_after),
              f"{what}: items or counts != the model")

    timed("compact", idx.compact)
    same_answers(idx, "compact()")
    timed("save", lambda: idx.save(tmp / "p10.npz"))
    back = timed("load", lambda: BimoleculeCountIndex.load(tmp / "p10.npz",
                                                           dev))
    same_answers(back, "npz save / load")
    del back
    bl, bk2 = take_launches()
    peak = peak_bytes(dev)
    del idx
    if dev.type == "cuda":
        torch.cuda.empty_cache()
    log(f"P10 BimoleculeCountIndex, 1 shard: build {times['build']:.3f} s = "
        f"{n_windows / times['build']:.0f} k-mers/s, {chunks} chunks, first "
        f"size() {times['size']:.3f} s ({merges} merges in all), "
        f"{keys.size + gone.size} keys == numpy; count of {queries.shape[0]}"
        f" {times['count']:.3f} s = {queries.shape[0] / times['count']:.0f} "
        f"q/s, again {times['count again']:.3f} s = "
        f"{queries.shape[0] / times['count again']:.0f} q/s, reverse-"
        f"complemented {times['count rc']:.3f} s; items {times['items']:.3f}"
        f" s, every stored orientation == the first occurrence; find of "
        f"{n_find} {times['find']:.3f} s; insert of {n_insert} in the other "
        f"orientation {times['insert']:.3f} s, orientation kept; erase of "
        f"{n_erase} {times['erase']:.3f} s ({erased} present); compact "
        f"{times['compact']:.3f} s; npz save {times['save']:.3f} s, load "
        f"{times['load']:.3f} s; peak device memory {peak} bytes; "
        f"launches {bl}, K2 by payloads {bk2} [{smi}]")
    check(bl["extract_canonical"] == chunks,
          f"Bimolecule K1 launches {bl['extract_canonical']} != {chunks}")
    check(merges and bk2.get(4, 0) >= merges,
          f"Bimolecule K2 with 4 payloads {bk2} < {merges} merges")
    check(bl["prefix_sum_i32"] > 0, "Bimolecule K3 never ran")
    del keys, cnts, stored

    # ------------------------------------------------------ value maps
    for cls, reduce in ((KmerValueIndex, "min"),
                        (SortedKmerValueIndex, "max")):
        name = f"{cls.__name__}({reduce})"
        vals = id_first if reduce == "min" else id_last
        sync(dev)
        if dev.type == "cuda":
            torch.cuda.reset_peak_memory_stats(dev)
        kernels.reset_launches()
        ix = cls(spec, device=dev, reduce=reduce)
        timed(name, lambda: ix.build(path))
        vsize = timed(name + " size", ix.size)
        vchunks = ix.timer.count("insert")
        check(vsize == vkeys.size, f"{name}: size {vsize} != {vkeys.size}")
        got = [timed(f"{name} find{i}", lambda: ix.find(queries))
               for i in range(2)]
        vpos, vhit = at(vkeys, qcanon)
        for g_vals, g_found in got:
            check(np.array_equal(g_found, vhit)
                  and np.array_equal(g_vals[vhit], vals[vpos[vhit]])
                  and not g_vals[~vhit].any(),
                  f"{name}: find of {queries.shape[0]} != numpy")
        # erase the entries whose position id lies in the first tenth of
        # the reads
        thr = ((codes.shape[0] // 10) * RECORD_BYTES) >> 16
        n_gone = timed(name + " erase_if", lambda: ix.erase_if(
            lambda k, h, lo: h < thr))
        kept = (vals >> np.uint64(32)) >= np.uint64(thr)
        check(n_gone == int((~kept).sum()), f"{name}: erase_if erased "
              f"{n_gone}, numpy {int((~kept).sum())}")
        left = ix.find(queries)
        check(np.array_equal(left[1], vhit & kept[vpos]),
              f"{name}: find after erase_if != numpy")
        timed(name + " save", lambda: ix.save(tmp / "p10v.npz"))
        back = timed(name + " load", lambda: cls.load(tmp / "p10v.npz", dev))
        again = back.find(queries)
        check(np.array_equal(again[0], left[0])
              and np.array_equal(again[1], left[1]),
              f"{name}: npz save / load answers differently")
        vl, vk2 = take_launches()
        vpeak = peak_bytes(dev)
        del ix, back
        if dev.type == "cuda":
            torch.cuda.empty_cache()
        log(f"P10 {name}, 1 shard: build {times[name]:.3f} s = "
            f"{n_windows / times[name]:.0f} k-mers/s, {vchunks} chunks, "
            f"size() {times[name + ' size']:.3f} s ({vsize} keys == numpy); "
            f"find of {queries.shape[0]} {times[name + ' find0']:.3f} s = "
            f"{queries.shape[0] / times[name + ' find0']:.0f} q/s, again "
            f"{times[name + ' find1']:.3f} s = "
            f"{queries.shape[0] / times[name + ' find1']:.0f} q/s, values == "
            f"numpy {reduce} ids; erase_if {times[name + ' erase_if']:.3f} s "
            f"({n_gone}); npz save {times[name + ' save']:.3f} s, load "
            f"{times[name + ' load']:.3f} s; peak device memory {vpeak} "
            f"bytes; launches {vl} [{smi}]")
        check(vl["extract_canonical"] == vchunks,
              f"{name}: K1 launches {vl['extract_canonical']} != {vchunks}")
    out = dict(launches)
    out["K2 payloads"] = dict(k2p)
    return out


def phase_p10p(dev, path, codes, smi) -> None:
    """P10 over 4 shards at P3's size: BimoleculeCountIndex's to_dict()
    equals the first-occurrence model, KmerValueIndex("min")'s and
    SortedKmerValueIndex("max")'s the numpy min / max position id of every
    canonical key; raises on any difference."""
    from kmerind_tpu_torch import (DNA, BimoleculeCountIndex, KmerSpec,
                                   KmerValueIndex, SortedKmerValueIndex)
    spec = KmerSpec(K, DNA)
    t0 = time.perf_counter()
    keys, cnts, stored, id_first, id_last = p10_model(codes)
    idx = BimoleculeCountIndex(spec, device=dev, nparts=4)
    idx.build(path)
    if idx.to_dict() != dict(zip(stored.tolist(), cnts.tolist())):
        raise AssertionError("P10 4 shards: Bimolecule to_dict != the "
                             "first-occurrence model")
    del idx
    for cls, reduce, vals in ((KmerValueIndex, "min", id_first),
                              (SortedKmerValueIndex, "max", id_last)):
        ix = cls(spec, device=dev, nparts=4, reduce=reduce)
        ix.build(path)
        if ix.to_dict() != dict(zip(keys.tolist(), vals.tolist())):
            raise AssertionError(f"P10 4 shards: {cls.__name__}({reduce}) "
                                 "to_dict != numpy")
    log(f"P10 4 shards, {codes.size} bases: BimoleculeCountIndex to_dict "
        f"== first-occurrence model ({keys.size} keys), KmerValueIndex(min)"
        f" and SortedKmerValueIndex(max) to_dict == numpy ids; seconds "
        f"{time.perf_counter() - t0:.2f} [{smi}]")


# ------------------------------------------------ P11: several ranks
P11_RANKS = 2


def p11_rank(tmp: str, path4: str, path3: str, n3: str, devices: str,
             smi: str):
    """One rank of P11 (launched by `phase_p11`): the indexes over all
    ranks, each rank holding one of 2 shards on its device (`devices`:
    the comma-separated device of each rank), built from its own byte
    blocks of P4's and P3's FASTQ (P3's: `make_reads(1_000_000, n3,
    seed=1)`).  Every rank checks the answers, which
    come back whole on every rank; each writes its walls and kernel
    launches to tmp/p11_rank<r>.json.  Raises on any difference."""
    import torch
    from kmerind_tpu_torch import (DNA, BimoleculeCountIndex, CountIndex,
                                   DeBruijnGraph, KmerSpec, KmerValueIndex,
                                   PositionIndex, SortedCountIndex)
    from kmerind_tpu_torch.bench import cli, micro
    from kmerind_tpu_torch.index import store as st
    from kmerind_tpu_torch.ops import kernels
    from kmerind_tpu_torch.ops.keys import to_numpy_u32
    from kmerind_tpu_torch.parallel.multihost import global_mesh
    rank = torch.distributed.get_rank()
    mesh = global_mesh(P11_RANKS, devices.split(",")[rank])
    dev, spec, tmp = mesh.device, KmerSpec(K, DNA), pathlib.Path(tmp)
    ref = np.load(tmp / "p11_ref.npz")
    queries, want, (distinct, n_windows) = (ref["queries"], ref["want"],
                                            ref["scalars"].tolist())
    out = {"rank": rank, "device": str(dev), "backend": mesh.backend,
           "walls": {}, "launches": {}}

    def check(cond, what):
        if not cond:
            raise AssertionError(f"P11 rank {rank}: {what}")

    def run(name, build, path):
        """Build one index over the ranks, counters zeroed just before."""
        sync(dev)
        kernels.reset_launches()
        t0 = time.perf_counter()
        idx = build().build(path)
        sync(dev)
        out["walls"][name] = time.perf_counter() - t0
        return idx

    # P4's FASTQ through CountIndex over the ranks (the lockstep stream)
    idx = run("count", lambda: CountIndex(spec, mesh=mesh), path4)
    chunks = idx.timer.count("insert")
    t0 = time.perf_counter()
    check(np.array_equal(idx.count(queries), want),
          "CountIndex counts != P4's numpy counts")
    out["walls"]["count_1M"] = time.perf_counter() - t0
    idx.compact()
    check(idx.size() == distinct, f"size {idx.size()} != {distinct}")
    t0 = time.perf_counter()
    rows, cnts = idx.items()
    out["walls"]["items"] = time.perf_counter() - t0
    check(int(cnts.sum()) == n_windows, "items() counts != the windows")
    lo, _ = mesh.shard_range
    for s in range(mesh.p_local):
        keys = to_numpy_u32(st.run_select(idx.runs[0].shard(s))[0])
        check((murmur3_x86_32(keys) >> np.uint32(31) == lo + s).all(),
              f"a key of shard {lo + s} lies off its numpy murmur3 owner")
    out["launches"]["count"] = dict(kernels.LAUNCHES)
    out["chunks"] = chunks
    out["local_sizes"] = idx.local_sizes()
    del idx, rows, cnts

    sidx = run("sorted", lambda: SortedCountIndex(spec, mesh=mesh), path4)
    t0 = time.perf_counter()
    check(sidx.size() == distinct, "SortedCountIndex size")
    out["walls"]["sorted_flush"] = time.perf_counter() - t0
    check(np.array_equal(sidx.count(queries), want),
          "SortedCountIndex counts != P4's numpy counts")
    out["launches"]["sorted"] = dict(kernels.LAUNCHES)
    del sidx
    torch.cuda.empty_cache()

    # P3's size: the multimap, the value map, the graph, Bimolecule
    codes = make_reads(1_000_000, int(n3), seed=1)
    keys, cnts, stored, id_first, _ = p10_model(codes)
    pidx = run("position", lambda: PositionIndex(spec, mesh=mesh), path3)
    gk, gi, _ = pidx.pairs()
    fwd = window_codes(codes, canonical=False)
    r, o = np.divmod(np.arange(fwd.size), fwd.shape[1])
    order = np.argsort(gi)
    check(np.array_equal(gi[order], short_ids(np.stack([r, o], 1)))
          and np.array_equal(gk[order].astype(np.uint64), fwd.ravel()),
          "PositionIndex pairs != numpy multimap")
    out["launches"]["position"] = dict(kernels.LAUNCHES)
    del pidx, gk, gi, fwd, r, o, order
    kv = run("value_min", lambda: KmerValueIndex(spec, mesh=mesh,
                                                 reduce="min"), path3)
    check(kv.to_dict() == dict(zip(keys.tolist(), id_first.tolist())),
          "KmerValueIndex(min) to_dict != numpy")
    out["launches"]["value_min"] = dict(kernels.LAUNCHES)
    del kv
    g = run("debruijn", lambda: DeBruijnGraph(spec, mesh=mesh), path3)
    node_keys, ncnt = graph_nodes(graph_windows(codes))
    words, vecs = g.items()
    order = np.argsort((words[:, 0].astype(np.uint64) << np.uint64(10))
                       | words[:, 1])
    check(np.array_equal(code_rows(node_keys), words[order])
          and np.array_equal(vecs[order], ncnt),
          "DeBruijnGraph items() != the numpy nodes and counters")
    out["launches"]["debruijn"] = dict(kernels.LAUNCHES)
    del g, words, vecs, order
    bi = run("bimolecule", lambda: BimoleculeCountIndex(spec, mesh=mesh),
             path3)
    check(bi.to_dict() == dict(zip(stored.tolist(), cnts.tolist())),
          "Bimolecule to_dict != the first-occurrence model")
    out["launches"]["bimolecule"] = dict(kernels.LAUNCHES)
    del bi
    torch.cuda.empty_cache()

    # the CLI over the ranks, then micro on each rank's card
    res = cli.main(["-F", path3, "-S", "100", "--json", "--device",
                    str(dev), "--nparts", str(P11_RANKS)])
    check(res["size"] == keys.size and res["count_hits"] > 0
          and res["erased"] > 0, f"CLI results {res}")
    out["cli"] = res
    out["micro"] = micro.main(["--device", str(dev)]) if rank == 0 else []
    for name, need in (("count", ("extract_canonical", "merge_runs_cols",
                                  "prefix_sum_i32")),
                       ("sorted", ("extract_canonical",
                                   "run_length_weights"))):
        for kname in need:
            check(out["launches"][name][kname] > 0,
                  f"{kname} never ran in the {name} build: "
                  f"{out['launches'][name]}")
    (tmp / f"p11_rank{rank}.json").write_text(json.dumps(out))


def phase_p11(tmp, path4, path3, queries, want_counts, distinct: int,
              n_windows: int, smi: str, n3: int = 80_000,
              devices: str | None = None) -> list:
    """P11: `p11_rank` in 2 rank processes — over NCCL, one rank per card,
    with 2 or more cards; else both on cuda:0 over gloo, the exchanges
    staged through host memory (`devices`, e.g. "cpu,cpu" for a rehearsal
    on the CPU, takes gloo on the devices named).  Prints each rank's
    walls and launches; returns each rank's launches of its runs.  A rank
    that fails, or outlives the time limit, fails the phase."""
    import torch
    from kmerind_tpu_torch.parallel.multihost import launch
    ncards = torch.cuda.device_count()
    if devices is None and ncards >= P11_RANKS:
        backend = "nccl"
        devices = ",".join(f"cuda:{r}" for r in range(P11_RANKS))
    else:
        backend = "gloo"
        devices = devices or ",".join(["cuda:0"] * P11_RANKS)
    np.savez(tmp / "p11_ref.npz", queries=queries, want=want_counts,
             scalars=np.array([distinct, n_windows]))
    t0 = time.perf_counter()
    outs = launch("chip_smoke:p11_rank", P11_RANKS,
                  [tmp, path4, path3, n3, devices, smi], backend=backend,
                  timeout_s=600)
    wall = time.perf_counter() - t0
    ranks = [json.loads((tmp / f"p11_rank{r}.json").read_text())
             for r in range(P11_RANKS)]
    for text in outs:
        for line in text.splitlines():
            if line.startswith(("[TIME]", "{")):
                log(f"P11 rank output: {line}")
    for r in ranks:
        walls = ", ".join(f"{k} {v:.3f} s" for k, v in r["walls"].items())
        log(f"P11 rank {r['rank']} on {r['device']} ({r['backend']}"
            f"{', exchanges staged through host memory' if backend == 'gloo' else ''}"
            f", {ncards} card(s) visible): {walls}; {r['chunks']} lockstep "
            f"chunks; shard sizes {r['local_sizes']} [{smi}]")
        for name, ln in r["launches"].items():
            log(f"P11 rank {r['rank']} launches, {name}: {ln}")
        log(f"P11 rank {r['rank']} CLI: {json.dumps(r['cli'])}")
    log(f"P11 {P11_RANKS} ranks, backend {backend}, "
        f"torch.cuda.device_count() {ncards}: every check passed on every "
        f"rank; seconds {wall:.2f} [{smi}]")
    return [r["launches"] for r in ranks]


# ------------------------------------------------ P12: the headline bench
#: P12's runs of the headline bench: bench.py's nine modes at its defaults,
#: and the e2e build at k = 63 (128-bit K1 state) and k = 16 (weighted runs)
P12_RUNS = (("e2e",), ("e2e", "--k", "63"), ("e2e", "--k", "16"),
            ("ingest",), ("count_query",), ("erase",), ("multimap_find",),
            ("debruijn",), ("debruijn_quality",), ("position",),
            ("position_quality",))


def bench_windows(codes: np.ndarray, seg: np.ndarray, k: int = K):
    """(start int64[t], canonical uint64[t], was_rc bool[t]) of every
    in-read window of a flat DNA code stream (k <= 32): base-4 dot products
    of the windows and of their reverse complements, independent of the
    port and of the bench's own numpy baseline."""
    win = np.lib.stride_tricks.sliding_window_view(codes, k).astype(np.uint64)
    pw = np.uint64(4) ** np.arange(k - 1, -1, -1, dtype=np.uint64)
    fwd = win @ pw
    rc = (np.uint64(3) - win) @ pw[::-1]
    start = np.nonzero(seg[: codes.size - k + 1] == seg[k - 1:])[0]
    return start, np.minimum(fwd, rc)[start], (rc < fwd)[start]


def bench_chunks(codes: np.ndarray, chunks: int):
    """The headline bench's chunks of a salt-0 build: chunk i flips the low
    bit of base 0 when i is odd."""
    for i in range(chunks):
        c = codes.copy()
        c[0] ^= i & 1
        yield c


def p12_exact(dev, headline, smi, bases: int = 1 << 20, chunks: int = 3):
    """P12's exact check: e2e, debruijn and position_quality at a reduced
    size, their built state held against numpy — counts per canonical
    k-mer, each node's 9 counters (and each run's counter tables' totals),
    every (k-mer, read, offset) pair with its quality at rtol 1e-5."""
    from kmerind_tpu_torch import DNA, KmerSpec
    from kmerind_tpu_torch.ops.keys import to_numpy_u32
    spec = KmerSpec(K, DNA)
    t0 = time.perf_counter()

    def ctx(mode):
        return headline.Context.create(headline.parse_args(
            ["--mode", mode, "--device", str(dev), "--bases", str(bases),
             "--chunks", str(chunks), "--iters", "1", "--json-only",
             "--pinned-baseline", "1"]))

    def key_ints(kcols, rows):
        return spec.to_ints(to_numpy_u32(kcols).T[rows])

    c = ctx("e2e")
    seg = c.seg_np
    windows = [bench_windows(x, seg) for x in bench_chunks(c.codes_np,
                                                           chunks)]
    want_k, want_c = np.unique(np.concatenate([w[1] for w in windows]),
                               return_counts=True)
    _, stores = headline.e2e(c)
    keys, wts = [], []
    for s in stores:
        live = (s.weights > 0).cpu().numpy()
        keys.append(key_ints(s.keys, live))
        wts.append(s.weights.cpu().numpy()[live])
    got_k, inv = np.unique(np.concatenate(keys), return_inverse=True)
    got_c = np.bincount(inv, weights=np.concatenate(wts)).astype(np.int64)
    if not (np.array_equal(got_k, want_k) and np.array_equal(got_c, want_c)):
        raise AssertionError("P12 exact: e2e counts != numpy")
    del stores

    # the graph: each node's counters from its windows' edge bytes
    rev4 = np.array([int(f"{v:04b}"[::-1], 2) for v in range(16)], np.uint8)
    n = bases
    rows, ebytes = [], []
    for x, (start, canon, was_rc) in zip(bench_chunks(c.codes_np, chunks),
                                         windows):
        d = np.uint8(1) << x
        left_ok = (start >= 1) & (seg[np.maximum(start - 1, 0)] == seg[start])
        right = start + K
        right_ok = (right < n) & (seg[np.minimum(right, n - 1)] == seg[start])
        left = np.where(left_ok, d[np.maximum(start - 1, 0)], 0)
        right = np.where(right_ok, d[np.minimum(right, n - 1)], 0)
        e = (left << 4) | right
        e = np.where(was_rc, (rev4[e & 15] << 4) | rev4[e >> 4], e)
        rows.append(canon)
        ebytes.append(e.astype(np.uint8))

    def counters(keys, eb, weight):
        uniq, inv = np.unique(keys, return_inverse=True)
        cols = [((eb >> j) & 1) * weight for j in range(8)] + [weight]
        return uniq, np.stack([np.bincount(inv, weights=col,
                                           minlength=uniq.size)
                               for col in cols], axis=1).astype(np.int64)

    want_n, want_cnt = counters(np.concatenate(rows),
                                np.concatenate(ebytes),
                                np.ones(sum(r.size for r in rows), np.int64))
    _, runs = headline.debruijn(ctx("debruijn"))
    keys, ebs, wts = [], [], []
    for r in runs:
        live = (r.weights > 0).cpu().numpy()
        eb = r.ebytes.cpu().numpy()[live].astype(np.uint8)
        wt = r.weights.cpu().numpy()[live].astype(np.int64)
        bits = (eb[:, None] >> np.arange(8, dtype=np.uint8)) & 1
        totals = np.concatenate([(bits * wt[:, None]).sum(0), [wt.sum()]])
        if not np.array_equal(r.bsum[:, -1].cpu().numpy(), totals):
            raise AssertionError("P12 exact: a run's counter tables do not "
                                 "end at its counter totals")
        keys.append(key_ints(r.keys, live))
        ebs.append(eb)
        wts.append(wt)
    got_n, got_cnt = counters(np.concatenate(keys), np.concatenate(ebs),
                              np.concatenate(wts))
    if not (np.array_equal(got_n, want_n)
            and np.array_equal(got_cnt, want_cnt)):
        raise AssertionError("P12 exact: de Bruijn node counters != numpy")
    del runs

    # the multimap: every (k-mer, read, offset) pair and its quality
    pc = ctx("position_quality")
    phred = pc.qual_np().astype(np.float64) - 33
    with np.errstate(divide="ignore"):
        logp = np.where(phred == 0, 0.0, np.log2(1.0 - 10.0 ** (-phred / 10)))
    cs = np.concatenate([[0.0], np.cumsum(logp)])
    zs = np.concatenate([[0], np.cumsum(phred == 0)])
    start = windows[0][0]
    wq = np.where(zs[start + K] > zs[start], 0.0,
                  np.exp2(cs[start + K] - cs[start]))
    want = (np.concatenate([w[1] for w in windows]),
            np.tile(seg[start].astype(np.int64), chunks),
            np.tile(start % pc.args.read_len, chunks))
    want_q = np.tile(wq, chunks)
    _, (store, ovf) = headline.position_quality(pc)
    size = int(store.size)
    got = (key_ints(store.keys, np.arange(size)),
           to_numpy_u32(store.val_hi[:size]).astype(np.int64),
           to_numpy_u32(store.val_lo[:size]).astype(np.int64))
    got_q = store.val_q[:size].cpu().numpy()
    go, wo = np.lexsort(got[::-1]), np.lexsort(want[::-1])
    if ovf != 0 or size != want_q.size or not all(
            np.array_equal(g[go], w[wo]) for g, w in zip(got, want)):
        raise AssertionError("P12 exact: position-quality pairs != numpy")
    np.testing.assert_allclose(got_q[go], want_q[wo], rtol=1e-5, atol=0,
                               err_msg="P12 exact: window qualities")
    log(f"P12 exact at {bases} bases x {chunks} chunks: e2e {want_k.size} "
        f"canonical 21-mers == numpy counts, debruijn {want_n.size} nodes' "
        f"9 counters == numpy, position_quality {size} pairs == numpy "
        f"(qualities rtol 1e-5); seconds {time.perf_counter() - t0:.2f} "
        f"[{smi}]")


def phase_p12(dev, smi, argv=(), exact=(1 << 20, 3)) -> dict:
    """P12: the headline bench (`kmerind_tpu_torch.bench.headline`) in
    this process: every run of `P12_RUNS` (with `argv` appended) through
    the mode's function, its JSON line printed with the card, its
    iterations and its peak device memory, and its answers held; then the
    public sortops callers of the one-run kernels (`bitonic_merge`,
    `bitonic_merge_cols`) on a [2^24, 2] bitonic run and of K2′
    (`merge_sorted_runs`) on its two halves; then `p12_exact`.
    Returns the kernel launches of the whole phase (counters zeroed just
    before, read just after)."""
    import torch
    from kmerind_tpu_torch.bench import headline
    from kmerind_tpu_torch.ops import kernels, sortops
    t_all = time.perf_counter()
    kernels.reset_launches()
    for run in P12_RUNS:
        args = headline.parse_args(["--mode", *run, "--device", str(dev),
                                    "--json-only", *argv])
        ctx = headline.Context.create(args)
        if dev.type == "cuda":
            torch.cuda.reset_peak_memory_stats(dev)
        t0 = time.perf_counter()
        result, state = headline.MODES[args.mode](ctx)
        wall = time.perf_counter() - t0
        log(f"P12 {json.dumps(result)}")
        windows = headline.in_read_windows(args.bases, args.read_len, args.k)
        m = args.queries
        if args.mode == "e2e":
            got = sum(int(s.csum[-1]) for s in state)
            ok = got == args.chunks * windows
        elif args.mode == "ingest":
            got = int(state[1].sum())
            ok = got == windows
        elif args.mode == "count_query":
            counts = state[1]
            got = int(counts.sum())
            ok = bool((counts > 0).all()) and got >= m
        elif args.mode == "erase":
            got = [int(x) for x in state[1]]
            ok = got[0] > 0 and len(set(got)) == 1
        elif args.mode == "multimap_find":
            got = int(state[1].sum())
            ok = got >= m
        elif args.mode.startswith("debruijn"):
            got = sum(int(r.bsum[8, -1]) for r in state)
            ok = got == args.chunks * windows
        else:
            got = (int(state[0].size), state[1])
            ok = got == (args.chunks * windows, 0)
        peak = peak_bytes(dev)
        log(f"P12 {' '.join(run)}: held {got} ({'ok' if ok else 'WRONG'}), "
            f"iterations {[round(t, 6) for t in ctx.times]} s, peak device "
            f"memory {peak} bytes, wall {wall:.2f} s [{smi}]")
        if not ok:
            raise AssertionError(f"P12 {' '.join(run)}: wrong answer {got}")
        del ctx, state
        if dev.type == "cuda":
            torch.cuda.empty_cache()

    # the public callers of the one-run kernels: a bitonic run of 2^24 key
    # rows; then K2′'s, on its two halves
    gen = torch.Generator(device=dev).manual_seed(12)
    half = 1 << (23 if dev.type == "cuda" else 11)
    a = sortops.sort_rows(torch.randint(-(2**31), 2**31 - 1, (half, 2),
                                        dtype=torch.int32, device=dev,
                                        generator=gen))[0]
    b = sortops.sort_rows(torch.randint(-(2**31), 2**31 - 1, (half, 2),
                                        dtype=torch.int32, device=dev,
                                        generator=gen))[0]
    keys = torch.cat([a, b.flip(0)])
    pay = torch.arange(2 * half, dtype=torch.int32, device=dev)
    for fn, src in ((sortops.bitonic_merge, keys),
                    (sortops.bitonic_merge_cols, keys.t().contiguous()),
                    (sortops.merge_sorted_runs, None)):
        if src is None:
            out, (p,) = fn(a, (pay[:half],), b, (pay[half:].flip(0),))
        else:
            out, (p,) = fn(src, (pay,))
        rows = out if fn is not sortops.bitonic_merge_cols else out.t()
        less, _ = kernels._lex_cmp([rows[1:, 0], rows[1:, 1]],
                                   [rows[:-1, 0], rows[:-1, 1]])
        if bool(less.any()) or not torch.equal(
                torch.sort(p).values, pay) or not torch.equal(
                rows, keys[p.to(torch.int64)]):
            raise AssertionError(f"P12 {fn.__name__}: not a sorted "
                                 "permutation of its input")
    del a, b, keys, pay, out, p, rows, less
    launches = dict(kernels.LAUNCHES)
    log(f"P12 sortops.bitonic_merge / bitonic_merge_cols of [{2 * half}, 2] "
        f"bitonic key rows and merge_sorted_runs of its halves, 1 payload: "
        f"sorted permutations [{smi}]")
    log(f"P12 launches: {launches}; K2 by payload count "
        f"{dict(kernels.K2_PAYLOAD_LAUNCHES)}")
    if exact:
        p12_exact(dev, headline, smi, *exact)
    log(f"P12 seconds {time.perf_counter() - t_all:.2f} [{smi}]")
    for kname in ("extract_canonical", "merge_runs_cols",
                  "merge_sorted_runs", "bitonic_merge_rows",
                  "bitonic_merge_cols", "prefix_sum_i32"):
        if not launches[kname]:
            raise AssertionError(f"P12: {kname} never ran: {launches}")
    return launches


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, str(pathlib.Path(__file__).resolve().parent))
    from kmerind_tpu_torch import (ASCII, DNA, DNA16, CountIndex, KmerSpec,
                                   PositionIndex, PositionQualityIndex,
                                   SortedCountIndex,
                                   SortedPositionQualityIndex)
    from kmerind_tpu_torch.io import native, read_file, split_records_at_invalid
    from kmerind_tpu_torch.ops import kernels, packing, sortops
    from kmerind_tpu_torch.ops.keys import biased, lex_argsort, to_numpy_u32

    dev = torch.device("cuda")
    t_all = time.perf_counter()

    # ---------------------------------------------------------------- P0
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip().splitlines()[0]
    name = torch.cuda.get_device_name(0)
    log(f"P0 device: {smi} | torch: {name} | torch {torch.__version__} "
        f"cuda {torch.version.cuda} | devices {torch.cuda.device_count()}")

    # ---------------------------------------------------------------- P1
    t0 = time.perf_counter()
    info = kernels.build()
    log(f"P1 build: nvcc {info['seconds']:.2f} s, load "
        f"{time.perf_counter() - t0:.2f} s -> {info['path']} [{smi}]")
    for line in info["log"].splitlines():
        if "registers" in line or "spill" in line or "Compiling" in line:
            log(f"P1 ptxas: {line.strip()}")
    # the FASTQ parser of P3/P4: the native one, built by make, or a failure
    native.require()
    log("P1 parser: native fastscan loaded")

    # ---------------------------------------------------------------- P2
    t0 = time.perf_counter()
    gen = torch.Generator(device=dev).manual_seed(0)
    results = {}

    def record(kname, case, call, plain, err, nbytes, library=None,
               slow_plain=False):
        """Check one P2 case and time it: the kernel's wrapper over many
        launches (`median_ms`), one call alone (`single_ms`), the host's
        enqueue time per call (`host_ms`) and under the profiler (its
        kernels' device time per call); the plain version and the library
        call the same way as the wrapper (`slow_plain`: a plain version of
        a large fraction of a second a call is timed over 5 calls, one a
        run, not over 121)."""
        if err != 0:
            raise AssertionError(f"{kname} {case}: kernel != plain "
                                 f"(max_abs_err {err})")
        ms, one, host = median_ms(call), single_ms(call), host_ms(call)
        device_ms = sum(kernel_us_per_call(call).values()) / 1e3
        plain_ms = (median_ms(plain, reps=3, calls=1, min_run_ms=0.0)
                    if slow_plain else median_ms(plain))
        library_ms = None if library is None else median_ms(library)
        bound = bound_ms(nbytes)
        lib = "none" if library_ms is None else f"{library_ms:.4f} ms"
        log(f"P2 {kname} {case}: kernel {ms:.4f} ms, device_ms "
            f"{device_ms:.4f}, single_ms {one:.4f}, host_ms {host:.4f}, "
            f"plain {plain_ms:.4f} ms, "
            f"bound {bound:.4f} ms ({nbytes} bytes, {100 * bound / ms:.1f} %), "
            f"library {lib}, max_abs_err {err} [{smi}]")
        results.setdefault(kname, {
            "max_abs_err": err, "ms": ms, "device_ms": device_ms,
            "plain_ms": plain_ms, "bound_ms": bound, "bound_by": "bytes",
            "library_ms": library_ms})

    def err_of(a, b):
        return int((a.to(torch.int64) - b.to(torch.int64)).abs().max())

    def packed_sort(a_cols, b_cols):
        """A stable torch.sort of the runs' packed int64 keys (w=2)."""
        cols = torch.cat([a_cols, b_cols], 1)
        key = ((biased(cols[0]).to(torch.int64) << 32)
               | (cols[1].to(torch.int64) & 0xFFFFFFFF))
        return lambda: torch.sort(key, stable=True)

    def canonical(case, codes, spec):
        w, rc = kernels.extract_canonical(codes, spec)
        pw, prc = packing.extract_canonical(codes, spec)
        nv = codes.shape[0] - spec.k + 1
        err = max(err_of(w[:nv], pw[:nv]), err_of(rc[:nv], prc[:nv]))
        del w, rc, pw, prc
        record("extract_canonical", case,
               lambda: kernels.extract_canonical(codes, spec),
               lambda: packing.extract_canonical(codes, spec), err,
               kernel_bytes("extract_canonical", n=codes.shape[0],
                            nwords=spec.nwords), slow_plain=spec.k > 64)

    # k=21: the main path; k=63 DNA, k=31 DNA16: 128-bit rolling state;
    # above 128 bits the wide bit-stream kernel: DNA k=65 to 1024 (k=127:
    # P7), DNA16 and ASCII at k=64
    for spec in (KmerSpec(21, DNA), KmerSpec(63, DNA), KmerSpec(31, DNA16),
                 KmerSpec(65, DNA), KmerSpec(K_WIDE, DNA),
                 KmerSpec(255, DNA), KmerSpec(512, DNA),
                 KmerSpec(1024, DNA), KmerSpec(64, DNA16),
                 KmerSpec(64, ASCII)):
        codes = torch.randint(0, spec.alphabet.size, (CHUNK,),
                              dtype=torch.uint8, device=dev, generator=gen)
        canonical(f"n={CHUNK} {spec} ({kernels.k1_kernel(spec)})", codes,
                  spec)
    # a view 4 bytes into a larger tensor, like shard 1 of a 4-shard sorted
    # index (its start is not 16-byte aligned)
    big = torch.randint(0, 4, (CHUNK + 64,), dtype=torch.uint8, device=dev,
                        generator=gen)
    canonical(f"n={CHUNK} k=21 DNA, view at byte offset 4", big[4:4 + CHUNK],
              KmerSpec(21, DNA))
    del codes, big

    def sorted_run(n, flagged=False, w=2):
        """[w, n] sorted key columns, 1 % sentinel rows at the tail: k=21
        (w=2) or k=127 (w=8) DNA words; flagged: w full words (k=32: 2,
        k=512: 32) behind a liveness flag column (0 live, 1 dead), the
        flagged multimap flush's [w + 1, n] keys."""
        words = torch.randint(-(2**31), 2**31 - 1, (n, w), dtype=torch.int32,
                              device=dev, generator=gen)
        if not flagged:                       # the right-aligned last word
            words[:, -1] &= 0x3FF if w == 2 else 0x3FFFFFFF
        valid = torch.rand(n, device=dev, generator=gen) > 0.01
        cols, _, s_valid = sortops.sort_rows(words, (), valid,
                                             sentinel_ok=not flagged,
                                             as_cols=True)
        if flagged:
            cols = torch.cat([(~s_valid).to(torch.int32)[None], cols])
        return cols

    # keys only, a count index's weights (0..99), and the de Bruijn
    # graph's edge bytes (0-255) as the one payload of a unit merge and
    # (edge byte, weight) of a weighted one: each payload column's values
    # drawn below its bound in `highs`
    for na, nb, highs, what in (
            (CHUNK, CHUNK, (), ""), (1 << 26, CHUNK, (), ""),
            (CHUNK, CHUNK, (100,), ""),
            (CHUNK, CHUNK, (256,), " de Bruijn (edge byte)"),
            (CHUNK, CHUNK, (256, 1000), " de Bruijn (edge byte, weight)")):
        npay = len(highs)
        a, b = sorted_run(na), sorted_run(nb)
        pa, pb = (tuple(torch.randint(0, hi, (n,), dtype=torch.int32,
                                      device=dev, generator=gen)
                        for hi in highs) for n in (na, nb))
        gk, gp = kernels.merge_runs_cols(a, pa, b, pb)
        wk, wp = kernels.merge_runs_cols_plain(a, pa, b, pb)
        err = max([err_of(gk, wk)] + [err_of(x, y) for x, y in zip(gp, wp)])
        n_out = gk.shape[1]
        del gk, gp, wk, wp
        record("merge_runs_cols", f"{na}+{nb} w=2 payloads={npay}{what}",
               lambda: kernels.merge_runs_cols(a, pa, b, pb),
               lambda: kernels.merge_runs_cols_plain(a, pa, b, pb),
               err, kernel_bytes("merge_runs_cols", na=na, nb=nb,
                                 n_out=n_out, w=2, npay=npay),
               packed_sort(a, b))
        del a, b, pa, pb

    # the multimap flushes: a store of 2^26 rows merged with a batch of
    # 2^24, the id halves and the quality bits riding as 3 payloads, at
    # k=21 (w=2), in the flagged flush (k = 32: a flag column ahead of the
    # 2 key words) and at k=127 (w=8, P7's flushes); P7's CountIndex
    # merges (8,388,628 + 8,388,628 rows, w=8, keys only); and the widest
    # keys, DNA k=512 (a flag and 32 full words) with Bimolecule's 4
    # payloads, past the 9 key words K2 compares in registers.  Library
    # call: the stable sort of the first 2 key words packed in int64.
    for na, nb, npay, w, flagged, shape in (
            (1 << 26, 1 << 24, 3, 2, False, "multimap flush, w=2"),
            (1 << 26, 1 << 24, 3, 2, True,
             "flagged flush, w=3 (flag + 2 words)"),
            (CHUNK, CHUNK, 0, 8, False, "k=127 merge, w=8"),
            (1 << 26, 1 << 24, 3, 8, False, "k=127 multimap flush, w=8"),
            (1 << 22, 1 << 22, 4, 32, True,
             "k=512 flagged, w=33 (flag + 32 words)")):
        a, b = sorted_run(na, flagged, w), sorted_run(nb, flagged, w)
        pa, pb = (tuple(torch.randint(-(2**31), 2**31 - 1, (n,),
                                      dtype=torch.int32, device=dev,
                                      generator=gen) for _ in range(npay))
                  for n in (na, nb))
        gk, gp = kernels.merge_runs_cols(a, pa, b, pb)
        wk, wp = kernels.merge_runs_cols_plain(a, pa, b, pb)
        err = max([err_of(gk, wk)] + [err_of(x, y) for x, y in zip(gp, wp)])
        kw, n_out = gk.shape
        del gk, gp, wk, wp
        record("merge_runs_cols", f"{na}+{nb} {shape} payloads={npay}",
               lambda: kernels.merge_runs_cols(a, pa, b, pb),
               lambda: kernels.merge_runs_cols_plain(a, pa, b, pb),
               err, kernel_bytes("merge_runs_cols", na=na, nb=nb,
                                 n_out=n_out, w=kw, npay=npay),
               packed_sort(a[kw - w:kw - w + 2], b[kw - w:kw - w + 2]),
               slow_plain=kw > 2)
        del a, b, pa, pb
        torch.cuda.empty_cache()

    # Bimolecule's merges: K2 at w=2 with 4 payloads — the weight (0-3),
    # both id halves (full 32-bit patterns, -1 on the sentinel tail) and
    # the strand (0 / 1) — at a merge of two chunks' runs and at a flush's
    # shape (a store of 2^26 rows, 2^24 pending)
    def bimol_pays(cols):
        n = cols.shape[1]
        live = ~(cols == -1).all(dim=0)
        full = lambda: torch.randint(  # noqa: E731
            -(2**31), 2**31 - 1, (n,), dtype=torch.int32, device=dev,
            generator=gen)
        small = lambda hi: torch.randint(  # noqa: E731
            0, hi, (n,), dtype=torch.int32, device=dev, generator=gen)
        return (torch.where(live, small(4), 0),
                torch.where(live, full(), -1), torch.where(live, full(), -1),
                torch.where(live, small(2), 0))

    for na, nb in ((CHUNK, CHUNK), (1 << 26, 1 << 24)):
        a, b = sorted_run(na), sorted_run(nb)
        pa, pb = bimol_pays(a), bimol_pays(b)
        gk, gp = kernels.merge_runs_cols(a, pa, b, pb)
        wk, wp = kernels.merge_runs_cols_plain(a, pa, b, pb)
        err = max([err_of(gk, wk)] + [err_of(x, y) for x, y in zip(gp, wp)])
        n_out = gk.shape[1]
        del gk, gp, wk, wp
        record("merge_runs_cols", f"{na}+{nb} w=2 payloads=4 Bimolecule "
               "(weight, id halves, strand)",
               lambda: kernels.merge_runs_cols(a, pa, b, pb),
               lambda: kernels.merge_runs_cols_plain(a, pa, b, pb),
               err, kernel_bytes("merge_runs_cols", na=na, nb=nb,
                                 n_out=n_out, w=2, npay=4),
               packed_sort(a, b))
        del a, b, pa, pb
        torch.cuda.empty_cache()

    # K2′: row-major runs, w=2 and w=8, one payload
    for w in (2, 8):
        a, b = (sorted_run(CHUNK, w=w).t().contiguous() for _ in range(2))
        pa, pb = ((torch.randint(0, 100, (CHUNK,), dtype=torch.int32,
                                 device=dev, generator=gen),)
                  for _ in range(2))
        gk, gp = kernels.merge_sorted_runs(a, pa, b, pb)
        wk, wp = kernels.merge_sorted_runs_plain(a, pa, b, pb)
        err, n_out = max(err_of(gk, wk), err_of(gp[0], wp[0])), gk.shape[0]
        del gk, gp, wk, wp
        record("merge_sorted_runs", f"{CHUNK}+{CHUNK} rows w={w} payloads=1",
               lambda: kernels.merge_sorted_runs(a, pa, b, pb),
               lambda: kernels.merge_sorted_runs_plain(a, pa, b, pb), err,
               kernel_bytes("merge_sorted_runs", na=CHUNK, nb=CHUNK,
                            n_out=n_out, w=w, npay=1),
               packed_sort(a[:, :2].t(), b[:, :2].t()), slow_plain=w > 2)
        del a, b, pa, pb

    # the one-run bitonic kernels through their public callers,
    # sortops.bitonic_merge (rows) and bitonic_merge_cols: a bitonic run of
    # 2^24 rows (w=2: an ascending half, then a descending one) with one
    # payload, against the plain network on the same card (keys bitwise,
    # payloads per key run: neither merge is stable); a call's device
    # kernels are the split, partition and tile launches and nothing else
    a, b = (sorted_run(1 << 23).t().contiguous() for _ in range(2))
    rows = torch.cat([a, b.flip(0)])
    del a, b
    pay = torch.randint(0, 100, (1 << 24,), dtype=torch.int32, device=dev,
                        generator=gen)
    less, _ = kernels._lex_cmp([rows[1:, 0], rows[1:, 1]],
                               [rows[:-1, 0], rows[:-1, 1]])
    split = int(less.nonzero()[0]) + 1
    del less

    def by_run(k, p):
        order = lex_argsort([biased(k[:, 0]), biased(k[:, 1]), p])
        return p[order]

    bitonic_kernels = {"bitonic_split_kernel", "merge_partition_kernel",
                       "merge_tiles_kernel"}
    for kname, fn, plain, keys in (
            ("bitonic_merge_rows", sortops.bitonic_merge,
             kernels.bitonic_merge_rows_plain, rows),
            ("bitonic_merge_cols", sortops.bitonic_merge_cols,
             kernels.bitonic_merge_cols_plain, rows.t().contiguous())):
        gk, (gp,) = fn(keys, (pay,))
        wk, (wp,) = plain(keys, (pay,))
        if kname == "bitonic_merge_cols":
            gk, wk = gk.t(), wk.t()
        err = max(err_of(gk, wk), err_of(by_run(gk, gp), by_run(wk, wp)))
        del gk, gp, wk, wp
        us = kernel_us_per_call(lambda: fn(keys, (pay,)))
        if set(us) != bitonic_kernels:
            raise AssertionError(f"{kname}: a call ran the device kernels "
                                 f"{sorted(us)}, not {sorted(bitonic_kernels)}")
        log(f"P2 {kname} device us a call by kernel: " + ", ".join(
            f"{k} {v:.2f}" for k, v in sorted(us.items())) + f" [{smi}]")
        record(kname, f"sortops.{fn.__name__} [2^24, 2] bitonic run (split "
               f"{split}) payloads=1, plain: the network",
               lambda: fn(keys, (pay,)), lambda: plain(keys, (pay,)), err,
               kernel_bytes(kname, n=1 << 24, w=2, npay=1),
               packed_sort(rows[:split].t(), rows[split:].t()))
        del keys
    del rows, pay

    # values 0..1 and 0..100, and one edge-bit stream of the graph's
    # counter tables (an out-edge bit: 1 in 4 rows)
    for hi, case in ((2, "values 0..1"), (101, "values 0..100"),
                     (4, "edge-bit stream (1 where 0 of 0..3)")):
        x = torch.randint(0, hi, (1 << 28,), dtype=torch.int32, device=dev,
                          generator=gen)
        if hi == 4:
            x = (x == 0).to(torch.int32)
        err = err_of(kernels.prefix_sum_i32(x), kernels.prefix_sum_i32_plain(x))
        record("prefix_sum_i32", f"n=2^28 {case}",
               lambda: kernels.prefix_sum_i32(x),
               lambda: kernels.prefix_sum_i32_plain(x), err,
               kernel_bytes("prefix_sum_i32", n=x.shape[0]),
               lambda: torch.cumsum(x, 0, dtype=torch.int32))
        del x

    def run_lengths(case, kcols, tv):
        got = kernels.run_length_weights(kcols, tv)
        want = kernels.run_length_weights_plain(kcols, tv)
        if int(want.sum()) != int(tv):
            raise AssertionError(f"run_length_weights {case}: weights do not "
                                 "sum to total_valid")
        record("run_length_weights", case,
               lambda: kernels.run_length_weights(kcols, tv),
               lambda: kernels.run_length_weights_plain(kcols, tv),
               err_of(got, want), kernel_bytes(
                   "run_length_weights", n=kcols.shape[1], w=kcols.shape[0]))

    # the real input: sorted canonical 21-mers of one chunk of reads
    rcodes = make_reads(GENOME_LEN, CHUNK // READ_LEN + 1, seed=5)
    rcodes = rcodes.reshape(-1)[:CHUNK].copy()
    rcodes[rcodes == 4] = 0
    words, _ = kernels.extract_canonical(torch.from_numpy(rcodes).to(dev),
                                         KmerSpec(K, DNA))
    kcols, _, s_valid = sortops.sort_rows(
        words, (), torch.arange(CHUNK, device=dev) <= CHUNK - K,
        is_stable=False, sentinel_ok=True, as_cols=True)
    tv_reads = s_valid.sum(dtype=torch.int32)
    run_lengths(f"n={CHUNK} sorted canonical 21-mers of reads", kcols,
                tv_reads)
    # the same rows, n % 4 == 3: key word columns 1 start off 16 bytes
    run_lengths(f"n={CHUNK - 1} the same, column 1 not 16-byte aligned",
                kcols[:, :CHUNK - 1].contiguous(), tv_reads)
    # ~1000 distinct keys in 2^27 rows: runs of ~134k rows span many tiles
    table = sortops.sort_rows(torch.randint(
        -(2**31), 2**31 - 1, (1000, 2), dtype=torch.int32, device=dev,
        generator=gen), ())[0]
    pick = torch.sort(torch.randint(0, 1000, (1 << 27,), device=dev,
                                    generator=gen)).values
    kcols = table[pick].t().contiguous()
    run_lengths("n=2^27 w=2 ~1000 keys", kcols, torch.tensor(
        1 << 27, dtype=torch.int32, device=dev))
    # tv < n, the first invalid row equal to the last valid one
    kcols = kcols[:, :CHUNK].contiguous()
    tv = CHUNK // 2 + 7
    if not torch.equal(kcols[:, tv], kcols[:, tv - 1]):
        raise AssertionError("P2: row tv does not repeat row tv-1")
    run_lengths(f"n={CHUNK} tv={tv} row tv == row tv-1", kcols,
                torch.tensor(tv, dtype=torch.int32, device=dev))
    del rcodes, words, kcols, s_valid, table, pick
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    log(f"P2 seconds {time.perf_counter() - t0:.2f} [{smi}]")

    spec = KmerSpec(K, DNA)
    with tempfile.TemporaryDirectory() as tmp:
        tmp = pathlib.Path(tmp)

        # ------------------------------------------------------------ P3
        t0 = time.perf_counter()
        codes = make_reads(1_000_000, 80_000, seed=1)
        quals = make_quals(codes, seed=1)
        path = tmp / "p3.fastq"
        write_fastq(codes, quals, path)
        idx = CountIndex(spec, device=dev, max_runs=2)
        batch = split_records_at_invalid(
            read_file(path, DNA), np.fromfile(path, np.uint8), DNA)
        idx.insert_batch(batch, chunk_bases=1 << 20)
        merges = idx.timer.count("merge")
        idx.compact()
        got = idx.to_dict()
        canon, has_n = canonical_codes(codes)
        uniq, cnt = np.unique(canon[~has_n], return_counts=True)
        want = dict(zip(uniq.tolist(), cnt.tolist()))
        if got != want:
            raise AssertionError(f"P3 to_dict != numpy counter "
                                 f"({len(got)} vs {len(want)} keys)")
        log(f"P3 exact reference: {codes.size} bases, "
            f"{idx.timer.count('insert')} chunks, {merges} merges, "
            f"{len(want)} distinct canonical 21-mers == numpy counter; "
            f"seconds {time.perf_counter() - t0:.2f} [{smi}]")
        del idx, got, canon, has_n, cnt

        # ----------------------------------------------------------- P3s
        t0 = time.perf_counter()
        sidx = SortedCountIndex(spec, device=dev, nparts=4)
        sidx.insert_batch(batch, chunk_bases=1 << 20)
        if sidx.to_dict() != want:
            raise AssertionError("P3s: to_dict != numpy counter")
        keys = to_numpy_u32(sidx.store.keys)
        sizes = sidx.store.size.cpu().numpy()
        shard_keys = [spec.to_ints(keys[s, :n]) for s, n in enumerate(sizes)]
        flat = np.concatenate(shard_keys)
        if not (np.diff(flat.astype(np.int64)) > 0).all():
            raise AssertionError("P3s: shards not globally range-partitioned")
        bounds = spec.to_ints(sidx.splitter_table())
        for s, ks in enumerate(shard_keys):
            if not (np.searchsorted(bounds, ks, side="right") == s).all():
                raise AssertionError(f"P3s: shard {s} breaks the owner rule")
        lo, hi = int(uniq[len(uniq) // 3]), int(uniq[len(uniq) // 3 + 5000])
        if sidx.items_in_range(lo, hi) != [(k, want[k]) for k in
                                           uniq[len(uniq) // 3:
                                                len(uniq) // 3 + 5000]
                                           .tolist()]:
            raise AssertionError("P3s: items_in_range != numpy slice")
        gone = np.stack([spec.from_int(int(k)) for k in uniq[::len(uniq)
                                                             // 1000][:1000]])
        if sidx.erase(gone) != 1000 or sidx.count(gone).any():
            raise AssertionError("P3s: erase of 1000 keys")
        log(f"P3s sorted index, 4 shards: {sidx.timer.count('insert')} "
            f"chunks, shard sizes {sizes.tolist()} == numpy counter, range "
            f"partitioned by splitters, items_in_range 5000 keys, erase 1000; "
            f"seconds {time.perf_counter() - t0:.2f} [{smi}]")
        del sidx, keys

        # ----------------------------------------------------------- P3p
        phase_p3p(dev, codes, quals, path, batch, want, smi)
        del batch, want, uniq

        # ------------------------------------------------------------ P4
        t0 = time.perf_counter()
        n_reads = GENOME_LEN * COVERAGE // READ_LEN
        codes = make_reads(GENOME_LEN, n_reads, seed=0)
        quals = make_quals(codes, seed=0)
        path = tmp / "p4.fastq"
        write_fastq(codes, quals, path)
        n_windows = n_reads * (READ_LEN - K + 1)
        log(f"P4 data: {n_reads} reads, {codes.size} bases, "
            f"{path.stat().st_size} bytes FASTQ, {n_windows} windows; "
            f"seconds {time.perf_counter() - t0:.2f} [{smi}]")
        rng = np.random.default_rng(2)
        r = rng.integers(0, n_reads, 900_000)
        o = rng.integers(0, READ_LEN - K + 1, 900_000)
        qcodes = np.concatenate([
            codes[r[:, None], o[:, None] + np.arange(K)],
            rng.integers(0, 4, (100_000, K), dtype=np.uint8)])
        qcodes[qcodes == 4] = 0               # DNA encodes N as A
        queries = pack_rows(qcodes)
        t0 = time.perf_counter()
        canon_all = window_codes(codes)
        sorted_codes = np.sort(canon_all, axis=None)
        want_counts = expected_counts(sorted_codes, qcodes)
        ref_keys, ref_cnts = distinct_counts(sorted_codes)
        log(f"P4 numpy reference counts: "
            f"{time.perf_counter() - t0:.2f} s [{smi}]")

        idx = CountIndex(spec, device=dev)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        kernels.reset_launches()
        t0 = time.perf_counter()
        idx.build(path)
        torch.cuda.synchronize()
        build_s = time.perf_counter() - t0
        log(f"P4 build: {build_s:.3f} s, {n_windows / build_s:.0f} k-mers/s, "
            f"parser {'native' if native.available() else 'numpy'}, "
            f"{idx.timer.count('insert')} chunks, "
            f"{idx.timer.count('merge')} merges, {len(idx.runs)} runs "
            f"[{smi}]")
        q_s = []
        for _ in range(2):
            t0 = time.perf_counter()
            counts = idx.count(queries)
            q_s.append(time.perf_counter() - t0)
        if not (counts[:900_000] >= 1).all():
            raise AssertionError("P4: a sampled read window counted 0")
        if not np.array_equal(counts, want_counts):
            raise AssertionError(
                f"P4: {int((counts != want_counts).sum())} of "
                f"{counts.size} counts differ from the numpy reference")
        log(f"P4 count: {queries.shape[0]} queries, first call (aux build) "
            f"{q_s[0]:.3f} s = {queries.shape[0] / q_s[0]:.0f} q/s, second "
            f"{q_s[1]:.3f} s = {queries.shape[0] / q_s[1]:.0f} q/s; "
            f"random hits {int((counts[900_000:] > 0).sum())} [{smi}]")
        t0 = time.perf_counter()
        rows, cnts = idx.items()
        items_s = time.perf_counter() - t0
        if int(cnts.sum()) != n_windows or rows.shape[0] != idx.size():
            raise AssertionError(f"P4 items: sum {int(cnts.sum())} != "
                                 f"{n_windows} windows")
        t0 = time.perf_counter()
        idx.compact()
        torch.cuda.synchronize()
        compact_s = time.perf_counter() - t0
        launches = {"P4": dict(kernels.LAUNCHES)}
        peak = torch.cuda.max_memory_allocated()
        if idx.size() != rows.shape[0]:
            raise AssertionError("P4: compact() changed the distinct count")
        log(f"P4 items: {rows.shape[0]} distinct, count sum {int(cnts.sum())}"
            f" == windows, {items_s:.3f} s; compact {compact_s:.3f} s; "
            f"peak device memory {peak} bytes [{smi}]")
        log("P4 phases:\n" + idx.timer.report("P4"))
        p4 = launches["P4"]
        log(f"P4 launches: {p4}")
        if p4["extract_canonical"] != idx.timer.count("insert"):
            raise AssertionError("P4: K1 launches != chunks")
        if p4["merge_runs_cols"] < idx.timer.count("merge"):
            raise AssertionError("P4: K2 launches < merges")
        for kname in ("extract_canonical", "merge_runs_cols",
                      "prefix_sum_i32"):
            if not p4[kname]:
                raise AssertionError(f"P4: {kname} never ran: {p4}")
        distinct = rows.shape[0]
        del idx, rows, cnts
        torch.cuda.empty_cache()

        # ------------------------------------------------------------ P5
        sidx = SortedCountIndex(spec, device=dev)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        kernels.reset_launches()
        t0 = time.perf_counter()
        sidx.build(path)
        torch.cuda.synchronize()
        build_s = time.perf_counter() - t0
        chunks = sidx.timer.count("insert")
        t0 = time.perf_counter()
        size = sidx.size()
        flush_s = time.perf_counter() - t0
        q_s = []
        for _ in range(2):
            t0 = time.perf_counter()
            counts = sidx.count(queries)
            q_s.append(time.perf_counter() - t0)
        launches["P5"] = p5 = dict(kernels.LAUNCHES)
        peak = torch.cuda.max_memory_allocated()
        log(f"P5 sorted index, 1 shard: build {build_s:.3f} s = "
            f"{n_windows / build_s:.0f} k-mers/s, {chunks} chunks; flush "
            f"(first size()) {flush_s:.3f} s; {queries.shape[0]} count() "
            f"queries, first {q_s[0]:.3f} s = {queries.shape[0] / q_s[0]:.0f} "
            f"q/s, second {q_s[1]:.3f} s = {queries.shape[0] / q_s[1]:.0f} "
            f"q/s; peak device memory {peak} bytes [{smi}]")
        log("P5 phases:\n" + sidx.timer.report("P5"))
        log(f"P5 launches: {p5}")
        if not np.array_equal(counts, want_counts):
            raise AssertionError(
                f"P5: {int((counts != want_counts).sum())} of {counts.size} "
                "counts differ from the numpy reference")
        if size != distinct:
            raise AssertionError(f"P5: size {size} != P4 distinct {distinct}")
        if int(sidx.store.counts.sum()) != n_windows:
            raise AssertionError("P5: store counts do not sum to windows")
        t0 = time.perf_counter()
        if not np.array_equal(sidx.histogram(), spectrum(ref_cnts)):
            raise AssertionError("P5: histogram() != the numpy spectrum")
        log(f"P5 histogram(255) {time.perf_counter() - t0:.3f} s == numpy "
            f"spectrum [{smi}]")
        if not p5["extract_canonical"] == p5["run_length_weights"] == chunks:
            raise AssertionError(f"P5: K1 / K4 launches != {chunks} chunks")
        del sidx
        torch.cuda.empty_cache()

        # ------------------------------------------------------------ P6
        launches["P6"] = phase_p6(dev, path, quals, qcodes, queries,
                                  canon_all, want_counts, smi)
        del sorted_codes
        torch.cuda.empty_cache()

        # ------------------------------------------------------------ P8
        # (runs while P4's numpy reference is held, before P7)
        t0 = time.perf_counter()
        launches["P8"] = phase_p8(dev, path, tmp, qcodes, queries, ref_keys,
                                  ref_cnts, want_counts, smi)
        log(f"P8 seconds {time.perf_counter() - t0:.2f} [{smi}]")
        del ref_keys, ref_cnts
        torch.cuda.empty_cache()

        # ------------------------------------------------------------ P9
        t0 = time.perf_counter()
        launches["P9"] = phase_p9(dev, path, tmp, codes, quals, qcodes,
                                  queries, smi)
        log(f"P9 seconds {time.perf_counter() - t0:.2f} [{smi}]")
        torch.cuda.empty_cache()

        # ----------------------------------------------------------- P10
        t0 = time.perf_counter()
        launches["P10"] = phase_p10(dev, path, tmp, codes, qcodes, queries,
                                    want_counts, smi, canon=canon_all)
        del qcodes, canon_all
        torch.cuda.empty_cache()
        phase_p10p(dev, tmp / "p3.fastq",
                   make_reads(1_000_000, 80_000, seed=1), smi)
        log(f"P10 seconds {time.perf_counter() - t0:.2f} [{smi}]")
        torch.cuda.empty_cache()

        # ----------------------------------------------------------- P11
        p11 = phase_p11(tmp, path, tmp / "p3.fastq", queries, want_counts,
                        distinct, n_windows, smi)
        launches["P11"] = collections.Counter()
        for runs in p11:
            for ln in runs.values():
                launches["P11"].update(ln)
        del queries, want_counts

        # ------------------------------------------------------------ P7
        t0 = time.perf_counter()
        launches["P7"] = phase_p7(dev, path, codes, quals, smi)
        log(f"P7 seconds {time.perf_counter() - t0:.2f} [{smi}]")
        del codes, quals
        torch.cuda.empty_cache()

    # ----------------------------------------------------------------- P12
    launches["P12"] = phase_p12(dev, smi)

    log(f"total seconds {time.perf_counter() - t_all:.2f} [{smi}]")
    entries = []
    for kname, (src, replaces) in kernels.KERNELS.items():
        # main-path launches (P4 + ... + P11 — the P11 ranks' sum — + P12,
        # and per run); K2′'s and the one-run kernels' come from P12's
        # sortops calls
        by_run = {r: launches[r][kname] for r in (
            "P4", "P5", "P6", "P7", "P8", "P9", "P10", "P11", "P12")}
        n = sum(by_run.values())
        p11_by_rank = [sum(ln.get(kname, 0) for ln in runs.values())
                       for runs in p11]
        entries.append({"name": kname, "route": "cuda", "source": src,
                        "replaces": replaces, "launches": n,
                        "launches_by_run": by_run,
                        "p11_launches_by_rank": p11_by_rank,
                        **results[kname]})
    print(smi)
    print(json.dumps({"kernels": entries}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name,
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
