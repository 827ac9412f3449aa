#!/usr/bin/env python3
"""Smoke run of the PyTorch port's count-index main path on one NVIDIA GPU.

    python3 chip_smoke.py

Phases (each prints its seconds; every timing line carries the card's name
and power limit as nvidia-smi reports them):

* P0  device: nvidia-smi name/power limit and torch's device name.
* P1  build: nvcc compiles the three CUDA kernels of
      kmerind_tpu_torch/ops/csrc into kmerind_tpu_torch/_build.
* P2  every kernel against its plain PyTorch version on the card, at the
      main path's shapes; bitwise equality required; both timed with CUDA
      events (median of 5).
* P3  exact reference: ~12M bases of synthetic reads indexed through
      CountIndex.insert_batch in 2^20-base chunks with max_runs=2 (many K2
      merges), then compact(); to_dict() must equal an independent numpy
      canonical 21-mer counter.
* P4  full size, one bacterial sequencing run: reads at 30x coverage of a
      random genome of E. coli K-12 length (4,641,652 bp), 150 bp, half
      reverse-complemented, 0.5% substitutions, 0.1% N — about 139M bases,
      ~290 MB of FASTQ — built through CountIndex.build (the streaming
      path), 1M count() queries (900k read windows, 100k random k-mers)
      held exactly against a numpy count of all windows, items() (counts
      must sum to the window count), compact().  The kernel launch
      counters are zeroed just before and read just after: K1, K2 and K3
      must all have run.

Exits non-zero, printing no result, when there is no CUDA device, a build
fails or any check fails.  The last line of standard output is the
contract JSON; the line before it lists the kernels.
"""

from __future__ import annotations

import json
import pathlib
import statistics
import subprocess
import sys
import tempfile
import time

import numpy as np

K = 21
CHUNK = (1 << 23) + K - 1          # default_chunk_bases + the k-1 halo
GENOME_LEN = 4_641_652             # E. coli K-12 MG1655
READ_LEN = 150
COVERAGE = 30


def log(msg: str):
    print(msg, flush=True)


def median_ms(fn, reps: int = 5) -> float:
    """Median CUDA-event time of fn() over reps runs, after one warm-up."""
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


def write_fastq(codes: np.ndarray, path: pathlib.Path):
    """Fixed-width FASTQ records, written in one vectorized pass."""
    n = codes.shape[0]
    width = 10 + (READ_LEN + 1) + 2 + (READ_LEN + 1)
    rec = np.empty((n, width), np.uint8)
    rec[:, 0], rec[:, 1] = ord("@"), ord("r")
    ids = np.arange(n)
    for p in range(7):
        rec[:, 2 + p] = 48 + (ids // 10 ** (6 - p)) % 10
    s = 10 + READ_LEN
    rec[:, 9] = rec[:, s] = rec[:, s + 2] = rec[:, width - 1] = 10
    rec[:, 10:s] = np.frombuffer(b"ACGTN", np.uint8)[codes]
    rec[:, s + 1] = ord("+")
    rec[:, s + 3:width - 1] = ord("I")
    rec.tofile(path)


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


def expected_counts(codes: np.ndarray, qcodes: np.ndarray) -> np.ndarray:
    """Exact count of each query k-mer (rows of codes, canonicalised) among
    all windows of the reads, N read as A like the DNA alphabet does:
    numpy sort of every canonical window code + searchsorted."""
    blocks = []
    for lo in range(0, codes.shape[0], 100_000):
        blk = codes[lo:lo + 100_000].copy()
        blk[blk == 4] = 0
        blocks.append(canonical_codes(blk)[0].reshape(-1))
    allc = np.sort(np.concatenate(blocks))
    q = canonical_codes(qcodes)[0][:, 0]
    return (np.searchsorted(allc, q, "right")
            - np.searchsorted(allc, q, "left"))


def pack_rows(codes: np.ndarray) -> np.ndarray:
    """uint32[m, 2] k=21 DNA words (kmer.py layout) of [m, 21] codes."""
    c = codes.astype(np.uint64)
    w0 = np.zeros(codes.shape[0], np.uint64)
    for j in range(16):
        w0 = (w0 << np.uint64(2)) | c[:, j]
    w1 = np.zeros(codes.shape[0], np.uint64)
    for j in range(16, K):
        w1 = (w1 << np.uint64(2)) | c[:, j]
    return np.stack([w0, w1], axis=1).astype(np.uint32)


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, str(pathlib.Path(__file__).resolve().parent))
    from kmerind_tpu_torch import DNA, DNA16, CountIndex, KmerSpec
    from kmerind_tpu_torch.io import native, read_file, split_records_at_invalid
    from kmerind_tpu_torch.ops import kernels, packing, sortops

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

    def record(kname, case, ms, plain_ms, err):
        log(f"P2 {kname} {case}: kernel {ms:.4f} ms, plain {plain_ms:.4f} ms, "
            f"max_abs_err {err} [{smi}]")
        if err != 0:
            raise AssertionError(f"{kname} {case}: kernel != plain")
        results.setdefault(kname, (ms, plain_ms, err))

    def err_of(a, b):
        return int((a.to(torch.int64) - b.to(torch.int64)).abs().max())

    for spec in (KmerSpec(21, DNA), KmerSpec(63, DNA), KmerSpec(31, DNA16)):
        codes = torch.randint(0, spec.alphabet.size, (CHUNK,),
                              dtype=torch.uint8, device=dev, generator=gen)
        w, rc = kernels.extract_canonical(codes, spec)
        pw, prc = packing.extract_canonical(codes, spec)
        nv = CHUNK - spec.k + 1
        err = max(err_of(w[:nv], pw[:nv]), err_of(rc[:nv], prc[:nv]))
        record("extract_canonical", f"n={CHUNK} {spec}",
               median_ms(lambda: kernels.extract_canonical(codes, spec)),
               median_ms(lambda: packing.extract_canonical(codes, spec)), err)
        del w, rc, pw, prc

    def sorted_run(n):
        words = torch.randint(-(2**31), 2**31 - 1, (n, 2), dtype=torch.int32,
                              device=dev, generator=gen)
        words[:, 1] &= 0x3FF                  # k=21: 10-bit last word
        valid = torch.rand(n, device=dev, generator=gen) > 0.01
        return sortops.sort_rows(words, (), valid, sentinel_ok=True,
                                 as_cols=True)[0]

    for na, nb, npay in ((CHUNK, CHUNK, 0), (1 << 26, CHUNK, 0),
                         (CHUNK, CHUNK, 1)):
        a, b = sorted_run(na), sorted_run(nb)
        pa = tuple(torch.randint(0, 100, (na,), dtype=torch.int32, device=dev,
                                 generator=gen) for _ in range(npay))
        pb = tuple(torch.randint(0, 100, (nb,), dtype=torch.int32, device=dev,
                                 generator=gen) for _ in range(npay))
        gk, gp = kernels.merge_runs_cols(a, pa, b, pb)
        wk, wp = kernels.merge_runs_cols_plain(a, pa, b, pb)
        err = max([err_of(gk, wk)] + [err_of(x, y) for x, y in zip(gp, wp)])
        record("merge_runs_cols", f"{na}+{nb} w=2 payloads={npay}",
               median_ms(lambda: kernels.merge_runs_cols(a, pa, b, pb)),
               median_ms(lambda: kernels.merge_runs_cols_plain(a, pa, b, pb)),
               err)
        del a, b, pa, pb, gk, gp, wk, wp

    for hi in (2, 101):
        x = torch.randint(0, hi, (1 << 28,), dtype=torch.int32, device=dev,
                          generator=gen)
        err = err_of(kernels.prefix_sum_i32(x), kernels.prefix_sum_i32_plain(x))
        record("prefix_sum_i32", f"n=2^28 values 0..{hi - 1}",
               median_ms(lambda: kernels.prefix_sum_i32(x)),
               median_ms(lambda: kernels.prefix_sum_i32_plain(x)), err)
        del x
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    log(f"P2 seconds {time.perf_counter() - t0:.2f} [{smi}]")

    spec = KmerSpec(K, DNA)
    with tempfile.TemporaryDirectory() as tmp:
        tmp = pathlib.Path(tmp)

        # ------------------------------------------------------------ P3
        t0 = time.perf_counter()
        codes = make_reads(1_000_000, 80_000, seed=1)
        path = tmp / "p3.fastq"
        write_fastq(codes, path)
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
        del idx, batch, got, want, canon, has_n, uniq, cnt

        # ------------------------------------------------------------ P4
        t0 = time.perf_counter()
        n_reads = GENOME_LEN * COVERAGE // READ_LEN
        codes = make_reads(GENOME_LEN, n_reads, seed=0)
        path = tmp / "p4.fastq"
        write_fastq(codes, path)
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
        want_counts = expected_counts(codes, qcodes)
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
        launches = dict(kernels.LAUNCHES)
        peak = torch.cuda.max_memory_allocated()
        if idx.size() != rows.shape[0]:
            raise AssertionError("P4: compact() changed the distinct count")
        log(f"P4 items: {rows.shape[0]} distinct, count sum {int(cnts.sum())}"
            f" == windows, {items_s:.3f} s; compact {compact_s:.3f} s; "
            f"peak device memory {peak} bytes [{smi}]")
        log("P4 phases:\n" + idx.timer.report("P4"))
        log(f"P4 launches: {launches}")
        if launches["extract_canonical"] != idx.timer.count("insert"):
            raise AssertionError("P4: K1 launches != chunks")
        if launches["merge_runs_cols"] < idx.timer.count("merge"):
            raise AssertionError("P4: K2 launches < merges")
        if not all(launches.values()):
            raise AssertionError(f"P4: a kernel never ran: {launches}")

    log(f"total seconds {time.perf_counter() - t_all:.2f} [{smi}]")
    entries = []
    for kname, (src, replaces) in kernels.KERNELS.items():
        ms, plain_ms, err = results[kname]
        entries.append({"name": kname, "route": "cuda", "source": src,
                        "replaces": replaces, "launches": launches[kname],
                        "max_abs_err": err, "ms": ms, "plain_ms": plain_ms})
    print(smi)
    print(json.dumps({"kernels": entries}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name,
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
