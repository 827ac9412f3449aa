#!/usr/bin/env python3
"""Device-busy profile of the smoke's full-size runs (chip_smoke.py P4-P10).

    python3 tools/profile_p4.py [--run p4|p5|p6|p7|p8|p9|p10|all]
                                [--coverage 30]
                                [--genome 4641652] [--trace trace.json]

Makes the P4 data of chip_smoke.py (150 bp reads at 30x coverage of a
random genome of E. coli K-12 length, seed 0, with its qualities, and 1M
queries), then runs
each run's phases twice, each time on a fresh index.  P4, the hash
CountIndex: build (the streaming path above 64 MB), count() of the 1M
queries twice, items(), compact().  P5, the sorted SortedCountIndex on one
shard: build, flush (the first size(), which runs the samplesort flush),
count() twice.  P6, the PositionQualityIndex (canonical, one shard):
insert (the build, whose chunks flush into the store every 2^24 pending
rows), merge (the first size(), which flushes the last pending rows),
find(with_quality=True) of the 1M queries twice.  P7, the hash CountIndex
at k = 127 (K1's wide kernel, K2 at 8 key words; max_runs=8): build,
count() of 1M 127-mer queries twice, items().  P8, the hash CountIndex's
surface: build, histogram(255), insert_counts of 1M pairs (the first 500k
queries, 500k random k-mers; counts 1-1000), count() of the 1M queries,
erase of the last 500k queries, size(), filter(c >= 2), count_if(c >= 36)
and an npz save.  P9, the de Bruijn graph (k = 21, max_runs=8): build,
node_counts() of the 1M queries twice (the first builds the runs' counter
tables), size() (the consolidating merges), compact(); beside these
phases each of the graph's own timer phases (among them insert, merge,
table, query, compact; under the profiler every PhaseTimer phase is a
"kmerind/<phase>" range) gets a second table, which sums the device busy
time over each one's ranges inside the run's ranges.  P10, the
BimoleculeCountIndex (one shard): build (its chunks flush into the store
every 2^24 pending rows: K3 per adopted run, K2 with 4 payloads per
merge), flush (the first size(), which merges the last pending runs),
count() of the 1M queries twice, items() (the stored orientations),
compact(); its own timer phases (insert, merge, compact, count, ...)
get the second table too.  The profiler records only
the ranges of the main thread: read and marshal run on the feeding thread
while the build streams (their walls are in the PhaseTimer report).  The
first pass runs
without the profiler and gives each
phase's wall seconds; it also warms the native parser, the kernels and the
allocator.  The second pass runs under torch.profiler, each phase in a
record_function range that ends in torch.cuda.synchronize().

Device busy for a phase is the union of the kernel, memcpy and memset
intervals of the trace that fall inside the phase's range, over the
range's length: device work that overlaps is counted once, so the share
cannot exceed 100 %.  Per phase the script prints the wall seconds of
both passes, busy seconds and share, the device items that take the
most time and the device milliseconds of each of the port's kernels; then the PhaseTimer report of the profiled pass; and last one
JSON object with all of it.  Every timing line carries the card's name
and power limit as nvidia-smi reports them.  With --trace, each run's
chrome trace goes to the path with the run's name before the suffix.
"""

from __future__ import annotations

import argparse
import collections
import json
import pathlib
import re
import subprocess
import sys
import tempfile
import time

import numpy as np

ROOT = pathlib.Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))

from chip_smoke import (COVERAGE, GENOME_LEN, K, K_WIDE,  # noqa: E402
                        READ_LEN, make_quals, make_reads, pack_rows,
                        write_fastq)
from kmerind_tpu_torch.utils.timers import RANGE_PREFIX  # noqa: E402

DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
#: run -> its phases, in order
PHASES = {"p4": ("build", "count1", "count2", "items", "compact"),
          "p5": ("build", "flush", "count1", "count2"),
          "p6": ("insert", "merge", "find1", "find2"),
          "p7": ("build", "count1", "count2", "items"),
          "p8": ("build", "histogram", "insert_counts", "count", "erase",
                 "size", "filter", "count_if", "save"),
          "p9": ("build", "query1", "query2", "size", "compact"),
          "p10": ("build", "flush", "count1", "count2", "items", "compact")}
#: run -> its k
RUN_K = {"p4": K, "p5": K, "p6": K, "p7": K_WIDE, "p8": K, "p9": K,
         "p10": K}
#: runs whose index's own timer phases get a table (`inner_report`)
INNER = ("p9", "p10")
#: the port's kernels -> the CUDA kernel names (ops/csrc) of their launches
PORT_KERNELS = {
    "extract_canonical": ("extract_rolling_kernel", "extract_wide_kernel"),
    "merge_runs_cols": ("merge_partition_kernel", "merge_tiles_kernel"),
    "prefix_sum_i32": ("prefix_scan_kernel",),
    "run_length_weights": ("rl_tiles", "rl_carry"),
    "run_count_lookup": ("run_count_lookup_kernel",),
    "run_vec_lookup": ("run_vec_lookup_kernel",),
    "position_ids": ("position_ids_kernel",),
    "bimol_min_rep": ("min_rep_scan_kernel", "min_rep_fill_kernel"),
}


def phase_steps(run: str, idx, path, queries) -> dict:
    """{phase: call} of one run on a fresh index `idx`."""
    if run == "p4":
        return {"build": lambda: idx.build(path),
                "count1": lambda: idx.count(queries),
                "count2": lambda: idx.count(queries),
                "items": idx.items,
                "compact": idx.compact}
    if run == "p7":
        return {"build": lambda: idx.build(path),
                "count1": lambda: idx.count(queries),
                "count2": lambda: idx.count(queries),
                "items": idx.items}
    if run == "p8":
        rng = np.random.default_rng(8)
        half = queries.shape[0] // 2
        pairs = np.concatenate([queries[:half], pack_rows(rng.integers(
            0, 4, (half, RUN_K[run]), dtype=np.uint8))])
        counts = rng.integers(1, 1001, pairs.shape[0])
        return {"build": lambda: idx.build(path),
                "histogram": lambda: idx.histogram(255),
                "insert_counts": lambda: idx.insert_counts(pairs, counts),
                "count": lambda: idx.count(queries),
                "erase": lambda: idx.erase(queries[half:]),
                "size": idx.size,
                "filter": lambda: idx.filter(lambda k, c: c >= 2),
                "count_if": lambda: idx.count_if(lambda k, c: c >= 36),
                "save": lambda: idx.save(pathlib.Path(path).with_name(
                    "p8.npz"))}
    if run == "p9":
        return {"build": lambda: idx.build(path),
                "query1": lambda: idx.node_counts(queries),
                "query2": lambda: idx.node_counts(queries),
                "size": idx.size,
                "compact": idx.compact}
    if run == "p10":
        return {"build": lambda: idx.build(path),
                "flush": idx.size,
                "count1": lambda: idx.count(queries),
                "count2": lambda: idx.count(queries),
                "items": idx.items,
                "compact": idx.compact}
    if run == "p6":
        return {"insert": lambda: idx.build(path),
                "merge": idx.size,
                "find1": lambda: idx.find(queries, with_quality=True),
                "find2": lambda: idx.find(queries, with_quality=True)}
    return {"build": lambda: idx.build(path),
            "flush": idx.size,
            "count1": lambda: idx.count(queries),
            "count2": lambda: idx.count(queries)}


def union_length(intervals) -> float:
    """Total length covered by [start, end) intervals, overlaps once."""
    total, reach = 0.0, float("-inf")
    for s, e in sorted(intervals):
        if e <= reach:
            continue
        total += e - max(s, reach)
        reach = e
    return total


def phase_device_items(trace: dict, lo: float, hi: float):
    """(device intervals clipped to [lo, hi), {name: device us}) in us."""
    spans, by_name = [], collections.Counter()
    for ev in trace["traceEvents"]:
        if ev.get("cat") not in DEVICE_CATS or "dur" not in ev:
            continue
        s, e = float(ev["ts"]), float(ev["ts"]) + float(ev["dur"])
        s, e = max(s, lo), min(e, hi)
        if e > s:
            spans.append((s, e))
            by_name[ev.get("name", "?")] += e - s
    return spans, by_name


def port_kernel_ms(by_name) -> dict:
    """{port kernel: device ms} from `phase_device_items`' {name: us}; a
    trace name matches when it holds a CUDA kernel's name as a word."""
    return {k: sum(us for n, us in by_name.items()
                   if any(re.search(rf"\b{c}\b", n) for c in cuda)) / 1e3
            for k, cuda in PORT_KERNELS.items()}


def make_queries(codes: np.ndarray, k: int = K) -> np.ndarray:
    """The smoke's 1M queries: 900k read windows and 100k random k-mers."""
    rng = np.random.default_rng(2)
    r = rng.integers(0, codes.shape[0], 900_000)
    o = rng.integers(0, READ_LEN - k + 1, 900_000)
    qcodes = np.concatenate([
        codes[r[:, None], o[:, None] + np.arange(k)],
        rng.integers(0, 4, (100_000, k), dtype=np.uint8)])
    qcodes[qcodes == 4] = 0               # DNA encodes N as A
    return pack_rows(qcodes)


def report(run: str, trace: dict, wall: dict, smi: str) -> dict:
    """Print one run's table of phases; returns its JSON record."""
    tag = f"{run}:"
    ranges = {ev["name"][len(tag):]: (float(ev["ts"]),
                                     float(ev["ts"] + ev["dur"]))
              for ev in trace["traceEvents"]
              if ev.get("cat") == "user_annotation"
              and str(ev.get("name", "")).startswith(tag)}
    out = {}
    print(f"{run.upper()} [{smi}]")
    print("| phase | wall s | profiled wall s | device busy s | busy % "
          "| top device items (ms) | port kernels (ms) |")
    print("| --- | --- | --- | --- | --- | --- | --- |")
    for name in PHASES[run]:
        lo, hi = ranges[name]
        spans, by_name = phase_device_items(trace, lo, hi)
        busy = union_length(spans) / 1e6
        span = (hi - lo) / 1e6
        top = [(n, us / 1e3) for n, us in by_name.most_common(5)]
        ours = port_kernel_ms(by_name)
        out[name] = {
            "wall_s": wall[name], "profiled_wall_s": span,
            "device_busy_s": busy, "busy_share": busy / span,
            "device_items": len(spans), "top_ms": top, "port_kernel_ms": ours}
        tops = "; ".join(f"{n[:48]} {ms:.3f}" for n, ms in top)
        kms = "; ".join(f"{k} {ms:.3f}" for k, ms in ours.items() if ms)
        print(f"| {name} | {wall[name]:.6f} | {span:.6f} | {busy:.6f} | "
              f"{100 * busy / span:.2f} | {tops} | {kms} |")
    return out


def inner_report(run: str, trace: dict, smi: str) -> dict:
    """Print and return the device busy time of the index's own phases
    (the "kmerind/<phase>" ranges its PhaseTimer opens under the profiler)
    inside the run's "<run>:<name>" ranges, summed over each phase's
    ranges."""
    ranges = [(ev["ts"], ev["ts"] + ev["dur"]) for ev in trace["traceEvents"]
              if ev.get("cat") == "user_annotation"
              and str(ev.get("name", "")).startswith(f"{run}:")]
    spans = collections.defaultdict(list)
    for ev in trace["traceEvents"]:
        name = str(ev.get("name", ""))
        if ev.get("cat") == "user_annotation" \
                and name.startswith(RANGE_PREFIX) \
                and any(lo <= ev["ts"] < hi for lo, hi in ranges):
            spans[name[len(RANGE_PREFIX):]].append(
                (float(ev["ts"]), float(ev["ts"] + ev["dur"])))
    out = {}
    print(f"{run.upper()} index phases [{smi}]")
    print("| phase | ranges | range s | device busy s | busy % | port "
          "kernels (ms) |")
    print("| --- | --- | --- | --- | --- | --- |")
    for name, ranges in spans.items():
        busy = span = 0.0
        ours = collections.Counter()
        for lo, hi in ranges:
            items, by_name = phase_device_items(trace, lo, hi)
            busy += union_length(items) / 1e6
            span += (hi - lo) / 1e6
            ours.update(port_kernel_ms(by_name))
        out[name] = {"ranges": len(ranges), "range_s": span,
                     "device_busy_s": busy,
                     "busy_share": busy / span if span else 0.0,
                     "port_kernel_ms": dict(ours)}
        kms = "; ".join(f"{k} {ms:.3f}" for k, ms in ours.items() if ms)
        print(f"| {name} | {len(ranges)} | {span:.6f} | {busy:.6f} | "
              f"{100 * busy / span if span else 0.0:.2f} | {kms} |")
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--run", choices=(*PHASES, "all"), default="all")
    ap.add_argument("--coverage", type=int, default=COVERAGE)
    ap.add_argument("--genome", type=int, default=GENOME_LEN)
    ap.add_argument("--device", default="cuda",
                    help="torch device; cpu runs the script at no device "
                         "time (a dry run of the script itself)")
    ap.add_argument("--trace", help="also write each run's chrome trace to "
                                    "this path, the run's name added")
    args = ap.parse_args(argv)

    import torch
    from torch.profiler import ProfilerActivity, profile, record_function

    from kmerind_tpu_torch import (DNA, BimoleculeCountIndex, CountIndex,
                                   DeBruijnGraph, KmerSpec,
                                   PositionQualityIndex, SortedCountIndex)
    from kmerind_tpu_torch.io import native

    dev = torch.device(args.device)
    on_gpu = dev.type == "cuda"
    if on_gpu and not torch.cuda.is_available():
        print("profile_p4: no CUDA device", file=sys.stderr)
        return 2
    if on_gpu:
        smi = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            check=True, timeout=60).stdout.strip().splitlines()[0]
        sync = torch.cuda.synchronize
    else:
        smi, sync = "cpu", (lambda: None)
    native.require()
    spec = KmerSpec(K, DNA)
    runs = tuple(PHASES) if args.run == "all" else (args.run,)
    make_index = {"p4": lambda: CountIndex(spec, device=dev),
                  "p5": lambda: SortedCountIndex(spec, device=dev),
                  "p6": lambda: PositionQualityIndex(spec, device=dev,
                                                     canonical=True),
                  "p7": lambda: CountIndex(KmerSpec(K_WIDE, DNA),
                                           device=dev, max_runs=8),
                  "p8": lambda: CountIndex(spec, device=dev),
                  "p9": lambda: DeBruijnGraph(spec, device=dev, max_runs=8),
                  "p10": lambda: BimoleculeCountIndex(spec, device=dev)}
    acts = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA]
                                     if on_gpu else [])
    out = {"card": smi, "runs": {}}

    with tempfile.TemporaryDirectory() as tmp:
        n_reads = args.genome * args.coverage // READ_LEN
        codes = make_reads(args.genome, n_reads, seed=0)
        path = pathlib.Path(tmp) / "p4.fastq"
        write_fastq(codes, make_quals(codes, seed=0), path)
        queries = {k: make_queries(codes, k)
                   for k in sorted({RUN_K[run] for run in runs})}
        print(f"data: {n_reads} reads, {codes.size} bases, "
              f"{path.stat().st_size} bytes FASTQ [{smi}]", flush=True)
        del codes

        for run in runs:
            wall = {}
            fns = phase_steps(run, make_index[run](), path,
                              queries[RUN_K[run]])
            for name in PHASES[run]:
                t0 = time.perf_counter()
                fns[name]()
                sync()
                wall[name] = time.perf_counter() - t0
            del fns

            idx = make_index[run]()
            fns = phase_steps(run, idx, path, queries[RUN_K[run]])
            with profile(activities=acts) as prof:
                for name in PHASES[run]:
                    with record_function(f"{run}:{name}"):
                        fns[name]()
                        sync()
            if args.trace:
                tp = pathlib.Path(args.trace)
                trace_path = tp.with_name(f"{tp.stem}_{run}{tp.suffix}")
            else:
                trace_path = pathlib.Path(tmp) / f"{run}.json"
            prof.export_chrome_trace(str(trace_path))
            trace = json.loads(trace_path.read_text())
            out["runs"][run] = report(run, trace, wall, smi)
            if run in INNER:
                out["runs"][f"{run} index phases"] = inner_report(run, trace,
                                                                  smi)
            print(idx.timer.report(f"{run} profiled"))
            del fns, idx, prof, trace
            if on_gpu:
                torch.cuda.empty_cache()
    print(f"card: {smi}")
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    sys.exit(main())
