#!/usr/bin/env python3
"""Device-busy profile of the smoke's full-size run (chip_smoke.py P4).

    python3 tools/profile_p4.py [--coverage 30] [--genome 4641652]
                                [--trace trace.json]

Makes the P4 data of chip_smoke.py (150 bp reads at 30x coverage of a
random genome of E. coli K-12 length, seed 0, and 1M queries), then runs
the P4 phases twice, each time on a fresh CountIndex: build (the streaming
path above 64 MB), count() of the 1M queries twice, items(), compact().
The first pass runs without the profiler and gives each phase's wall
seconds; it also warms the native parser, the kernels and the allocator.
The second pass runs under torch.profiler, each phase in a record_function
range that ends in torch.cuda.synchronize().

Device busy for a phase is the union of the kernel, memcpy and memset
intervals of the trace that fall inside the phase's range, over the
range's length: device work that overlaps is counted once, so the share
cannot exceed 100 %.  Per phase the script prints the wall seconds of
both passes, busy seconds and share, and the device items that take the
most time; then the PhaseTimer report of the profiled pass; and last one
JSON object with all of it.  Every timing line carries the card's name
and power limit as nvidia-smi reports them.
"""

from __future__ import annotations

import argparse
import collections
import json
import pathlib
import subprocess
import sys
import tempfile
import time

import numpy as np

ROOT = pathlib.Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))

from chip_smoke import (COVERAGE, GENOME_LEN, K, READ_LEN,  # noqa: E402
                        make_reads, pack_rows, write_fastq)

DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
PHASES = ("build", "count1", "count2", "items", "compact")


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


def make_queries(codes: np.ndarray) -> np.ndarray:
    """The smoke's 1M queries: 900k read windows and 100k random k-mers."""
    rng = np.random.default_rng(2)
    r = rng.integers(0, codes.shape[0], 900_000)
    o = rng.integers(0, READ_LEN - K + 1, 900_000)
    qcodes = np.concatenate([
        codes[r[:, None], o[:, None] + np.arange(K)],
        rng.integers(0, 4, (100_000, K), dtype=np.uint8)])
    qcodes[qcodes == 4] = 0               # DNA encodes N as A
    return pack_rows(qcodes)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--coverage", type=int, default=COVERAGE)
    ap.add_argument("--genome", type=int, default=GENOME_LEN)
    ap.add_argument("--device", default="cuda",
                    help="torch device; cpu runs the script at no device "
                         "time (a dry run of the script itself)")
    ap.add_argument("--trace", help="also write the profiled pass's chrome "
                                    "trace to this path")
    args = ap.parse_args(argv)

    import torch
    from torch.profiler import ProfilerActivity, profile, record_function

    from kmerind_tpu_torch import DNA, CountIndex, KmerSpec
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

    with tempfile.TemporaryDirectory() as tmp:
        n_reads = args.genome * args.coverage // READ_LEN
        codes = make_reads(args.genome, n_reads, seed=0)
        path = pathlib.Path(tmp) / "p4.fastq"
        write_fastq(codes, path)
        queries = make_queries(codes)
        print(f"data: {n_reads} reads, {codes.size} bases, "
              f"{path.stat().st_size} bytes FASTQ [{smi}]", flush=True)
        del codes

        def steps(idx):
            return {"build": lambda: idx.build(path),
                    "count1": lambda: idx.count(queries),
                    "count2": lambda: idx.count(queries),
                    "items": idx.items,
                    "compact": idx.compact}

        wall = {}
        fns = steps(CountIndex(spec, device=dev))
        for name in PHASES:
            t0 = time.perf_counter()
            fns[name]()
            sync()
            wall[name] = time.perf_counter() - t0

        idx = CountIndex(spec, device=dev)
        fns = steps(idx)
        acts = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA]
                                         if on_gpu else [])
        with profile(activities=acts) as prof:
            for name in PHASES:
                with record_function(f"p4:{name}"):
                    fns[name]()
                    sync()
        trace_path = pathlib.Path(args.trace or pathlib.Path(tmp) / "t.json")
        prof.export_chrome_trace(str(trace_path))
        trace = json.loads(trace_path.read_text())

    ranges = {ev["name"][3:]: (float(ev["ts"]), float(ev["ts"] + ev["dur"]))
              for ev in trace["traceEvents"]
              if ev.get("cat") == "user_annotation"
              and str(ev.get("name", "")).startswith("p4:")}
    out = {"card": smi, "phases": {}}
    print("| phase | wall s | profiled wall s | device busy s | busy % "
          "| top device items (ms) |")
    print("| --- | --- | --- | --- | --- | --- |")
    for name in PHASES:
        lo, hi = ranges[name]
        spans, by_name = phase_device_items(trace, lo, hi)
        busy = union_length(spans) / 1e6
        span = (hi - lo) / 1e6
        top = [(n, us / 1e3) for n, us in by_name.most_common(5)]
        out["phases"][name] = {
            "wall_s": wall[name], "profiled_wall_s": span,
            "device_busy_s": busy, "busy_share": busy / span,
            "device_items": len(spans), "top_ms": top}
        tops = "; ".join(f"{n[:48]} {ms:.3f}" for n, ms in top)
        print(f"| {name} | {wall[name]:.6f} | {span:.6f} | {busy:.6f} | "
              f"{100 * busy / span:.2f} | {tops} |")
    print(f"card: {smi}")
    print(idx.timer.report("profiled"))
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    sys.exit(main())
