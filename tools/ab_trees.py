#!/usr/bin/env python3
"""Time the K1, K2, K2′ and K4 kernels and the one-run bitonic merges of
two checkouts of the port on one GPU, in turns (A, B, B, A, ...).

    python3 tools/ab_trees.py A_DIR B_DIR [--pairs 1]

Each turn is one process with that checkout first on sys.path: it builds
the checkout's kernels, makes chip_smoke.py P2's main-path inputs (K1:
8,388,628 random DNA codes at k=21 and at k=127, the wide kernel; K2: two
sorted runs of 8,388,628 rows, w=2, with 0 and 1 payloads, the multimap
flush's 2^26 + 2^24 rows with 3 payloads at w=2 and w=3, and 2^22 + 2^22
rows of 33 words (a flag and 32) with 4 payloads; K2′: the row-major runs, w=2, 1
payload; K4: the sorted canonical 21-mers of one chunk of reads, w=2;
the one-run merges: P2's [2^24, 2] bitonic run with 1 payload through the
public `sortops.bitonic_merge` / `bitonic_merge_cols`) and
times the checkout's own wrappers with this
tree's chip_smoke.median_ms (CUDA events over many launches) and
chip_smoke.kernel_us_per_call (the profiler's device time per call), so
both sides are timed the same way whatever their own chip_smoke does.
Prints one line per turn and case, each with the card's name and power
limit, then one JSON object of all the times.
"""

from __future__ import annotations

import argparse
import importlib.util
import json
import pathlib
import subprocess
import sys

ROOT = pathlib.Path(__file__).resolve().parent.parent


def turn_order(pairs: int) -> list:
    """Which side runs in each turn: A B B A, repeated `pairs` times."""
    return ["A", "B", "B", "A"] * pairs


def _chip_smoke():
    """This tree's chip_smoke.py, loaded by path (the checkout under test
    stays first on sys.path for the port's package)."""
    spec = importlib.util.spec_from_file_location("ab_chip_smoke",
                                                  ROOT / "chip_smoke.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def run_turn(tree: str) -> dict:
    """Time the checkout `tree`'s K1 and K4 wrappers; {case: times}."""
    sys.path.insert(0, str(pathlib.Path(tree).resolve()))
    cs = _chip_smoke()
    import torch
    from kmerind_tpu_torch import DNA, KmerSpec
    from kmerind_tpu_torch.ops import kernels, sortops
    kernels.build()
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(0)
    spec = KmerSpec(cs.K, DNA)
    codes = torch.randint(0, 4, (cs.CHUNK,), dtype=torch.uint8, device=dev,
                          generator=gen)
    rcodes = cs.make_reads(cs.GENOME_LEN, cs.CHUNK // cs.READ_LEN + 1,
                           seed=5).reshape(-1)[:cs.CHUNK].copy()
    rcodes[rcodes == 4] = 0
    words, _ = kernels.extract_canonical(torch.from_numpy(rcodes).to(dev),
                                         spec)
    kcols, _, s_valid = sortops.sort_rows(
        words, (), torch.arange(cs.CHUNK, device=dev) <= cs.CHUNK - cs.K,
        is_stable=False, sentinel_ok=True, as_cols=True)
    tv = s_valid.sum(dtype=torch.int32)
    wide = KmerSpec(127, DNA)
    cases = {
        f"extract_canonical n={cs.CHUNK} k=21 DNA":
            lambda: kernels.extract_canonical(codes, spec),
        f"extract_canonical n={cs.CHUNK} k=127 DNA":
            lambda: kernels.extract_canonical(codes, wide),
        f"run_length_weights n={cs.CHUNK} sorted canonical 21-mers":
            lambda: kernels.run_length_weights(kcols, tv)}

    def sorted_run(n, flagged=False, w=2):
        words = torch.randint(-(2**31), 2**31 - 1, (n, w), dtype=torch.int32,
                              device=dev, generator=gen)
        valid = torch.rand(n, device=dev, generator=gen) > 0.01
        cols, _, s_valid = sortops.sort_rows(words, (), valid,
                                             sentinel_ok=not flagged,
                                             as_cols=True)
        if flagged:
            cols = torch.cat([(~s_valid).to(torch.int32)[None], cols])
        return cols

    def pays(n, npay):
        return tuple(torch.randint(0, 100, (n,), dtype=torch.int32,
                                   device=dev, generator=gen)
                     for _ in range(npay))

    runs = {}
    for label, na, nb, npay, flagged, w in (
            (f"{cs.CHUNK}+{cs.CHUNK} w=2", cs.CHUNK, cs.CHUNK, 0, False, 2),
            (f"{cs.CHUNK}+{cs.CHUNK} w=2 payloads=1", cs.CHUNK, cs.CHUNK, 1,
             False, 2),
            ("2^26+2^24 w=2 payloads=3", 1 << 26, 1 << 24, 3, False, 2),
            ("2^26+2^24 w=3 flagged payloads=3", 1 << 26, 1 << 24, 3, True,
             2),
            ("2^22+2^22 w=33 flagged payloads=4", 1 << 22, 1 << 22, 4, True,
             32)):
        runs[label] = (sorted_run(na, flagged, w), pays(na, npay),
                       sorted_run(nb, flagged, w), pays(nb, npay))
        cases[f"merge_runs_cols {label}"] = (
            lambda r=runs[label]: kernels.merge_runs_cols(*r))
    rows = (sorted_run(cs.CHUNK).t().contiguous(), pays(cs.CHUNK, 1),
            sorted_run(cs.CHUNK).t().contiguous(), pays(cs.CHUNK, 1))
    cases[f"merge_sorted_runs {cs.CHUNK}+{cs.CHUNK} w=2 payloads=1"] = (
        lambda: kernels.merge_sorted_runs(*rows))
    half = sorted_run(1 << 23).t().contiguous()
    keys = torch.cat([half, sorted_run(1 << 23).t().flip(0)])
    bcols, pay = keys.t().contiguous(), pays(1 << 24, 1)
    cases["sortops.bitonic_merge [2^24, 2] payloads=1"] = (
        lambda: sortops.bitonic_merge(keys, pay))
    cases["sortops.bitonic_merge_cols [2^24, 2] payloads=1"] = (
        lambda: sortops.bitonic_merge_cols(bcols, pay))
    return {case: {"ms": cs.median_ms(fn), "device_ms": sum(
        cs.kernel_us_per_call(fn).values()) / 1e3}
        for case, fn in cases.items()}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("a", nargs="?")
    ap.add_argument("b", nargs="?")
    ap.add_argument("--pairs", type=int, default=1)
    ap.add_argument("--turn", help=argparse.SUPPRESS)
    args = ap.parse_args(argv)
    if args.turn:
        print(json.dumps(run_turn(args.turn)))
        return 0
    if not (args.a and args.b):
        ap.error("give two checkouts, A_DIR and B_DIR")
    import torch
    if not torch.cuda.is_available():
        print("ab_trees: no CUDA device", file=sys.stderr)
        return 2
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip().splitlines()[0]
    trees = {"A": args.a, "B": args.b}
    times = {}
    for i, side in enumerate(turn_order(args.pairs)):
        out = subprocess.run(
            [sys.executable, __file__, "--turn", trees[side]],
            capture_output=True, text=True, check=True)
        for case, t in json.loads(out.stdout.strip().splitlines()[-1]).items():
            times.setdefault(f"{side} | {case}", []).append(t)
            print(f"turn {i} {side} ({trees[side]}) {case}: {t['ms']:.4f} ms, "
                  f"device {t['device_ms']:.4f} ms [{smi}]", flush=True)
    print(json.dumps({"card": smi, "trees": trees, "times": times}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
