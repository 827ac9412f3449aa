#!/usr/bin/env python3
"""Device-busy profile of the headline bench's timed iterations
(`kmerind_tpu_torch.bench.headline`, the modes of chip_smoke.py P12).

    python3 tools/profile_headline.py [--modes e2e,debruijn,...]
                                      [--device cuda] [headline flags ...]

Every flag it does not know goes to the bench (e.g. --bases, --k,
--chunks); each mode runs with --iters 1 and a pinned baseline of 1 (no
numpy baseline).  Per mode: one run without the profiler (the kernels'
build, the allocator's warm-up), then one under torch.profiler, whose
timed iteration is the bench's `ITER_RANGE` profiler range.  For that
range the script prints its wall seconds, the device-busy seconds and
share (the union of the kernel, memcpy and memset intervals inside it,
`profile_p4.union_length`: overlapping work counts once), the device
items that take the most time (by kernel name, its template arguments
dropped: `short_name`) and the device milliseconds of each of the port's
kernels; then one JSON object with all of it.  Every line carries
the card's name and power limit as nvidia-smi reports them.
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

ROOT = pathlib.Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))
sys.path.insert(0, str(ROOT / "tools"))

from profile_p4 import (phase_device_items, port_kernel_ms,  # noqa: E402
                        union_length)


def short_name(name: str) -> str:
    """A device item's name without its return type, namespaces, template
    arguments and parameters ("void at::native::foo<...>(...)" -> "foo")."""
    name = re.sub(r"^void ", "", name.replace("(anonymous namespace)", "_"))
    head = re.split(r"[<(]", name, maxsplit=1)[0]
    return head.split("::")[-1].strip() or name


def iter_range(trace: dict, name: str) -> tuple[float, float]:
    """(start, end) in us of the last profiler range called `name`."""
    spans = [(float(ev["ts"]), float(ev["ts"]) + float(ev["dur"]))
             for ev in trace["traceEvents"]
             if ev.get("cat") == "user_annotation"
             and ev.get("name") == name]
    if not spans:
        raise ValueError(f"no {name!r} range in the trace")
    return max(spans)


def main(argv=None) -> int:
    from kmerind_tpu_torch.bench import headline
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--modes", default=",".join(headline.UNITS))
    ap.add_argument("--device", default="cuda")
    args, bench_flags = ap.parse_known_args(argv)

    import torch
    from torch.profiler import ProfilerActivity, profile

    on_gpu = torch.device(args.device).type == "cuda"
    if on_gpu and not torch.cuda.is_available():
        print("profile_headline: no CUDA device", file=sys.stderr)
        return 2
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip().splitlines()[0] \
        if on_gpu else "cpu"
    acts = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA]
                                     if on_gpu else [])
    out = {"card": smi, "modes": {}}
    print("| mode | iteration wall s | device busy s | busy % | top device "
          "items (ms) | port kernels (ms) |")
    print("| --- | --- | --- | --- | --- | --- |")
    with tempfile.TemporaryDirectory() as tmp:
        for mode in args.modes.split(","):
            hargs = headline.parse_args(
                ["--mode", mode, "--device", args.device, *bench_flags,
                 "--iters", "1", "--json-only", "--pinned-baseline", "1"])
            headline.MODES[mode](headline.Context.create(hargs))
            with profile(activities=acts) as prof:
                headline.MODES[mode](headline.Context.create(hargs))
            path = pathlib.Path(tmp) / f"{mode}.json"
            prof.export_chrome_trace(str(path))
            trace = json.loads(path.read_text())
            lo, hi = iter_range(trace, headline.ITER_RANGE)
            spans, by_name = phase_device_items(trace, lo, hi)
            busy, span = union_length(spans) / 1e6, (hi - lo) / 1e6
            by_short = collections.Counter()
            for n, us in by_name.items():
                by_short[short_name(n)] += us
            top = [(n, us / 1e3) for n, us in by_short.most_common(6)]
            ours = port_kernel_ms(by_name)
            out["modes"][mode] = {
                "wall_s": span, "device_busy_s": busy,
                "busy_share": busy / span, "device_items": len(spans),
                "top_ms": top, "port_kernel_ms": ours}
            tops = "; ".join(f"{n} {ms:.3f}" for n, ms in top)
            kms = "; ".join(f"{k} {ms:.3f}" for k, ms in ours.items() if ms)
            print(f"| {mode} | {span:.6f} | {busy:.6f} | "
                  f"{100 * busy / span:.2f} | {tops} | {kms} | [{smi}]",
                  flush=True)
            del prof, trace
            if on_gpu:
                torch.cuda.empty_cache()
    print(f"card: {smi}")
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    sys.exit(main())
