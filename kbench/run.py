"""One run of one benchmark cell of the PyTorch / CUDA port on the card.

    python3 kbench/run.py --workload <cell> --seed <n> --seconds <s> \
        --trace <0|1>

Run from the root of a checkout.  Prints the result as one JSON object,
the last line of standard output, and each number the correctness check
compared beside its limit as the last lines of standard error.  Exits 2
and prints no result when there is no CUDA device or fewer than the cell
asks for; exits 3 with no result, naming them on standard error, when
the process holds JAX or the JAX package once the run (the window, the
metric readers and the judge) is over.  The program's kernel caches stay
in fixed directories inside the checkout (``kmerind_tpu_torch/_build``,
``native``, ``.kbench_cache``).
"""

from __future__ import annotations

import argparse
import json
import os
import pathlib
import sys

ROOT = pathlib.Path(__file__).resolve().parent.parent


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    cache = ROOT / ".kbench_cache"
    os.environ.setdefault("PYTORCH_KERNEL_CACHE_PATH", str(cache / "torch"))
    os.environ.setdefault("TRITON_CACHE_DIR", str(cache / "triton"))
    sys.path.insert(0, str(ROOT))
    import torch

    from kbench import harness

    chips = harness.Bench().workload(args.workload)["chips"]
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        print(f"kbench: {args.workload} needs {chips} CUDA device(s); "
              f"found {torch.cuda.device_count()}", file=sys.stderr)
        return 2
    result = harness.run_cell(args.workload, args.seed, args.seconds,
                              bool(args.trace))
    return emit(result)


def emit(result: dict) -> int:
    """The run's last step: prints `result` as the last line of standard
    output and returns 0, unless the process has loaded JAX or the JAX
    package; then it prints no result and returns 3."""
    from kbench import harness

    bad = harness.forbidden_modules()
    if bad:
        print(f"kbench: forbidden modules loaded: {', '.join(bad)}",
              file=sys.stderr, flush=True)
        return 3
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
