"""The correctness check's control: the plain reference put in the
program's place at a lower precision (the judge's `control`), judged as
a run's outputs are, at the cell's own size.  It has to come out not
correct: one of the cell's numbers beyond its limit.

    python3 kbench/control.py --workload <cell> --seeds 1 2 3 [--device cuda]

Prints one line per seed: the numbers compared, each with its limit, and
whether the control was caught.  The benchmark's runs never run it.
"""

from __future__ import annotations

import argparse
import json
import pathlib
import sys

ROOT = pathlib.Path(__file__).resolve().parent.parent


def control_checks(workload: str, seed: int, device: str, bench=None,
                   overrides: dict | None = None) -> list:
    """(name, value, limit) of the control of `workload` on `seed`."""
    import torch

    from kbench import harness
    cell = (bench or harness.Bench()).cell(workload, overrides)
    inputs = harness.make_inputs(cell.cfg, cell.n_held, seed)
    dev = torch.device(device)
    outputs = cell.judge.control(inputs, cell.sets, cell.loop.CHECK_CONTENTS,
                                 dev, seed)
    return cell.judge.compare(outputs, inputs, cell.sets, seed, dev)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    sys.path.insert(0, str(ROOT))
    caught = True
    for seed in args.seeds:
        checks = control_checks(args.workload, seed, args.device)
        failed = [n for n, v, lim in checks if v > lim]
        caught &= bool(failed)
        print(json.dumps({"workload": args.workload, "seed": seed,
                          "caught": bool(failed), "checks": {
                              n: {"value": v, "limit": lim}
                              for n, v, lim in checks}}), flush=True)
    return 0 if caught else 1


if __name__ == "__main__":
    sys.exit(main())
