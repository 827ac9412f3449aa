"""The benchmark's harness: one run of one cell of ``BENCHMARK.json``.

A run sets up (generates the cell's reads from the seed and writes their
FASTQ under a fresh directory of ``TMPDIR``, then warms up every shape
the cell's traffic uses), measures the traffic's closed loop for the
given seconds, checks what the measured calls produced against the
plain reference, and returns the result line.

Everything that belongs to one configuration, traffic mix or metric is a
file found by its name:

* ``BENCHMARK.json`` binds a cell to a configuration and a mix;
* the configuration is the JSON file its entry names: the index class
  and its arguments, the reads' sizes, and the judge that checks it
  (``kbench/judge/<judge>.py``);
* the mix is ``kbench/traffic/<traffic>.json``: the name of its loop,
  that loop's parameters and, where the mix asks what the
  configuration's judge does not check, a ``judge`` of its own, which
  wins;
* the loop is ``kbench/loops/<loop>.py``: ``query_sets(mix)`` (the
  query sets the mix packs from held-out reads), ``drive(run)`` (set-up,
  warm-up and the measured window, inside `Run.measured`, each call into
  the program inside a range `Run.span` names), ``CHECK_CONTENTS``
  (whether the judge also checks the index's whole contents: the loop
  builds in its window), ``METHOD`` (the public index method its
  measured calls ask) and ``TINY`` (its mix parameters at a CPU test's
  size);
* each metric is ``kbench/metrics/<name>.py``, whose ``read(obs)``
  returns the metric's value from the run's `Observations`, or None
  where it finds nothing to read.

The traced window is bounded by the ranges the loop opened
(`Run.span`), whatever their names.
"""

from __future__ import annotations

import contextlib
import dataclasses
import gc
import importlib.util
import json
import os
import pathlib
import shutil
import subprocess
import sys
import tempfile
import time

import numpy as np
import torch

from . import data
from .trace import TraceView

ROOT = pathlib.Path(__file__).resolve().parent.parent
#: top-level module names that no run may load: the JAX package and JAX
FORBIDDEN_MODULES = frozenset({"jax", "jaxlib", "flax", "kmerind_tpu"})


def forbidden_modules() -> list[str]:
    """The loaded modules whose top-level name (before the first dot) is
    one of FORBIDDEN_MODULES, compared whole.  ``run.py`` asks last, after
    the judge and the metric readers, before it prints a result."""
    return sorted({m for m in sys.modules
                   if m.split(".", 1)[0] in FORBIDDEN_MODULES})


def process_age_s() -> float:
    """Seconds since this process started (Linux /proc), else since the
    harness was imported."""
    try:
        with open("/proc/self/stat") as f:
            start_ticks = int(f.read().rsplit(")", 1)[1].split()[19])
        with open("/proc/uptime") as f:
            uptime = float(f.read().split()[0])
        return uptime - start_ticks / os.sysconf("SC_CLK_TCK")
    except (OSError, ValueError, IndexError):
        return time.perf_counter() - _IMPORTED


_IMPORTED = time.perf_counter()


def _load_module(path: pathlib.Path, name: str):
    spec = importlib.util.spec_from_file_location(name, path)
    if spec is None or not path.is_file():
        raise FileNotFoundError(path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


class Bench:
    """The benchmark's definition under `root`: ``BENCHMARK.json`` and
    the files its names lead to."""

    def __init__(self, root: pathlib.Path | str = ROOT):
        self.root = pathlib.Path(root)
        self.spec = json.loads((self.root / "BENCHMARK.json").read_text())
        self.dir = self.root / "kbench"

    def _entry(self, key: str, name: str) -> dict:
        for e in self.spec[key]:
            if e["name"] == name:
                return e
        raise KeyError(f"no {key} entry named {name!r}")

    def workload(self, name: str) -> dict:
        return self._entry("workloads", name)

    def config(self, name: str) -> dict:
        return json.loads((self.root / self._entry("configs", name)["file"])
                          .read_text())

    def traffic(self, name: str) -> dict:
        return json.loads((self.dir / "traffic" / f"{name}.json").read_text())

    def metric(self, name: str):
        return _load_module(self.dir / "metrics" / f"{name}.py",
                            f"kbench_metric_{name}")

    def judge(self, name: str):
        return _load_module(self.dir / "judge" / f"{name}.py",
                            f"kbench_judge_{name}")

    def loop(self, name: str):
        return _load_module(self.dir / "loops" / f"{name}.py",
                            f"kbench_loop_{name}")

    def cell(self, workload: str, overrides: dict | None = None) -> "Cell":
        """The cell `workload` resolved: its entry, configuration, mix,
        loop, judge (the mix's, else the configuration's) and query
        sets.  `overrides` {"reads": {...}, "traffic": {...}} shrink it
        for the CPU tests."""
        entry = self.workload(workload)
        cfg = self.config(entry["config"])
        mix = self.traffic(entry["traffic"])
        overrides = overrides or {}
        cfg["reads"] = {**cfg["reads"], **overrides.get("reads", {})}
        mix = {**mix, **overrides.get("traffic", {})}
        loop = self.loop(mix["loop"])
        judge = self.judge(mix.get("judge", cfg["judge"]))
        return Cell(workload, entry, cfg, mix, loop, judge,
                    loop.query_sets(mix))

    def metrics_for(self, cell: str, kind: str) -> list[dict]:
        """The `kind` ("end_to_end" / "per_layer") metrics a cell reports:
        those that list it, or list no cells at all; a per-layer metric
        without a list goes with every cell that reports what it moves."""
        e2e = [m["name"] for m in self.metrics_for(cell, "end_to_end")] \
            if kind == "per_layer" else None
        out = []
        for m in self.spec[kind]:
            if "workloads" in m:
                if cell in m["workloads"]:
                    out.append(m)
            elif e2e is None or m["moves"] in e2e:
                out.append(m)
        return out


@dataclasses.dataclass
class Cell:
    """A cell of ``BENCHMARK.json`` with the files its names lead to."""

    name: str
    entry: dict
    cfg: dict
    mix: dict
    loop: object
    judge: object
    sets: dict

    @property
    def n_held(self) -> int:
        """Held-out reads the query sets take."""
        return max(hi for _, hi in self.sets.values())


@dataclasses.dataclass
class Inputs:
    """A run's reads: `codes` / `quals` went into the FASTQ at `path`;
    `held` are held-out reads of the same genome and error model."""

    k: int
    codes: np.ndarray
    quals: np.ndarray
    held: np.ndarray
    path: pathlib.Path | None
    record_bytes: int
    seq_offset: int

    @property
    def bases(self) -> int:
        return self.codes.size

    def windows(self) -> int:
        """k-windows of the FASTQ's reads: every one is a k-mer."""
        return self.codes.shape[0] * (self.codes.shape[1] - self.k + 1)


def make_inputs(cfg: dict, n_held: int, seed: int, tmpdir=None) -> Inputs:
    """Reads from the seed (the held-out ones drawn in the same call, after
    the FASTQ's), their phred scores, and the FASTQ of the first
    ``n_reads`` under `tmpdir` (none without one)."""
    r = cfg["reads"]
    seed = int(seed) % (1 << 63)
    codes = data.make_reads(r["genome_len"], r["n_reads"] + n_held, seed,
                            r["read_len"], r["sub_rate"], r["n_rate"])
    main, held = codes[:r["n_reads"]], codes[r["n_reads"]:]
    quals = data.make_quals(main, seed)
    path = None
    if tmpdir is not None:
        path = pathlib.Path(tmpdir) / "reads.fastq"
        data.write_fastq(main, quals, path)
    return Inputs(cfg["k"], main, quals, held, path,
                  data.record_bytes(r["read_len"]), data.SEQ_OFFSET)


@dataclasses.dataclass
class Window:
    """What the measured window did: every call's host-clock start and end
    (s, `time.perf_counter`) and its work (k-mers or queries), the
    process's CPU seconds in each call (all threads), and the answers the
    judge will check, each as (query set, answer)."""

    start: float = 0.0
    calls: list = dataclasses.field(default_factory=list)
    cpu_s: list = dataclasses.field(default_factory=list)
    answers: list = dataclasses.field(default_factory=list)

    @property
    def end(self) -> float:
        return self.calls[-1][1] if self.calls else self.start

    @property
    def work(self) -> int:
        return sum(w for _, _, w in self.calls)


@dataclasses.dataclass
class Observations:
    """What the metric readers read.  Over the measured window: `phases`,
    the seconds of each `PhaseTimer` phase (program_span); `counts`, the
    program's own counters (program_counter): {"phases": {phase: times
    entered}, "launches": {kernel wrapper: launches}
    (``ops.kernels.LAUNCHES``), "k2_payload_launches": {payload columns:
    K2 launches} (``ops.kernels.K2_PAYLOAD_LAUNCHES``)}; with tracing,
    `trace` and the K1 / K2 call shapes `kernel_calls` (device_trace)."""

    window: Window
    setup_s: float
    peak_bytes: int
    bases: int = 0
    trace: TraceView | None = None
    phases: dict = dataclasses.field(default_factory=dict)
    counts: dict = dataclasses.field(default_factory=dict)
    kernel_calls: dict = dataclasses.field(default_factory=dict)


class KernelCalls:
    """Records the shapes of the port's K1 and K2 calls on the card while
    installed, by wrapping the wrappers in ``ops.kernels`` (the callers
    look them up on the module)."""

    def __init__(self, kernels):
        self.kernels = kernels
        self.calls: dict = {"extract_canonical": [], "merge_runs_cols": []}
        self._saved: dict = {}

    def _wrap(self, name, shape_of):
        inner = getattr(self.kernels, name)

        def wrapper(*args):
            out = inner(*args)
            if args[0].device.type == "cuda":
                self.calls[name].append(shape_of(args, out))
            return out

        self._saved[name] = inner
        setattr(self.kernels, name, wrapper)

    def __enter__(self):
        self._wrap("extract_canonical",
                   lambda a, out: {"n": a[0].shape[0], "nwords": a[1].nwords})
        self._wrap("merge_runs_cols",
                   lambda a, out: {"na": a[0].shape[1], "nb": a[2].shape[1],
                                   "n_out": out[0].shape[1],
                                   "w": a[0].shape[0], "npay": len(a[1])})
        return self

    def __exit__(self, *exc):
        for name, fn in self._saved.items():
            setattr(self.kernels, name, fn)


class Run:
    """One run's state: the index factory, inputs, query rows, device, the
    names of the ranges the loop opened, and the measured window's bracket
    (peak memory, profiler, kernel calls, the program's counters)."""

    def __init__(self, cell: Cell, seed, seconds, trace, device):
        import kmerind_tpu_torch as kt
        from kmerind_tpu_torch.ops import kernels
        from kmerind_tpu_torch.utils.timers import PhaseTimer

        self.kt, self.kernels = kt, kernels
        self.cfg, self.mix = cell.cfg, cell.mix
        self.seed, self.seconds, self.trace = seed, seconds, trace
        self.device = torch.device(device)
        self.timer = PhaseTimer()
        self.window = Window()
        self.inputs: Inputs | None = None
        self.rows: dict = {}
        self.idx = None
        self.check_contents = bool(cell.loop.CHECK_CONTENTS)
        #: every range name `span` opened, in first-opened order
        self.range_names: list = []

    def make_index(self):
        cfg = self.cfg
        spec = self.kt.KmerSpec(cfg["k"], getattr(self.kt, cfg["alphabet"]))
        cls = getattr(self.kt, cfg["index"])
        return cls(spec, device=str(self.device), timer=self.timer,
                   **cfg.get("index_args", {}))

    def span(self, name: str):
        """A profiler range around one call into the program, when
        tracing; nothing otherwise.  The traced window is bounded by the
        ranges of the names opened here."""
        if name not in self.range_names:
            self.range_names.append(name)
        if not self.trace:
            return contextlib.nullcontext()
        return torch.profiler.record_function(name)

    def sync(self):
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def peak_bytes(self) -> int:
        if self.device.type != "cuda":
            return 0
        return int(torch.cuda.max_memory_allocated(self.device))

    def launch_counts(self) -> dict:
        """The port's launch counters as they stand."""
        return {"launches": dict(self.kernels.LAUNCHES),
                "k2_payload_launches": dict(self.kernels.K2_PAYLOAD_LAUNCHES)}

    @contextlib.contextmanager
    def measured(self):
        """The measured window: peak memory counted from its start, and the
        program's phases and counters over it; with tracing, the profiler
        and the kernel-call records run in it."""
        self.sync()
        gc.collect()
        self.setup_peak = self.peak_bytes()
        if self.device.type == "cuda":
            torch.cuda.reset_peak_memory_stats(self.device)
        self.timer.clear()
        launches = self.launch_counts()
        self.setup_s = process_age_s()
        with contextlib.ExitStack() as stack:
            if self.trace:
                self.calls = stack.enter_context(KernelCalls(self.kernels))
                acts = [torch.profiler.ProfilerActivity.CPU]
                if self.device.type == "cuda":
                    acts.append(torch.profiler.ProfilerActivity.CUDA)
                self.prof = stack.enter_context(
                    torch.profiler.profile(activities=acts))
            self.window.start = time.perf_counter()
            yield self.window
            self.sync()
        self.window_peak = self.peak_bytes()
        self.phases = {n: self.timer.total(n) for n in self.timer.durations}
        self.counts = {"phases": {n: self.timer.count(n)
                                  for n in self.timer.durations}}
        for key, now in self.launch_counts().items():
            self.counts[key] = {n: c - launches[key].get(n, 0)
                                for n, c in now.items()}


def _card_line() -> str:
    try:
        return subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=20).stdout.strip()
    except (OSError, subprocess.SubprocessError):
        return "nvidia-smi: not available"


def run_cell(workload: str, seed: int, seconds: float, trace: bool,
             device: str = "cuda", bench: Bench | None = None,
             overrides: dict | None = None, log=None) -> dict:
    """One run of a cell; returns the result line as a dict (its checks
    under "checks", last).  `overrides` as `Bench.cell` takes them."""
    log = log or (lambda msg: print(msg, file=sys.stderr, flush=True))
    bench = bench or Bench()
    cell = bench.cell(workload, overrides)
    cfg, sets, judge = cell.cfg, cell.sets, cell.judge
    run = Run(cell, seed, seconds, trace, device)
    tmpdir = tempfile.mkdtemp(prefix="kbench-")
    try:
        if trace and run.device.type == "cuda":
            # the profiler's own first start, outside the window
            with torch.profiler.profile(activities=[
                    torch.profiler.ProfilerActivity.CUDA]):
                torch.ones(1, device=run.device).add_(1)
                run.sync()
        run.inputs = make_inputs(cfg, cell.n_held, seed, tmpdir)
        for name, (lo, hi) in sets.items():
            run.rows[name] = data.pack_windows(run.inputs.held[lo:hi],
                                               cfg["k"], run.device)
        cell.loop.drive(run)
        win = run.window
        log(f"kbench: {workload} seed {seed}: setup {run.setup_s:.3f} s, "
            f"{len(win.calls)} calls in {win.end - win.start:.3f} s "
            "(wall / CPU s each): " + ", ".join(
                f"{t1 - t0:.4f}/{c:.4f}"
                for (t0, t1, _), c in zip(win.calls[:64], win.cpu_s)))
        obs = Observations(win, run.setup_s, run.window_peak,
                           bases=run.inputs.bases * len(win.calls),
                           phases=run.phases, counts=run.counts)
        if trace:
            path = pathlib.Path(tmpdir) / "trace.json"
            run.prof.export_chrome_trace(str(path))
            obs.trace = TraceView(json.loads(path.read_text()),
                                  run.range_names)
            obs.kernel_calls = run.calls.calls
        kind = "per_layer" if trace else "end_to_end"
        metrics = {}
        for m in bench.metrics_for(workload, kind):
            value = bench.metric(m["name"]).read(obs)
            if value is None:
                if kind == "end_to_end":
                    raise RuntimeError(f"end-to-end metric {m['name']} "
                                       "read nothing")
                continue
            metrics[m["name"]] = {"value": value, "unit": m["unit"]}
        dev = {"platform": "gpu" if run.device.type == "cuda" else "cpu",
               "kind": (torch.cuda.get_device_name(run.device)
                        if run.device.type == "cuda" else "cpu"),
               "count": cell.entry["chips"],
               "memory_peak_bytes": max(run.setup_peak, run.window_peak)}
        if trace:
            dev["busy_s"] = obs.trace.busy_us() / 1e6
            dev["window_s"] = obs.trace.window_us / 1e6
        result = {"correct": False, "attempted": len(win.calls), "failed": 0,
                  "metrics": metrics, "device": dev}
        if trace:
            result["breakdown"] = obs.trace.breakdown()
            obs.trace = None
        if run.device.type == "cuda":
            log(f"kbench: card {_card_line()}")
        # the judge: the program's outputs, then its state freed, then the
        # plain reference
        outputs = judge.collect(run.idx, run)
        run.idx = None
        win.answers = []
        if run.device.type == "cuda":
            torch.cuda.empty_cache()
        t0 = time.perf_counter()
        checks = judge.compare(outputs, run.inputs, sets, run.seed,
                               run.device)
        log(f"kbench: reference and comparison {time.perf_counter() - t0:.3f}"
            " s")
        result["correct"] = all(v <= lim for _, v, lim in checks)
        result["checks"] = {n: {"value": v, "limit": lim}
                            for n, v, lim in checks}
        for n, v, lim in checks:
            log(f"check {n} {v} limit {lim}")
        return result
    finally:
        run.idx = None
        shutil.rmtree(tmpdir, ignore_errors=True)
