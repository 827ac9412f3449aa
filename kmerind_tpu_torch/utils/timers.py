"""Phase timers — the observability layer.

The port of ``kmerind_tpu.utils.timers``: `PhaseTimer`, after the
reference's BL_TIMER/BL_BENCH macros (src/utils/timer.hpp:398-431): named
per-phase wall-clock sections accumulated per process and reported with
min/max/mean/stdev statistics in the reference's ``[TIME]`` CSV format,
per process or over the ranks of a process group (`cross_host_stats`);
`MemUsage`, host RSS marks (plog::MemUsage); and `device_memory_stats`,
the CUDA caching allocator's counters.  A phase measures host wall-clock
time; work a phase only enqueues on the device is not in it unless the
phase ends in a synchronising call.
"""

from __future__ import annotations

import contextlib
import statistics
import time

import torch
import torch.distributed as tdist

__all__ = ["PhaseTimer", "MemUsage", "device_memory_stats"]


def _summary(vals: list[float]) -> dict[str, float]:
    return {"count": len(vals), "sum": sum(vals), "min": min(vals),
            "max": max(vals), "mean": statistics.fmean(vals),
            "stdev": statistics.pstdev(vals) if len(vals) > 1 else 0.0}


class PhaseTimer:
    """Accumulates named phase durations (seconds)."""

    def __init__(self, enabled: bool = True):
        self.enabled = enabled
        self.durations: dict[str, list[float]] = {}

    @contextlib.contextmanager
    def phase(self, name: str):
        if not self.enabled:
            yield
            return
        t0 = time.perf_counter()
        try:
            yield
        finally:
            self.durations.setdefault(name, []).append(
                time.perf_counter() - t0)

    def add(self, name: str, seconds: float):
        self.durations.setdefault(name, []).append(seconds)

    def total(self, name: str) -> float:
        return sum(self.durations.get(name, []))

    def count(self, name: str) -> int:
        """Number of times phase `name` was entered."""
        return len(self.durations.get(name, []))

    def clear(self):
        self.durations.clear()

    def stats(self) -> dict[str, dict[str, float]]:
        return {name: _summary(vals) for name, vals in self.durations.items()}

    def cross_host_stats(self) -> dict[str, dict[str, float]]:
        """Per-phase totals reduced over the ranks of the default group
        when one is initialized, else this process alone —
        the reference's collective report (Timer::report(title, comm),
        timer.hpp:265: min / max / mean / stdev of each rank's duration).

        A collective: every rank must call it.  Phases are aligned by the
        sorted union of names, a rank without a phase counting 0 s."""
        totals = {n: self.total(n) for n in self.durations}
        per_rank = [totals]
        if tdist.is_initialized() and tdist.get_world_size() > 1:
            per_rank = [None] * tdist.get_world_size()
            tdist.all_gather_object(per_rank, totals)
        names = sorted({n for d in per_rank for n in d})
        return {n: _summary([d.get(n, 0.0) for d in per_rank])
                for n in names}

    def report(self, title: str = "", cross_host: bool = False) -> str:
        """[TIME] CSV lines, reference format: header + durations
        (timer.hpp report_loc).  With cross_host=True the statistics are
        those of the ranks' phase totals (`cross_host_stats`, a
        collective), as BL_TIMER_REPORT_MPI reports them."""
        lines = [f"[TIME] {title}\tphase\tcount\tsum\tmin\tmax\tmean\tstdev"]
        stats = self.cross_host_stats() if cross_host else self.stats()
        for name, s in stats.items():
            lines.append(
                f"[TIME] {title}\t{name}\t{s['count']}\t{s['sum']:.6f}"
                f"\t{s['min']:.6f}\t{s['max']:.6f}\t{s['mean']:.6f}"
                f"\t{s['stdev']:.6f}")
        return "\n".join(lines)


class MemUsage:
    """Host RSS snapshots (plog::MemUsage analog, memory_usage.hpp:110)."""

    def __init__(self):
        self.marks: dict[str, tuple[int, int]] = {}

    @staticmethod
    def _status_bytes(field: str) -> int:
        try:
            with open("/proc/self/status") as f:
                for line in f:
                    if line.startswith(field):
                        return int(line.split()[1]) * 1024
        except OSError:
            pass
        return 0

    @classmethod
    def current_rss(cls) -> int:
        return cls._status_bytes("VmRSS")

    @classmethod
    def peak_rss(cls) -> int:
        return cls._status_bytes("VmHWM")

    def mark(self, name: str):
        self.marks[name] = (self.current_rss(), self.peak_rss())

    def report(self, title: str = "") -> str:
        lines = [f"[MEM] {title}\tmark\tcurrent_bytes\tpeak_bytes"]
        for name, (cur, peak) in self.marks.items():
            lines.append(f"[MEM] {title}\t{name}\t{cur}\t{peak}")
        return "\n".join(lines)


def device_memory_stats() -> dict:
    """{"cuda:i": torch.cuda.memory_stats(i)} of every visible card (the
    caching allocator's allocated / reserved / peak bytes); empty where
    there is none."""
    if not torch.cuda.is_available():
        return {}
    return {f"cuda:{i}": torch.cuda.memory_stats(i)
            for i in range(torch.cuda.device_count())}
