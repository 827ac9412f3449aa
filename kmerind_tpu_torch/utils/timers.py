"""Phase timers — the observability layer.

The port's copy of ``kmerind_tpu.utils.timers.PhaseTimer``, after the
reference's BL_TIMER/BL_BENCH macros (src/utils/timer.hpp:398-431): named
per-phase wall-clock sections accumulated per process and reported with
min/max/mean/stdev statistics in the reference's ``[TIME]`` CSV format.
A phase measures host wall-clock time; work a phase only enqueues on the
device is not in it unless the phase ends in a synchronising call.
"""

from __future__ import annotations

import contextlib
import statistics
import time

__all__ = ["PhaseTimer"]


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
        out = {}
        for name, vals in self.durations.items():
            out[name] = {
                "count": len(vals),
                "sum": sum(vals),
                "min": min(vals),
                "max": max(vals),
                "mean": statistics.fmean(vals),
                "stdev": statistics.pstdev(vals) if len(vals) > 1 else 0.0,
            }
        return out

    def report(self, title: str = "") -> str:
        """[TIME] CSV lines, reference format: header + durations
        (timer.hpp report_loc)."""
        lines = [f"[TIME] {title}\tphase\tcount\tsum\tmin\tmax\tmean\tstdev"]
        for name, s in self.stats().items():
            lines.append(
                f"[TIME] {title}\t{name}\t{s['count']}\t{s['sum']:.6f}"
                f"\t{s['min']:.6f}\t{s['max']:.6f}\t{s['mean']:.6f}"
                f"\t{s['stdev']:.6f}")
        return "\n".join(lines)
