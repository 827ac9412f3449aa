"""Device-trace profiling — `torch.profiler` as the tracing backend.

The port of ``kmerind_tpu.utils.profiling``.  The reference's tracing is
its BL_TIMER macro system (``utils/timers.py`` here); for device-side
attribution the JAX package wraps the XLA profiler, and this module wraps
`torch.profiler`: `trace()` records a region's host and CUDA activity and
writes a Chrome trace, `annotate()` names a sub-region so the kernels it
launches group under it.
"""

from __future__ import annotations

import contextlib
import os

import torch

__all__ = ["trace", "annotate"]


@contextlib.contextmanager
def trace(logdir: str):
    """Record the enclosed region — CPU activity, and CUDA kernels and
    copies where a card is visible — and write it to
    ``<logdir>/trace.json`` (Chrome trace format: chrome://tracing or
    Perfetto).  Yields the profiler, whose `key_averages()` sums the time
    by operator and kernel."""
    acts = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(torch.profiler.ProfilerActivity.CUDA)
    os.makedirs(logdir, exist_ok=True)
    with torch.profiler.profile(activities=acts) as prof:
        yield prof
    prof.export_chrome_trace(os.path.join(logdir, "trace.json"))


def annotate(name: str):
    """A named sub-region of a trace (`torch.profiler.record_function`)."""
    return torch.profiler.record_function(name)
