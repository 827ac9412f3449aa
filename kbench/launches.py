"""The kernels a program range launched, matched by correlation id.

A `torch.profiler` chrome trace gives each CUDA runtime call on the host
(``cuda_runtime``, ``cuda_driver``) and each device item it started
(``kernel``, ``gpu_memcpy``, ``gpu_memset``) the same ``correlation``
argument.  The device items a host range launched are those whose
correlation is that of a runtime call made inside the range on the
range's thread, wherever on the device's timeline they ran: a range that
only enqueues work ends before its kernels do.
"""

from __future__ import annotations

HOST_CATS = ("cuda_runtime", "cuda_driver")
DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")


def launch_events(trace: dict, names) -> dict:
    """The parts of a chrome trace that `range_device_us` reads: the
    ``user_annotation`` ranges named in `names` (name, start, end,
    thread), every runtime call (start, thread, correlation) and every
    device item (correlation, duration), times in microseconds."""
    names = set(names)
    out = {"ranges": [], "calls": [], "device": []}
    for ev in trace.get("traceEvents", []):
        if not isinstance(ev, dict) or "ts" not in ev or "dur" not in ev:
            continue
        cat, ts = ev.get("cat"), float(ev["ts"])
        corr = (ev.get("args") or {}).get("correlation")
        if cat == "user_annotation" and ev.get("name") in names:
            out["ranges"].append((ev["name"], ts, ts + float(ev["dur"]),
                                  ev.get("tid")))
        elif cat in HOST_CATS and corr is not None:
            out["calls"].append((ts, ev.get("tid"), corr))
        elif cat in DEVICE_CATS and corr is not None:
            out["device"].append((corr, float(ev["dur"])))
    return out


def range_device_us(events: dict, *names: str) -> float | None:
    """Device microseconds of the items launched inside the ranges named
    any of `names` (each item once, where such ranges nest), or None
    where no such range was traced."""
    ranges = [(lo, hi, tid) for n, lo, hi, tid in events["ranges"]
              if n in names]
    if not ranges:
        return None
    corrs = {c for ts, tid, c in events["calls"]
             if any(lo <= ts <= hi and tid == rt for lo, hi, rt in ranges)}
    return sum(d for c, d in events["device"] if c in corrs)
