"""Reading a `torch.profiler` chrome trace of the measured window.

`union_length` is a frozen copy of ``tools/profile_p4.py``
``union_length`` (lines 171-180 there), and `TraceView.device_items`
keeps the arithmetic of its ``phase_device_items`` (lines 183-196): a
device item is a kernel, memcpy or memset event, clipped to the window;
the device is busy over the union of their intervals, so work that
overlaps counts once.  Times in the trace are microseconds.
"""

from __future__ import annotations

import collections
import re

DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
#: prefix of the program's own ranges (its `PhaseTimer` phases under the
#: profiler), which name idle gaps but never bound the window
PROGRAM_PREFIX = "kmerind/"
#: longest name kept in a breakdown entry
NAME_CHARS = 120


def union_length(intervals) -> float:
    """Total length covered by [start, end) intervals, overlaps once."""
    total, reach = 0.0, float("-inf")
    for s, e in sorted(intervals):
        if e <= reach:
            continue
        total += e - max(s, reach)
        reach = e
    return total


def _merged(intervals) -> list:
    out: list = []
    for s, e in sorted(intervals):
        if out and s <= out[-1][1]:
            out[-1][1] = max(out[-1][1], e)
        else:
            out.append([s, e])
    return out


class TraceView:
    """The events of one traced window: the harness's ranges (user
    annotations named in `ranges`, the names the run's loop opened) bound
    it; device items inside it; the main thread's host operations and
    program ranges, which name its idle gaps."""

    def __init__(self, trace: dict, ranges):
        events = [ev for ev in trace.get("traceEvents", [])
                  if isinstance(ev, dict) and "dur" in ev and "ts" in ev]
        names = set(ranges)
        annotations = [(ev["name"], float(ev["ts"]),
                        float(ev["ts"]) + float(ev["dur"]), ev.get("tid"))
                       for ev in events if ev.get("cat") == "user_annotation"]
        self.ranges = [r for r in annotations if r[0] in names]
        if self.ranges:
            self.lo = min(r[1] for r in self.ranges)
            self.hi = max(r[2] for r in self.ranges)
            self.main_tid = self.ranges[0][3]
        else:
            self.lo = self.hi = 0.0
            self.main_tid = None
        self.program_ranges = [r for r in annotations
                               if r[0].startswith(PROGRAM_PREFIX)
                               and r[3] == self.main_tid]
        self.device = []
        for ev in events:
            if ev.get("cat") not in DEVICE_CATS:
                continue
            s = max(float(ev["ts"]), self.lo)
            e = min(float(ev["ts"]) + float(ev["dur"]), self.hi)
            if e > s:
                self.device.append((s, e, ev.get("name", "?"), ev["cat"],
                                    ev.get("args", {})))
        self.host_ops = [(float(ev["ts"]), float(ev["ts"]) + float(ev["dur"]),
                          ev.get("name", "?")) for ev in events
                         if ev.get("cat") in ("cpu_op", "cuda_runtime")
                         and ev.get("tid") == self.main_tid]

    @property
    def window_us(self) -> float:
        return self.hi - self.lo

    def busy_us(self) -> float:
        return union_length((s, e) for s, e, *_ in self.device)

    def device_items(self):
        """{name: device us} over the window."""
        by_name = collections.Counter()
        for s, e, name, *_ in self.device:
            by_name[name] += e - s
        return by_name

    def kernel_us(self, pattern: str) -> float:
        """Device us of the kernels whose name matches `pattern`."""
        rx = re.compile(pattern)
        return sum(e - s for s, e, name, cat, _ in self.device
                   if cat == "kernel" and rx.search(name))

    def kernel_count(self) -> int:
        return sum(1 for *_, cat, _ in self.device if cat == "kernel")

    def memcpy(self, direction: str):
        """(bytes, device us) of the memcpy events whose name holds
        `direction` ("HtoD", "DtoH"); bytes None where the trace gives
        none."""
        nbytes, us = 0, 0.0
        for s, e, name, cat, args in self.device:
            if cat == "gpu_memcpy" and direction in name:
                if "bytes" not in args:
                    return None, us
                nbytes += int(args["bytes"])
                us += e - s
        return nbytes, us

    def _innermost(self, intervals, points) -> list:
        """For each of the sorted `points`, the name of the innermost of the
        nested (start, end, name) `intervals` that holds it, or None."""
        ivs = sorted(intervals, key=lambda iv: (iv[0], -iv[1]))
        out, stack, i = [], [], 0
        for t in points:
            while i < len(ivs) and ivs[i][0] <= t:
                while stack and stack[-1][1] <= ivs[i][0]:
                    stack.pop()
                stack.append(ivs[i])
                i += 1
            while stack and stack[-1][1] <= t:
                stack.pop()
            out.append(stack[-1][2] if stack else None)
        return out

    def breakdown(self, top: int = 10) -> dict:
        """The device items that took most time, and the device's idle
        time summed by what the main thread was doing meanwhile: the
        harness's range, the innermost program range and the innermost
        host operation it was in at each gap's middle
        ("range/kmerind/phase/op", each part only where there is one), in
        seconds."""
        ops = [[name[:NAME_CHARS], us / 1e6]
               for name, us in self.device_items().most_common(top)]
        gaps, reach = [], self.lo
        for s, e in _merged((s, e) for s, e, *_ in self.device) + [
                [self.hi, self.hi]]:
            if s > reach:
                gaps.append(((s + reach) / 2, (s - reach) / 1e6))
            reach = max(reach, e)
        mids = [m for m, _ in gaps]
        where = self._innermost([(s, e, n) for n, s, e, _ in self.ranges],
                                mids)
        phase = self._innermost(
            [(s, e, n) for n, s, e, _ in self.program_ranges], mids)
        what = self._innermost(self.host_ops, mids)
        by_name = collections.Counter()
        for (_, sec), rng, ph, op in zip(gaps, where, phase, what):
            name = "/".join([rng or "between_calls"]
                            + [x for x in (ph, op) if x])
            by_name[name[:NAME_CHARS]] += sec
        return {"device_ops": ops,
                "idle_gaps": [[n, s] for n, s in by_name.most_common(top)]}
