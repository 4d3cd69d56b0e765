"""The device timeline of a traced window, read from torch.profiler's Chrome
trace: what ran on the card, when, and what the host did meanwhile.

The harness wraps each frame or pass of the traced window in a
`record_function` span named STEP_SPAN. The traced window runs from the
first such span's start to the last one's end; device work is every kernel,
copy and fill the trace holds inside it.
"""
from __future__ import annotations

import bisect
import json
import os
import re
import tempfile
from collections import defaultdict

STEP_SPAN = "portbench.step"
DEVICE_CATS = {"kernel": "kernel", "gpu_memcpy": "memcpy", "gpu_memset": "memset"}
HOST_CATS = ("cpu_op", "cuda_runtime", "cuda_driver", "user_annotation")
SCAN_BACK = 64


class Timeline:
    """Device events (kind, name, start_us, end_us) and host events (name,
    start_us, end_us) of the traced steps."""

    def __init__(self, events: list[dict]):
        steps = [(e["ts"], e["ts"] + e["dur"]) for e in events
                 if e.get("cat") == "user_annotation" and e.get("name") == STEP_SPAN]
        self.steps = len(steps)
        self.start = min((s for s, _ in steps), default=0.0)
        self.end = max((e for _, e in steps), default=0.0)
        self.device = []
        self.host = []
        for e in events:
            if e.get("ph") != "X" or "dur" not in e:
                continue
            lo, hi = float(e["ts"]), float(e["ts"]) + float(e["dur"])
            if hi < self.start or lo > self.end:
                continue
            kind = DEVICE_CATS.get(e.get("cat"))
            if kind is not None:
                self.device.append((kind, e.get("name", ""), max(lo, self.start), min(hi, self.end)))
            elif e.get("cat") in HOST_CATS and e.get("name") != STEP_SPAN:
                self.host.append((e.get("name", ""), lo, hi))
        self.device.sort(key=lambda x: x[2])

    @property
    def window_s(self) -> float:
        return (self.end - self.start) * 1e-6

    def kernels(self, pattern: str | None = None, exclude: bool = False):
        """Kernels whose name matches `pattern` (re.search), or, with
        `exclude`, those that do not."""
        rx = None if pattern is None else re.compile(pattern)
        return [d for d in self.device if d[0] == "kernel"
                and (rx is None or bool(rx.search(d[1])) != exclude)]

    def seconds(self, events) -> float:
        return sum(hi - lo for _, _, lo, hi in events) * 1e-6

    def busy_intervals(self):
        """The union of device events as disjoint (start, end) intervals."""
        out = []
        for _, _, lo, hi in self.device:
            if out and lo <= out[-1][1]:
                out[-1][1] = max(out[-1][1], hi)
            else:
                out.append([lo, hi])
        return out

    def busy_s(self) -> float:
        return sum(hi - lo for lo, hi in self.busy_intervals()) * 1e-6

    def device_ops(self, top: int = 10):
        """[name, seconds] of the device operations that took most time."""
        acc = defaultdict(float)
        for _, name, lo, hi in self.device:
            acc[name] += (hi - lo) * 1e-6
        return [[k, v] for k, v in sorted(acc.items(), key=lambda kv: -kv[1])[:top]]

    def idle_gaps(self, top: int = 10):
        """[host activity, seconds] of the device's idle time in the window,
        each gap named after the innermost host event running at its middle
        ("host idle" where none is)."""
        busy = self.busy_intervals()
        gaps = []
        t = self.start
        for lo, hi in busy:
            if lo > t:
                gaps.append((t, lo))
            t = max(t, hi)
        if self.end > t:
            gaps.append((t, self.end))
        host = sorted(self.host, key=lambda h: h[1])
        starts = [h[1] for h in host]
        acc = defaultdict(float)
        for lo, hi in gaps:
            mid = 0.5 * (lo + hi)
            best = None
            # Inner events start after the events around them: the latest
            # starts before the middle hold the innermost.
            j = bisect.bisect_right(starts, mid)
            for h in host[max(0, j - SCAN_BACK):j]:
                name, h_lo, h_hi = h
                if h_lo <= mid <= h_hi and (best is None or h_hi - h_lo < best[1]):
                    best = (name, h_hi - h_lo)
            acc["host idle" if best is None else best[0]] += (hi - lo) * 1e-6
        return [[k, v] for k, v in sorted(acc.items(), key=lambda kv: -kv[1])[:top]]


def from_profiler(prof) -> Timeline:
    """Export the profile's Chrome trace to a temporary file and read it."""
    fd, path = tempfile.mkstemp(suffix=".json")
    os.close(fd)
    try:
        prof.export_chrome_trace(path)
        with open(path) as f:
            data = json.load(f)
    finally:
        os.remove(path)
    return Timeline(data["traceEvents"] if isinstance(data, dict) else data)
