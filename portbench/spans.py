"""Device time and idle gaps put down to the program's own spans.

The program opens a span (`utils/profiling.py:trace_annotation`, a
`record_function` range named `<layer>.<what>`) at each layer boundary,
and counts its work in function attributes (`profiling.counters()`). The
metrics that read them call `measure(run)` from their `count` hook. It
runs once a run (memoised on the Run): `trace_steps` more steps of the
cell after the traced window, under torch.profiler with the window's
activities, each step in a STEP_SPAN range and driven by `entry.step` as
the window drives it; `entry.outputs` is left as the window left it, so
`correct` samples the window's own steps.

On the profiler's one clock:

- a kernel, copy or fill goes to the innermost program span open on the
  thread whose launch or copy call (a `cuda_runtime` or `cuda_driver`
  event: K1 and K2 launch from their own libraries) holds its correlation
  id, at that call. Where that thread has none open (autograd's device
  thread outside the program's backward), it goes to the innermost span
  open at that moment on the thread that called the entry point;
- each gap in the union of device events (as `Timeline` takes it) goes to
  the innermost program span open on the calling thread at its middle;
- the counters are `counters()` deltas over the steps.

A program without spans or counters gives no names and no counters, and
the readers then return None.
"""
from __future__ import annotations

import bisect
import json
import os
import sys
import tempfile
from collections import defaultdict

import torch

from . import timeline as tl

LAUNCH_CATS = ("cuda_runtime", "cuda_driver")
SPAN_CAT = "user_annotation"
MEMO = "spans"


def _thread(e) -> tuple:
    return (e.get("pid"), e.get("tid"))


class SpanIndex:
    """The program spans of one thread: the innermost one open at a time."""

    def __init__(self, spans: list[tuple[float, float, str]]):
        self.spans = sorted(spans, key=lambda s: (s[0], -s[1]))
        self.starts = [s[0] for s in self.spans]
        # Each span's parent: the nearest earlier span still open at its
        # start (spans of one thread nest).
        self.parent: list[int] = []
        stack: list[int] = []
        for i, (lo, _, _) in enumerate(self.spans):
            while stack and self.spans[stack[-1]][1] <= lo:
                stack.pop()
            self.parent.append(stack[-1] if stack else -1)
            stack.append(i)

    def innermost(self, t: float) -> str | None:
        """The latest-starting span at or before t that is still open, up
        its chain of parents: any span holding t holds that one's start."""
        i = bisect.bisect_right(self.starts, t) - 1
        while i >= 0 and self.spans[i][1] < t:
            i = self.parent[i]
        return self.spans[i][2] if i >= 0 else None


class Attribution:
    """Device seconds and idle seconds by innermost program span (None: no
    span), the span names seen, the counter deltas, over `steps` steps."""

    def __init__(self, events: list[dict], steps: int, counters: dict[str, int]):
        self.steps = steps
        self.counters = counters
        self.timeline = tl.Timeline(events)
        t = self.timeline
        callers = {_thread(e) for e in events
                   if e.get("cat") == SPAN_CAT and e.get("name") == tl.STEP_SPAN}
        self.caller = min(callers, key=str) if callers else None
        by_thread = defaultdict(list)
        launches = {}
        device = []
        for e in events:
            if e.get("ph") != "X" or "dur" not in e:
                continue
            cat = e.get("cat")
            lo, hi = float(e["ts"]), float(e["ts"]) + float(e["dur"])
            corr = (e.get("args") or {}).get("correlation")
            if cat == SPAN_CAT and e.get("name") != tl.STEP_SPAN:
                by_thread[_thread(e)].append((lo, hi, e.get("name", "")))
            elif cat in LAUNCH_CATS and corr is not None:
                launches[corr] = (_thread(e), lo)
            elif cat in tl.DEVICE_CATS and hi >= t.start and lo <= t.end:
                device.append((e, corr, max(lo, t.start), min(hi, t.end)))
        self.names = {s[2] for spans in by_thread.values() for s in spans}
        self.index = {k: SpanIndex(v) for k, v in by_thread.items()}
        self.device_s: dict = defaultdict(float)
        # name -> [copies, spans ending after their copy, the latest copy end
        # past its span's end in us]
        self.reads: dict = defaultdict(lambda: [0, 0, 0.0])
        for e, corr, lo, hi in device:
            name = None
            if corr in launches:
                thread, at = launches[corr]
                name = self._innermost(thread, at)
                if name is None:
                    name = self._innermost(self.caller, at)
                if (name is not None and name.endswith("_read")
                        and e.get("cat") == "gpu_memcpy" and "DtoH" in e.get("name", "")):
                    self._check_read(thread, at, name, hi)
            self.device_s[name] += (hi - lo) * 1e-6
        self.idle_s: dict = defaultdict(float)
        edge = t.start
        gaps = []
        for lo, hi in t.busy_intervals():
            if lo > edge:
                gaps.append((edge, lo))
            edge = max(edge, hi)
        if t.end > edge:
            gaps.append((edge, t.end))
        for lo, hi in gaps:
            self.idle_s[self._innermost(self.caller, 0.5 * (lo + hi))] += (hi - lo) * 1e-6

    def _innermost(self, thread, at: float) -> str | None:
        index = self.index.get(thread)
        return index.innermost(at) if index is not None else None

    def _check_read(self, thread, at: float, name: str, copy_end: float):
        """Does the read span around this copy call end no earlier than
        the copy? (One clock for host and card.)"""
        index = self.index[thread]
        i = bisect.bisect_right(index.starts, at) - 1
        while i >= 0 and (index.spans[i][1] < at or index.spans[i][2] != name):
            i = index.parent[i]
        if i >= 0:
            r = self.reads[name]
            r[0] += 1
            r[1] += index.spans[i][1] >= copy_end
            r[2] = max(r[2], copy_end - index.spans[i][1])

    def _read(self) -> bool:
        """Something to read: steps on the card, and the program's spans."""
        return bool(self.steps and self.timeline.device and self.names)

    def device_ms(self, span: str) -> float | None:
        """Device milliseconds a step launched under `span` (innermost)."""
        if not self._read() or span not in self.names:
            return None
        return self.device_s.get(span, 0.0) / self.steps * 1e3

    def idle_ms(self, *layers: str) -> float | None:
        """Idle milliseconds a step whose innermost span on the calling
        thread is of one of `layers` (the part of a name before its dot)."""
        if not self._read() or not any(n.split(".")[0] in layers for n in self.names):
            return None
        return sum(v for k, v in self.idle_s.items()
                   if k is not None and k.split(".")[0] in layers) / self.steps * 1e3

    def summary(self) -> dict:
        """The helper's own numbers, for the record: device and idle time
        under no program span, the idle share, each span's device and idle
        ms a step, and how many read spans ended after their copy."""
        dev = sum(self.device_s.values())
        window = self.timeline.window_s
        idle = sum(self.idle_s.values())
        per = max(self.steps, 1) / 1e3
        return {
            "steps": self.steps,
            "spans_per_step": sum(len(i.spans) for i in self.index.values()) / max(self.steps, 1),
            "device_ms": dev / per, "window_ms": window / per,
            "unspanned_device_pct": 100.0 * self.device_s.get(None, 0.0) / dev if dev else None,
            "unspanned_idle_ms": self.idle_s.get(None, 0.0) / per,
            "idle_pct": 100.0 * idle / window if window else None,
            "device_ms_by_span": {str(k): v / per for k, v in sorted(
                self.device_s.items(), key=lambda kv: -kv[1])},
            "idle_ms_by_span": {str(k): v / per for k, v in sorted(
                self.idle_s.items(), key=lambda kv: -kv[1])},
            "reads_ending_after_their_copy": {k: v for k, v in self.reads.items()},
            "counters": self.counters,
        }


def _counters() -> dict[str, int]:
    """The program's counters, or none where it has no `counters()`."""
    try:
        from cpupathtrace_tpu_torch.utils import profiling
    except ImportError:
        return {}
    snap = getattr(profiling, "counters", None)
    return snap() if snap is not None else {}


def chrome_events(prof) -> list[dict]:
    """The profile's Chrome trace events, through a temporary file."""
    fd, path = tempfile.mkstemp(suffix=".json")
    os.close(fd)
    try:
        prof.export_chrome_trace(path)
        with open(path) as f:
            data = json.load(f)
    finally:
        os.remove(path)
    return data["traceEvents"] if isinstance(data, dict) else data


def profile_steps(entry) -> Attribution:
    """`trace_steps` steps after the traced window, under torch.profiler,
    each in a STEP_SPAN range; `entry.outputs` is restored after."""
    from torch.profiler import ProfilerActivity, profile, record_function

    acts = [ProfilerActivity.CPU]
    if entry.device.type == "cuda":
        acts.append(ProfilerActivity.CUDA)
    n = entry.tr["trace_steps"]
    first = entry.tr["trace_warm_steps"] + n
    kept = list(entry.outputs)
    before = _counters()
    try:
        with profile(activities=acts) as prof:
            for i in range(first, first + n):
                with record_function(tl.STEP_SPAN):
                    entry.step(i)
            if entry.device.type == "cuda":
                torch.cuda.synchronize(entry.device)
        after = _counters()
    finally:
        entry.outputs[:] = kept
    return Attribution(chrome_events(prof), n, {k: after[k] - before.get(k, 0) for k in after})


def measure(run) -> Attribution:
    """The run's attribution, profiled once and kept on the Run."""
    if not hasattr(run, MEMO):
        a = profile_steps(run.entry)
        s = a.summary()
        print(f"# spans: device ms a step under no program span "
              f"{s['unspanned_device_pct']}% of {s['device_ms']}; idle ms a step under no "
              f"program span {s['unspanned_idle_ms']} of {s['window_ms']}; the helper's "
              f"idle {s['idle_pct']}%", file=sys.stderr)
        print(f"# spans summary {json.dumps(s)}", file=sys.stderr)
        setattr(run, MEMO, a)
    return getattr(run, MEMO)
