"""Tracing / profiling utilities (port of cpupathtrace_tpu/utils/profiling.py).

The reference's only observability is a mutex-serialized tile-progress
callback (ref: include/PathTrace/worker.h:74-79, src/worker.cpp:354-360) and
external google-benchmark counters. The GPU equivalents here:

  * `trace_annotation` / `profile_to` — `torch.profiler` integration: a
    Chrome trace of the host ops and the card's kernels, with the
    annotated regions as ranges (and NVTX ranges on the card, which an
    `nsys` trace shows).
  * `RayCounter` — per-phase ray/sample throughput accounting, the analog of
    benchmark::SetItemsProcessed (ref: benchmark/main.cpp:30).
  * `progress_printer` — a console progress bar callback compatible with
    `render(progress_callback=...)` (ref: demo/main.cpp:211-226).
"""
from __future__ import annotations

import contextlib
import dataclasses
import os
import sys
import time

import torch


@contextlib.contextmanager
def trace_annotation(name: str):
    """Annotate a host-side region in the trace: a `record_function` range
    in any torch.profiler trace and, where there is a card, an NVTX range
    (an NVTX failure there raises)."""
    with torch.profiler.record_function(name):
        if torch.cuda.is_available():
            with torch.cuda.nvtx.range(name):
                yield
        else:
            yield


@contextlib.contextmanager
def profile_to(logdir: str):
    """Capture a torch.profiler trace (host ops and, on a card, its kernels)
    of the enclosed region into one Chrome trace file in `logdir`."""
    activities = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(torch.profiler.ProfilerActivity.CUDA)
    os.makedirs(logdir, exist_ok=True)
    prof = torch.profiler.profile(
        activities=activities,
        on_trace_ready=torch.profiler.tensorboard_trace_handler(logdir),
    )
    prof.start()
    try:
        yield prof
    finally:
        if torch.cuda.is_available():
            torch.cuda.synchronize()
        prof.stop()


@dataclasses.dataclass
class RayCounter:
    """Accumulates primary-sample counts and wall time per phase. With a
    CUDA `device`, `start` and `stop` synchronise it, so the time covers
    the card's work and not only its launches (JAX's callers block on
    their results instead)."""

    samples: int = 0
    seconds: float = 0.0
    _t0: float | None = None
    device: torch.device | str | None = None

    def _sync(self):
        if self.device is not None and torch.device(self.device).type == "cuda":
            torch.cuda.synchronize(self.device)

    def start(self):
        self._sync()
        self._t0 = time.perf_counter()
        return self

    def stop(self, samples: int):
        if self._t0 is None:
            raise RuntimeError("RayCounter.stop without start")
        self._sync()
        self.seconds += time.perf_counter() - self._t0
        self.samples += samples
        self._t0 = None
        return self

    @property
    def mrays_per_s(self) -> float:
        return self.samples / self.seconds / 1e6 if self.seconds > 0 else 0.0

    def report(self, name: str = "render") -> str:
        return (
            f"{name}: {self.samples} samples in {self.seconds:.2f}s "
            f"({self.mrays_per_s:.2f} Mrays/s)"
        )


def progress_printer(stream=sys.stderr, width: int = 50):
    """Returns a `(done, total) -> None` console progress bar callback."""

    def cb(done, total):
        frac = done / max(total, 1)
        bar = "#" * int(frac * width)
        print(f"\r[{bar:<{width}}] {done}/{total}", end="", file=stream, flush=True)
        if done >= total:
            print(file=stream)

    return cb
