"""Tracing / profiling utilities (port of cpupathtrace_tpu/utils/profiling.py).

The reference's only observability is a mutex-serialized tile-progress
callback (ref: include/PathTrace/worker.h:74-79, src/worker.cpp:354-360) and
external google-benchmark counters. The GPU equivalents here:

  * `trace_annotation` / `profile_to` — `torch.profiler` integration: a
    Chrome trace of the host ops and the card's kernels, with the
    annotated regions as ranges (and NVTX ranges on the card, which an
    `nsys` trace shows). A span records only while a torch.profiler
    session is recording; otherwise it is a shared no-op context, so the
    spans stay on the hot path. The program's spans, `<layer>.<what>`:
    `film.render` (a frame's root), `film.tile`, `film.chunk`,
    `camera.shoot`, `film.fold`, `film.flag_read`, `film.candidate`,
    `film.image_read`;
    `k1.trace`; `sorted.trace`, `sorted.bounce`, `sorted.live_read`,
    `sorted.sort`, `sorted.unpermute`; `diff.loss_and_grad` (a gradient
    pass's root), `diff.grad`, `diff.record`, `diff.live_read`,
    `diff.preprocess`, `diff.backward` (on autograd's thread for CUDA).
  * `counters` — one snapshot of the hot path's counters (function
    attributes of the drivers and kernel wrappers) under layer names.
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


# Shared by every span while no profiler records: nullcontext is reentrant.
_OFF = contextlib.nullcontext()


def trace_annotation(name: str):
    """Annotate a host-side region in the trace. While a torch.profiler
    session records (the module flag `_is_profiler_enabled`), a
    `record_function` range, on the profiler's clock beside the card's
    kernels and copies, and where there is a card an NVTX range (an NVTX
    failure there raises); otherwise a shared no-op context, at once."""
    if not torch.autograd.profiler._is_profiler_enabled:
        return _OFF
    return _recorded(name)


@contextlib.contextmanager
def _recorded(name: str):
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


def counters() -> dict[str, int]:
    """One snapshot of every hot-path counter of the port, under layer
    names: kernel launches (K1-K8, the replay vjp), the drivers' host
    reads, the live rays entering each launched bounce, the film's stats
    batches, flag reads and candidate selections (one a tile). Each is a
    function attribute its code adds to; take two snapshots and subtract.
    Stores nothing of its own."""
    from ..accel import cluster_major, kernel_traverse, traverse
    from ..integrator import diff_megakernel, film, megakernel, sorted_wavefront
    from ..ops import intersect

    sorted_trace = sorted_wavefront.trace_megakernel_sorted
    record_trace = diff_megakernel.trace_megakernel_diff
    return {
        "k1.launches": megakernel.trace_megakernel.launches,
        "k2.launches": sorted_wavefront.bounce.launches,
        "k2.record_launches": sorted_wavefront.bounce.record_launches,
        "k4.launches": kernel_traverse.cluster_intersect.launches,
        "k5.launches": intersect.dense_intersect.launches,
        "k6.launches": traverse.candidates.launches,
        # binned_intersect's reads of the count and flags that gate the
        # K6 / K7 rounds.
        "k6.host_reads": traverse.binned_intersect.host_reads,
        "k7.launches": traverse.isect.launches,
        "k8.launches": cluster_major.test_candidates.launches,
        "sorted.host_reads": sorted_trace.host_reads,
        "sorted.live_rays": sorted_trace.live_rays,
        "diff.host_reads": record_trace.host_reads,
        "diff.live_rays": record_trace.live_rays,
        "diff.vjp_launches": diff_megakernel.replay_vjp.launches,
        "film.stats_batches": film.render_tile.stats_batches,
        "film.flag_reads": film.render_tile.flag_reads,
        "film.candidate_selects": film.render_tile.candidate_selects,
    }


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
