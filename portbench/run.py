"""The benchmark of cpupathtrace_tpu_torch: one run of one cell.

    python3 -m portbench.run --workload <cell> --seed <n> --seconds <s> --trace <0|1>

from the root of a checkout. A cell of BENCHMARK.json names a configuration
(portbench/configs/<config>.json with its .py beside it: the program's scene
and the reference's) and a traffic mix (portbench/traffic/<traffic>.json:
the entry point, sizes and the check's limits); each metric is read by
portbench/metrics/<metric>.py. The run sets up the cell, warms its one
shape, drives the entry point in a closed loop (one client, the next step
as soon as the last returns) for --seconds, or with --trace 1 profiles a
fixed number of steps, then compares a sample of what the window produced
with the plain reference and prints one JSON line.

A configuration's .py gives `program_scene(cfg, device, cache_dir)` (the
program's scene and camera) and `reference_scene(cfg, device)`. It may also
give the reference its own camera, `reference_camera(cfg)`, and its own
tracer, `reference_tracer(cfg, scene, dtype)` over the scene that its
`reference_scene` returned (the callables that reference/film.py
describes: the uniforms a launch draws from the frame's generator and the
rays of the chosen ray indices; the radiance, collected flag and entering
counts of the given rays). Where it gives neither, the frozen pinhole and
triangle tracer run. The film (the launch plan, the stopping rule of
adaptive frames and the pixel sums) is the reference's own, shared by all.
"""
from __future__ import annotations

import time

T0 = time.perf_counter()

import argparse  # noqa: E402
import gc  # noqa: E402
import importlib.util  # noqa: E402
import json  # noqa: E402
import math  # noqa: E402
import os  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

import torch  # noqa: E402

from . import timeline as tl  # noqa: E402
from .entries import ENTRIES  # noqa: E402

HERE = Path(__file__).resolve().parent
SCENE_CACHE = HERE / ".cache" / "scenes"
FORBIDDEN = ("jax", "jaxlib", "flax", "cpupathtrace_tpu")


def _load(path: Path, name: str):
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


class Cell:
    """One workload of BENCHMARK.json with its configuration, traffic and
    metrics, each found by name under portbench/."""

    def __init__(self, manifest: dict, workload: str, root: Path = HERE):
        cells = {w["name"]: w for w in manifest["workloads"]}
        if workload not in cells:
            raise SystemExit(f"unknown workload {workload!r}; BENCHMARK.json has {sorted(cells)}")
        w = cells[workload]
        self.name = workload
        self.chips = int(w["chips"])
        with open(root / "configs" / f"{w['config']}.json") as f:
            self.config = json.load(f)
        self.module = _load(root / "configs" / f"{w['config']}.py", f"portbench_config_{w['config']}")
        with open(root / "traffic" / f"{w['traffic']}.json") as f:
            self.traffic = json.load(f)
        self.cache_dir = SCENE_CACHE

        def mine(m):
            return "workloads" not in m or workload in m["workloads"]

        self.end_to_end = [m for m in manifest["end_to_end"] if mine(m)]
        self.per_layer = [m for m in manifest["per_layer"] if mine(m)]
        self.readers = {m["name"]: _load(root / "metrics" / f"{m['name']}.py",
                                         f"portbench_metric_{i}")
                        for i, m in enumerate(self.end_to_end + self.per_layer)}


class Run:
    """What a metric reader reads: the entry, the window's step latencies and
    length, the set-up seconds, the traced timeline, and counts taken while
    the program's state was alive (`counted[metric]`)."""

    def __init__(self, entry, setup_s):
        self.entry = entry
        self.setup_s = setup_s
        self.latencies: list[float] = []
        self.elapsed = 0.0
        self.timeline: tl.Timeline | None = None
        self.counted: dict = {}

    @property
    def steps(self) -> int:
        return len(self.latencies)


def _sync(device):
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize(device)


def window(entry, seconds: float, run: Run):
    """The closed loop: steps back to back until `seconds` have passed; the
    window ends when the last step returns."""
    start = time.perf_counter()
    end = start
    i = 0
    while end - start < seconds:
        a = time.perf_counter()
        entry.step(i)
        end = time.perf_counter()
        run.latencies.append(end - a)
        i += 1
    run.elapsed = end - start


def traced_window(entry, run: Run, device):
    """Untraced steps, then `trace_steps` steps under torch.profiler, each in
    a STEP_SPAN range."""
    from torch.profiler import ProfilerActivity, profile, record_function

    tr = entry.tr
    for i in range(tr["trace_warm_steps"]):
        entry.step(i)
    acts = [ProfilerActivity.CPU]
    if torch.device(device).type == "cuda":
        acts.append(ProfilerActivity.CUDA)
    first = tr["trace_warm_steps"]
    start = time.perf_counter()
    with profile(activities=acts) as prof:
        for i in range(first, first + tr["trace_steps"]):
            a = time.perf_counter()
            with record_function(tl.STEP_SPAN):
                entry.step(i)
            run.latencies.append(time.perf_counter() - a)
        _sync(device)
    run.elapsed = time.perf_counter() - start
    run.timeline = tl.from_profiler(prof)


def card_line() -> str:
    try:
        out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                              "--format=csv,noheader"], capture_output=True, text=True,
                             timeout=30)
        return out.stdout.strip().splitlines()[0] if out.stdout.strip() else "unknown"
    except (OSError, subprocess.SubprocessError):
        return "unknown"


def run_cell(cell: Cell, seed: int, seconds: float, trace: bool, device="cuda",
             t0: float = T0) -> dict:
    """One run of `cell`; returns the result line's object."""
    log = sys.stderr
    entry = ENTRIES[cell.traffic["entry"]](cell, seed, device)
    entry.setup()
    entry.warm()
    _sync(device)
    run = Run(entry, time.perf_counter() - t0)
    print(f"# set-up {run.setup_s:.3f} s", file=log)
    _setup_lines(log)
    if trace:
        traced_window(entry, run, device)
    else:
        window(entry, seconds, run)
    _sync(device)
    dev = {"platform": "cpu", "kind": "cpu", "count": 1, "memory_peak_bytes": 0}
    if torch.device(device).type == "cuda":
        dev = {"platform": "gpu", "kind": torch.cuda.get_device_name(device), "count": cell.chips,
               "memory_peak_bytes": int(torch.cuda.max_memory_allocated(device))}
    print(f"# window {run.elapsed:.3f} s, {run.steps} steps", file=log)
    metrics = cell.per_layer if trace else cell.end_to_end
    for m in metrics:
        count = getattr(cell.readers[m["name"]], "count", None)
        if count is not None:
            run.counted[m["name"]] = count(run)
    entry.release()
    gc.collect()
    if torch.device(device).type == "cuda":
        torch.cuda.empty_cache()
    t_check = time.perf_counter()
    numbers = entry.check()
    print(f"# check {time.perf_counter() - t_check:.3f} s", file=log)
    limits = cell.traffic["limits"]
    checks = {k: {"value": v, "limit": limits[k]} for k, v in numbers.items()}
    correct = run.steps > 0 and all(
        v is not None and not math.isnan(v) and v <= limits[k] for k, v in numbers.items())
    values = {}
    for m in metrics:
        v = cell.readers[m["name"]].read(run)
        if v is not None:
            values[m["name"]] = {"value": v, "unit": m["unit"]}
    out = {"correct": bool(correct), "attempted": run.steps, "failed": 0, "metrics": values,
           "device": dev}
    if trace and run.timeline is not None:
        dev["busy_s"] = run.timeline.busy_s()
        dev["window_s"] = run.timeline.window_s
        out["breakdown"] = {"device_ops": run.timeline.device_ops(),
                            "idle_gaps": run.timeline.idle_gaps()}
    out["checks"] = checks
    return out


def _setup_lines(log):
    """The program's own set-up stage times, for the record."""
    from cpupathtrace_tpu_torch import _build
    from cpupathtrace_tpu_torch.scene import cache, scene

    print(f"# build seconds {json.dumps(_build.build_seconds)}", file=log)
    print(f"# scene BUILD_SECONDS {json.dumps(scene.BUILD_SECONDS)}", file=log)
    print(f"# scene cache seconds {json.dumps(getattr(cache.cached_build, 'seconds', None))}",
          file=log)


def forbidden_modules() -> list[str]:
    """Modules of JAX or of the JAX package loaded in this process, by whole
    top-level name."""
    return sorted({n.split(".")[0] for n in sys.modules} & set(FORBIDDEN))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    manifest_path = Path.cwd() / "BENCHMARK.json"
    if not manifest_path.exists():
        print(f"no BENCHMARK.json in {Path.cwd()}", file=sys.stderr)
        return 2
    with open(manifest_path) as f:
        cell = Cell(json.load(f), args.workload)
    if not torch.cuda.is_available() or torch.cuda.device_count() < cell.chips:
        print(f"portbench: {cell.name} needs {cell.chips} CUDA device(s); "
              f"found {torch.cuda.device_count() if torch.cuda.is_available() else 0}",
              file=sys.stderr)
        return 2
    os.environ["PTX_SCENE_CACHE"] = str(SCENE_CACHE)
    print(f"# card {card_line()}", file=sys.stderr)
    out = run_cell(cell, args.seed, args.seconds, bool(args.trace))
    found = forbidden_modules()
    if found:
        print(f"portbench: the run loaded {found}", file=sys.stderr)
        return 3
    for k, c in out["checks"].items():
        print(f"check {k} {c['value']!r} limit {c['limit']!r}", file=sys.stderr)
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    sys.exit(main())
