"""Smoke run of the torch port (cpupathtrace_tpu_torch) on one CUDA card.

    python chip_smoke.py [--out DIR]

Phases, one line each; any failure exits non-zero:
  1. the card: torch's device name and nvidia-smi's name + power limit
  2. build the CUDA kernels from cpupathtrace_tpu_torch/csrc with nvcc
  3. kernel vs its plain-torch twin on the card, same rays and seed
  4. golden parity: the port's render_chunk at 32x32 against the C++
     reference images in tests/golden, with tests/test_parity.py's checks
  5. the main path at full size: render() of the renderSceneBox benchmark
     (128x128 @ 256 spp, max_depth 40), with the kernel's launch count,
     frame time in Mrays/s (w*h*spp / s), one frame traced with
     torch.profiler (device time by kernel, the device's busy share) and
     the kernel's time beside the twin's at that shape
  6. the demo scene without its dragon, 256x256 adaptive 16-64 spp, thin
     lens, post-processed, written as PNG and read back
Then one JSON line with the kernels' figures and, last, the result line.
With --out, the demo PNG and every measured figure are also written there.
"""
from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import tempfile
import time

import numpy as np
import torch

BOX_W = BOX_H = 128
BOX_SPP = 256
MAX_DEPTH = 40
TIMED_FRAMES = 3
# Kernel vs twin bounds: collected equal on every ray, the spectrum within
# (rtol, atol) on >= 99.9% of rays, the mean radiance within 1e-4. Both do
# the same IEEE float32 operations in the same order (the kernel is built
# with --fmad=false; sqrtf, rsqrtf, sinf, cosf are the functions torch's
# CUDA ops call), and on an H100 they measured bit-equal on every case.
COLL_FRAC, CLOSE_FRAC, RTOL, ATOL, MEAN_REL = 1.0, 0.999, 1e-5, 1e-7, 1e-4


class SmokeFailure(RuntimeError):
    pass


def need(cond, msg):
    if not cond:
        raise SmokeFailure(msg)


def line(phase, **fields):
    print(f"[{phase}] " + json.dumps(fields, default=float), flush=True)


def nvidia_smi_name_power() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    )
    return out.stdout.strip().splitlines()[0]


def sync():
    torch.cuda.synchronize()


def cuda_ms(fn, reps):
    """Mean milliseconds of fn() over `reps` runs, by CUDA events."""
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    sync()
    return start.elapsed_time(end) / reps


def compare(kernel_spec, twin_spec):
    k, t = kernel_spec.cpu().numpy(), twin_spec.cpu().numpy()
    coll = float((k[:, 3] == t[:, 3]).mean())
    close = float(np.isclose(k, t, rtol=RTOL, atol=ATOL).all(axis=1).mean())
    mk, mt = float(k[:, :3].mean()), float(t[:, :3].mean())
    mean_rel = abs(mk - mt) / max(abs(mt), 1e-12)
    return dict(collected_equal=coll, close=close, mean_rel=mean_rel,
                max_abs_err=float(np.abs(k - t).max()), mean=mk)


def check_agreement(name, res):
    need(res["collected_equal"] >= COLL_FRAC and res["close"] >= CLOSE_FRAC
         and res["mean_rel"] <= MEAN_REL, f"{name}: kernel disagrees with twin {res}")


def phase_kernel_vs_twin(mk, scenes, Rays, RenderOptions):
    from cpupathtrace_tpu_torch.models.golden import (
        sphere_point_light_scene,
        specular_box_scene,
    )

    rng = np.random.default_rng(0)
    n = 8192
    d = rng.normal(size=(n, 3))
    fwd = d.copy()
    fwd[:, 2] = np.abs(fwd[:, 2]) + 0.2
    dirs = {k: torch.tensor(v / np.linalg.norm(v, axis=1, keepdims=True),
                            dtype=torch.float32, device="cuda")
            for k, v in (("all", d), ("forward", fwd))}
    origin = torch.zeros((n, 3), device="cuda")
    cases = [
        ("box_d3", scenes.bench_box_scene(device="cuda"), "all", 3),
        ("box_d40", scenes.bench_box_scene(device="cuda"), "all", MAX_DEPTH),
        ("specular_point_light", specular_box_scene(point_light=True, device="cuda"),
         "all", MAX_DEPTH),
        ("sphere_table_form", sphere_point_light_scene(device="cuda"), "forward", MAX_DEPTH),
    ]
    results = {}
    for name, scene, kind, depth in cases:
        rays = Rays(origin, dirs[kind])
        opts = RenderOptions(8, 8, 1, 1, epsilon=1e-3, max_depth=depth)
        k_spec, _ = mk.trace_megakernel(scene, rays, opts, 1234)
        sync()
        t_spec, _ = mk.trace_megakernel_reference(scene, rays, opts, 1234)
        res = compare(k_spec, t_spec)
        results[name] = res
        check_agreement(name, res)
    return results


def render_fixed(film, scene, camera, RenderOptions, size, spp, seed, chunk=64):
    """tests/test_parity.py:render_fixed through the port's render_chunk."""
    opts = RenderOptions(size, size, spp, spp, max_depth=MAX_DEPTH)
    xg, yg = np.meshgrid(np.arange(size, dtype=np.float32), np.arange(size, dtype=np.float32))
    x, y = film.pixel_camera_coords(opts, xg.ravel(), yg.ravel())
    x = torch.tensor(x, device="cuda")
    y = torch.tensor(y, device="cuda")
    gen = torch.Generator(device="cuda")
    gen.manual_seed(seed)
    tot = torch.zeros((size * size, 4), dtype=torch.float64, device="cuda")
    cnt = torch.zeros(size * size, dtype=torch.int64, device="cuda")
    for _ in range(spp // chunk):
        s, c = film.render_chunk(scene, camera, opts, x, y, gen, chunk)
        tot += s.double()
        cnt += c
    img = (tot / cnt.clamp_min(1)[:, None]).cpu().numpy()
    img[:, 3] = (cnt > 0).cpu().numpy().astype(np.float32)
    return img.reshape(size, size, 4).astype(np.float32)


def phase_golden(film, RenderOptions):
    from cpupathtrace_tpu_torch.models import golden

    results = {}
    for name, (fname, make_scene, make_cam, spp, seed) in golden.GOLDEN_CASES.items():
        ours = render_fixed(film, make_scene(device="cuda"), make_cam(device="cuda"),
                            RenderOptions, 32, spp, seed)
        res = golden.check_golden(name, ours, golden.read_golden(fname))
        results[name] = res
        need(res["ok"], f"golden {name} parity failed: {res}")
    return results


def phase_main_path(pt, mk, scenes):
    opts = pt.RenderOptions(BOX_W, BOX_H, BOX_SPP, BOX_SPP, epsilon=1e-3, max_depth=MAX_DEPTH)
    scene = scenes.bench_box_scene()
    camera = scenes.bench_camera()
    mk.trace_megakernel.launches = 0
    mk.trace_megakernel_reference.calls = 0
    image = pt.render(scene, camera, opts, seed=0, device="cuda")
    sync()
    launches = mk.trace_megakernel.launches
    twin_calls = mk.trace_megakernel_reference.calls
    need(launches > 0, "main path never launched the megakernel")
    need(twin_calls == 0, f"main path called the twin {twin_calls} times on the card")
    need(image.shape == (BOX_H, BOX_W, 4) and np.isfinite(image).all(), "non-finite image")
    need(bool((image[..., 3] == 1.0).all()), "closed box: alpha must be 1 everywhere")
    mean = float(image[..., :3].mean())
    need(0.01 < mean < 10.0, f"implausible box radiance {mean}")

    frames = []
    for seed in range(1, TIMED_FRAMES + 1):
        sync()
        t0 = time.perf_counter()
        pt.render(scene, camera, opts, seed=seed, device="cuda")
        sync()
        frames.append(time.perf_counter() - t0)
    frame_s = float(np.median(frames))
    mrays = BOX_W * BOX_H * BOX_SPP / frame_s / 1e6

    # The kernel alone and its twin, at the main path's shape: the frame's
    # 4.19M camera rays in one launch.
    from cpupathtrace_tpu_torch.camera.camera import shoot_rays
    from cpupathtrace_tpu_torch.integrator.film import pixel_camera_coords

    xg, yg = np.meshgrid(np.arange(BOX_W, dtype=np.float32), np.arange(BOX_H, dtype=np.float32))
    x, y = pixel_camera_coords(opts, xg.ravel(), yg.ravel())
    gen = torch.Generator(device="cuda")
    gen.manual_seed(0)
    sc = scene.to("cuda")
    rays = shoot_rays(camera.to("cuda"), torch.tensor(x, device="cuda").repeat(BOX_SPP),
                      torch.tensor(y, device="cuda").repeat(BOX_SPP),
                      1.0 / BOX_W, 1.0 / BOX_H, gen)
    tables = mk.pack_tables(sc)
    k_spec, _ = mk.trace_megakernel(sc, rays, opts, 99, tables)
    kernel_ms = cuda_ms(lambda: mk.trace_megakernel(sc, rays, opts, 99, tables), 5)
    plain_ms = cuda_ms(lambda: mk.trace_megakernel_reference(sc, rays, opts, 99, tables), 1)
    t_spec, _ = mk.trace_megakernel_reference(sc, rays, opts, 99, tables)
    agree = compare(k_spec, t_spec)
    check_agreement("main-path shape", agree)
    line("5 profile", **profile_frame(pt, scene, camera, opts))
    return dict(launches=launches, twin_calls=twin_calls, image_mean=mean,
                frame_s=frames, frame_median_s=frame_s, mrays_per_s=mrays,
                rays=int(rays.origin.shape[0]), kernel_ms=kernel_ms,
                twin_ms=plain_ms, kernel_mrays_per_s=rays.origin.shape[0] / kernel_ms / 1e3,
                agreement=agree)


def profile_frame(pt, scene, camera, opts):
    """One main-path frame under torch.profiler: device time by kernel
    name (top 6), the megakernel's share, and the device's busy share of
    the frame's wall time (the union of kernel intervals)."""
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        sync()
        t0 = time.perf_counter()
        pt.render(scene, camera, opts, seed=7, device="cuda")
        sync()
        wall_us = (time.perf_counter() - t0) * 1e6
    kernels = [e for e in prof.events() if e.device_type == torch.autograd.DeviceType.CUDA]
    need(kernels, "profiler recorded no device activity")
    by_name: dict = {}
    spans = sorted((e.time_range.start, e.time_range.end) for e in kernels)
    for e in kernels:
        key = e.name[:90]
        by_name[key] = by_name.get(key, 0.0) + e.time_range.elapsed_us()
    busy, cur_s, cur_e = 0.0, *spans[0]
    for s, e in spans[1:]:
        if s > cur_e:
            busy += cur_e - cur_s
            cur_s, cur_e = s, e
        else:
            cur_e = max(cur_e, e)
    busy += cur_e - cur_s
    total = sum(by_name.values())
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:6]
    mega = sum(v for k, v in by_name.items() if "megakernel" in k)
    return dict(wall_us=wall_us, device_kernel_us=total, device_busy_us=busy,
                busy_share=busy / wall_us, megakernel_share_of_device=mega / total,
                n_kernels=len(kernels),
                top_us=dict(top))


def phase_demo(pt, scenes, out_dir):
    w = h = 256
    scene = scenes.cornell_demo_scene(include_dragon=False)
    camera = scenes.cornell_demo_camera(w, h)
    opts = scenes.cornell_demo_options(w, h)
    sync()
    t0 = time.perf_counter()
    image = pt.render(scene, camera, opts, seed=0, device="cuda")
    sync()
    frame_s = time.perf_counter() - t0
    need(np.isfinite(image).all() and image.shape == (h, w, 4), "demo image not finite")
    need(float(image[..., :3].mean()) > 0.01, "demo image is black")
    post = pt.post_process(torch.from_numpy(image).cuda()).cpu().numpy()
    need(np.isfinite(post).all(), "post-processed demo not finite")
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(out_dir or tmp, "demo_torch.png")
        pt.write_rgb_image(path, post)
        back = pt.read_rgb_image(path)
        size = os.path.getsize(path)
    want = np.clip(np.round(post * 255.0), 0, 255) / 255.0
    need(back.shape == (h, w, 4) and np.allclose(back, want, atol=1e-6), "PNG read-back differs")
    return dict(frame_s=frame_s, png_bytes=size, image_mean=float(image[..., :3].mean()),
                spp=f"{opts.min_sample_count}-{opts.max_sample_count}")


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--out", help="also write the demo PNG and all figures here")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device (torch.cuda.is_available() is False)",
              file=sys.stderr)
        return 1

    import cpupathtrace_tpu_torch as pt
    from cpupathtrace_tpu_torch import _build
    from cpupathtrace_tpu_torch.core.rays import Rays
    from cpupathtrace_tpu_torch.integrator import film
    from cpupathtrace_tpu_torch.integrator import megakernel as mk
    from cpupathtrace_tpu_torch.models import scenes

    if args.out:
        os.makedirs(args.out, exist_ok=True)
    kind = torch.cuda.get_device_name(0)
    smi = nvidia_smi_name_power()
    report = {"device": kind, "nvidia_smi": smi, "torch": torch.__version__,
              "cuda": torch.version.cuda}
    print(f"[1 device] {kind} | count {torch.cuda.device_count()} | torch "
          f"{torch.__version__} cuda {torch.version.cuda}", flush=True)
    print(smi, flush=True)

    t0 = time.perf_counter()
    _build.load("megakernel")
    ptxas = " | ".join(
        ln.strip() for ln in _build.ptxas_report.get("megakernel", "").splitlines()
        if "Used" in ln or "spill" in ln
    )
    report["build"] = dict(seconds=time.perf_counter() - t0,
                           nvcc_seconds=_build.build_seconds["megakernel"], ptxas=ptxas)
    line("2 build", **report["build"])

    report["kernel_vs_twin"] = phase_kernel_vs_twin(mk, scenes, Rays, pt.RenderOptions)
    line("3 kernel vs twin", **report["kernel_vs_twin"])
    report["golden"] = phase_golden(film, pt.RenderOptions)
    line("4 golden parity", **report["golden"])
    report["main_path"] = phase_main_path(pt, mk, scenes)
    line("5 main path", **report["main_path"])
    report["demo"] = phase_demo(pt, scenes, args.out)
    line("6 demo", **report["demo"])

    main_path = report["main_path"]
    kernels = {"kernels": [{
        "name": "megakernel",
        "route": "cuda",
        "source": "cpupathtrace_tpu_torch/csrc/megakernel.cu",
        "replaces": "cpupathtrace_tpu/integrator/pallas_megakernel.py:345",
        "launches": main_path["launches"],
        "max_abs_err": main_path["agreement"]["max_abs_err"],
        "ms": main_path["kernel_ms"],
        "plain_ms": main_path["twin_ms"],
    }]}
    if args.out:
        with open(os.path.join(args.out, "chip_smoke.json"), "w") as f:
            json.dump(dict(report, **kernels), f, indent=1, default=float)
    print(json.dumps(kernels), flush=True)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                             "count": torch.cuda.device_count()}}),
          flush=True)
    return 0


if __name__ == "__main__":
    try:
        sys.exit(main())
    except SmokeFailure as e:
        print(f"chip_smoke FAILED: {e}", file=sys.stderr, flush=True)
        sys.exit(1)
