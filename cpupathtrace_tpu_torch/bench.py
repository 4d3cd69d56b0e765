"""Benchmarks of the torch port: the reference's renderSceneBox and
renderSceneDragonBox workloads on one CUDA card (port of bench.py).

Replicates benchmark/main.cpp:34-57 (closed 2x2x2 box, 12 wall tris + 2
emissive ceiling tris, camera at (0,0,-3) aspect -1, 128x128 @ 256 spp) and
benchmark/main.cpp:59-105 (the same box + the procedural dragon stand-in as
glass IOR 1.5) at two scales: 200k triangles and the 7.2M of the real
xyzrgb_dragon (renderSceneDragonBoxFull, from the scene cache), plus the
gradient pass renderSceneBoxGrad. Throughput uses the reference's
items-processed convention: width * height * spp primary samples per
second (benchmark/main.cpp:30).

Timing convention (bench.py's): one warm frame, logged as the first frame
(it includes the kernels' build on first use), then `batches` batches of
`frames_per_batch` frames enqueued back to back with one host copy of the
last frame's sums a batch; the value is the median batch's. A frame is
`spp / spp_chunk` calls of `render_chunk` (the box: 4 chunks of 64 spp),
its sums kept on the device; chunk c of seed s draws from a
torch.Generator seeded with `rng.chunk_seed(s, c)`. The sorted driver
reads its live count to the host once a bounce, so dragon frames do not
overlap as box frames do.

Baselines (vs_baseline denominators, bench.py:39-41), the reference on a
4-core CPU compiled -O3: renderSceneBox 0.883 Mrays/s, renderSceneDragonBox
0.308, renderSceneDragonBoxFull 0.217; the gradient pass against the
forward box figure (the reference has no differentiable rendering).

Rooflines come from the card's own counters: a binned frame's bound is
`utils/roofline.py:frame_bound` over one `debug_visits` pass of the sorted
driver on the frame's own rays; the box's is `dense_frame_roofline` with
the ray-bounces that K1's counting instance counts on the frame's rays.

An on-card parity gate (`run_verify`) runs by default before the timings;
a failure marks every line with "error" and zeroes vs_baseline, and the
exit code is 1, as it is when a workload fails (its line is left out).
bench.py's comparison with its best recorded round (`vs_best_round`,
`regression_suspected`, from BENCH_r*.json) is left out on purpose: those
rounds were measured on a TPU, and no TPU figure stands beside the port's.

Usage: python -m cpupathtrace_tpu_torch.bench [--no-verify]
           [--workloads dragonfull,dragon,box,boxgrad]
The 7.2M scene is cached under PTX_SCENE_CACHE (default
~/.cache/cpupathtrace_tpu_torch). Runs on the card only: without one it
exits 1.
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import os
import sys
import time
import traceback

import numpy as np
import torch

REFERENCE_CPU_BOX_MRAYS = 0.883
REFERENCE_CPU_DRAGON_MRAYS = 0.308
REFERENCE_CPU_DRAGON_FULL_MRAYS = 0.217

WORKLOADS = ("dragonfull", "dragon", "box", "boxgrad")


@dataclasses.dataclass(frozen=True)
class Sizes:
    """bench.py's sizes, seeds aside; tests shrink them."""
    box_size: int = 128
    box_spp: int = 256
    box_spp_chunk: int = 64
    box_frames_per_batch: int = 8
    dragon_size: int = 128
    dragon_spp: int = 16
    dragon_tris: int = 200_000
    dragon_full_tris: int = 7_200_000
    max_depth: int = 40
    batches: int = 3
    frames_per_batch: int = 3
    grad_size: int = 128
    grad_spp: int = 16
    grad_max_depth: int = 12
    grad_passes: int = 5
    grad_warm: int = 2
    verify_binned_tris: int = 20000
    verify_binned_rays: int = 16384
    verify_tracer_rays: int = 65536
    verify_seeds: int = 8
    verify_max_depth: int = 12


def log(msg):
    print(msg, file=sys.stderr, flush=True)


def scene_cache_dir() -> str:
    """PTX_SCENE_CACHE, else the port's own cache directory."""
    return os.environ.get("PTX_SCENE_CACHE",
                          os.path.expanduser("~/.cache/cpupathtrace_tpu_torch"))


def _pixels(scene, options, width, height, device, pixel_order=None):
    """(x_cam, y_cam, Morton permutation or None) of the frame's pixels on
    `device`; `pixel_order` None orders them as render() does
    (`use_pixel_order`)."""
    from .integrator.film import morton_perm, pixel_camera_coords, use_pixel_order

    xg, yg = np.meshgrid(np.arange(width, dtype=np.float32),
                         np.arange(height, dtype=np.float32))
    x_cam, y_cam = pixel_camera_coords(options, xg.ravel(), yg.ravel())
    x = torch.from_numpy(np.ascontiguousarray(x_cam, np.float32)).to(device)
    y = torch.from_numpy(np.ascontiguousarray(y_cam, np.float32)).to(device)
    if pixel_order is None:
        pixel_order = use_pixel_order(scene, device)
    perm = (torch.from_numpy(morton_perm(xg.ravel(), yg.ravel())).to(device)
            if pixel_order else None)
    return x, y, perm


def _generator(seed, device):
    gen = torch.Generator(device=device)
    gen.manual_seed(seed)
    return gen


def chunk_generator(seed, c, device):
    """The generator of chunk `c` of frame `seed`."""
    from .integrator.rng import chunk_seed

    return _generator(chunk_seed(seed, c), device)


def _frame_fn(scene, camera, options, width, height, spp_chunk, n_chunks, device="cuda",
              pixel_order=None):
    """frame(seed) -> (sums [P, 4], counts [P] int32) on the device: the
    frame as `n_chunks` render_chunk calls of `spp_chunk` samples."""
    from .integrator.film import render_chunk

    x, y, perm = _pixels(scene, options, width, height, device, pixel_order)

    def frame(seed):
        total = torch.zeros((width * height, 4), device=device)
        count = torch.zeros(width * height, dtype=torch.int32, device=device)
        for c in range(n_chunks):
            s, n = render_chunk(scene, camera, options, x, y,
                                chunk_generator(seed, c, device), spp_chunk, pixel_order=perm)
            total = total + s
            count = count + n
        return total, count

    return frame


def frame_rays(scene, camera, options, width, height, spp_chunk, seed, c, device="cuda"):
    """The rays of chunk `c` of frame `seed` and the kernels' seed drawn
    after them: what render_chunk traces for that chunk."""
    from .camera.camera import shoot_rays
    from .integrator.film import _kernel_seed

    x, y, perm = _pixels(scene, options, width, height, device)
    if perm is not None:
        xs, ys = x[perm].repeat_interleave(spp_chunk), y[perm].repeat_interleave(spp_chunk)
    else:
        xs, ys = x.repeat(spp_chunk), y.repeat(spp_chunk)
    gen = chunk_generator(seed, c, device)
    rays = shoot_rays(camera, xs, ys, 1.0 / width, 1.0 / height, gen)
    return rays, _kernel_seed(gen, rays.origin.device)


def _mrays(x):
    """A rate as bench.py prints it, to 3 decimals, or to 3 significant
    digits where 3 decimals would read 0 (a slow frame's rate stays
    positive)."""
    return round(x, 3) if x >= 5e-4 else float(f"{x:.3g}")


def _batch_stats(batch_s, rays):
    """(Mrays/s of the median batch, the batches' spread over it)."""
    med = float(np.median(batch_s))
    return rays / med / 1e6, (max(batch_s) - min(batch_s)) / med


def run_workload(name, scene, camera, options, width, height, spp, spp_chunk, baseline,
                 batches=3, frames_per_batch=3, device="cuda"):
    """bench.py's metric line of workload `name`."""
    frame = _frame_fn(scene, camera, options, width, height, spp_chunk, spp // spp_chunk,
                      device)
    t0 = time.perf_counter()
    total, count = frame(0)
    total.cpu()
    first_s = time.perf_counter() - t0

    # Pipelined batches: the frames are enqueued back to back and the host
    # copy of the last one's sums waits for all of them (one stream).
    batch_s = []
    seed = 1
    rays = width * height * spp
    for b in range(batches):
        t0 = time.perf_counter()
        outs = []
        for _ in range(frames_per_batch):
            outs.append(frame(seed))
            seed += 1
        outs[-1][0].cpu()
        dt = (time.perf_counter() - t0) / frames_per_batch
        batch_s.append(dt)
        log(f"# {name} batch {b} ({frames_per_batch} frames pipelined): "
            f"{dt * 1000:.3f} ms/frame ({rays / dt / 1e6:.2f} Mrays/s)")
        total, count = outs[-1]

    img = total.cpu().numpy() / np.maximum(count.cpu().numpy(), 1)[:, None]
    log(f"# {name}: first frame {first_s:.2f}s, mean rgb {float(img[:, :3].mean()):.5f}, "
        f"alpha {float(img[:, 3].mean()):.3f}")
    mrays, spread = _batch_stats(batch_s, rays)
    return {
        "metric": f"{name}_throughput",
        "value": _mrays(mrays),
        "unit": "Mrays/s",
        "vs_baseline": round(mrays / baseline, 2),
        "best": _mrays(rays / min(batch_s) / 1e6),
        "spread_pct": round(100 * spread, 1),
        "batch_ms_per_frame": [round(t * 1000, 3) for t in batch_s],
        "frames_per_batch": frames_per_batch,
        "first_frame_s": round(first_s, 3),
    }


def roofline_binned(scene, camera, options, width, height, spp, frame_ms, seed=1,
                    device="cuda"):
    """The frame's bound from its own counters: one debug_visits pass of
    the sorted driver over frame `seed`'s rays (one chunk of `spp`), fed to
    `frame_bound`; `frame_over_bound` is the timed frame over it."""
    from .integrator.sorted_wavefront import trace_megakernel_sorted
    from .utils.roofline import frame_bound

    rays, kseed = frame_rays(scene, camera, options, width, height, spp, seed, 0, device)
    _, _, vis = trace_megakernel_sorted(scene, rays, options, kseed, debug_visits=True)
    out = frame_bound(vis.cpu(), width * height * spp, scene)
    out.update(frame_ms=frame_ms, frame_over_bound=frame_ms / out["bound_ms"])
    return out


def count_ray_bounces(scene, rays, options, seed):
    """Ray-bounces of K1's trace of `rays`: its counting instance on the
    card. On the CPU, where that instance does not exist, the live rays
    entering each bounce of the sorted driver's plain bounce on the same
    rays and seed (the same estimator, another random stream)."""
    from .integrator import megakernel as mk
    from .integrator import sorted_wavefront as sw

    dev = rays.origin.device
    if dev.type == "cuda":
        steps = torch.zeros(mk.BOUNCE_STEP_COLS, dtype=torch.int64, device=dev)
        mk.trace_megakernel(scene, rays, options, seed, bounce_steps=steps)
        return int(steps[1])
    st = sw.initial_state(rays.origin, rays.direction, seed)
    total = 0
    for depth in range(int(options.max_depth)):
        live = int((st[17] > 0.5).sum())
        if live == 0:
            break
        total += live
        sw.bounce_reference(scene, st, depth, options)
    return total


def roofline_dense(scene, camera, options, width, height, spp, spp_chunk, frame_ms, seed=1,
                   device="cuda"):
    """`dense_frame_roofline` of a box frame, its executed bounces the
    ray-bounces counted on frame `seed`'s rays (every chunk) over its paths."""
    from .utils.roofline import dense_frame_roofline

    ray_bounces = 0
    for c in range(spp // spp_chunk):
        rays, kseed = frame_rays(scene, camera, options, width, height, spp_chunk, seed, c,
                                 device)
        ray_bounces += count_ray_bounces(scene, rays, options, kseed)
    n_rays = width * height * spp
    out = dense_frame_roofline(frame_s=frame_ms / 1e3, n_rays=n_rays, n_prims=scene.n_prims,
                               executed_bounces=ray_bounces / n_rays)
    out.update(ray_bounces=ray_bounces, frame_ms=frame_ms)
    return out


def _frame_ms(res):
    """The median batch's milliseconds a frame."""
    return float(np.median(res["batch_ms_per_frame"]))


def run_dragon(sizes, camera, device="cuda", full=False, cache_dir=None):
    """renderSceneDragonBox (200k) or, with `full`, renderSceneDragonBoxFull
    (7.2M, lean, through `dragon_full_scene` and the cache under
    `cache_dir`, default `scene_cache_dir()`): the metric line with its
    roofline."""
    from .core.config import RenderOptions
    from .models.scenes import bench_dragon_scene, dragon_full_scene

    t0 = time.perf_counter()
    if full:
        name, baseline = "renderSceneDragonBoxFull", REFERENCE_CPU_DRAGON_FULL_MRAYS
        scene, hit = dragon_full_scene(cache_dir or scene_cache_dir(), sizes.dragon_full_tris,
                                       device=device)
        build_s = time.perf_counter() - t0
        log(f"# dragon-full scene ready in {build_s:.2f}s (cache "
            f"{'HIT' if hit else 'MISS, built fresh'}; {scene.n_tri} tris, "
            f"S={scene.krn_cl_bounds.shape[0]}, L={scene.krn_cluster_size})")
    else:
        name, baseline = "renderSceneDragonBox", REFERENCE_CPU_DRAGON_MRAYS
        scene = bench_dragon_scene(dragon_tris=sizes.dragon_tris, accel="binned", device=device)
        log(f"# dragon scene built in {time.perf_counter() - t0:.2f}s ({scene.n_tri} tris, "
            f"C={scene.trv_bounds.shape[0]}, L={scene.cluster_size})")
    size, spp = sizes.dragon_size, sizes.dragon_spp
    options = RenderOptions(size, size, spp, spp, epsilon=1e-3, max_depth=sizes.max_depth)
    res = run_workload(name, scene, camera, options, size, size, spp, spp, baseline,
                          sizes.batches, sizes.frames_per_batch, device)
    if full:
        res["scene_build_s"] = round(build_s, 3)
        res["scene_cache_hit"] = hit
    res["roofline"] = roofline_binned(scene, camera, options, size, size, spp,
                                      _frame_ms(res), device=device)
    log(f"# {name} roofline: {res['roofline']}")
    return res


def run_box(sizes, camera, device="cuda"):
    """renderSceneBox: the metric line with its roofline."""
    from .core.config import RenderOptions
    from .models.scenes import bench_box_scene

    scene = bench_box_scene(device=device)
    size, spp, chunk = sizes.box_size, sizes.box_spp, sizes.box_spp_chunk
    options = RenderOptions(size, size, spp, spp, epsilon=1e-3, max_depth=sizes.max_depth)
    res = run_workload("renderSceneBox", scene, camera, options, size, size, spp, chunk,
                          REFERENCE_CPU_BOX_MRAYS, sizes.batches, sizes.box_frames_per_batch,
                          device)
    res["roofline"] = roofline_dense(scene, camera, options, size, size, spp, chunk,
                                     _frame_ms(res), device=device)
    log(f"# renderSceneBox roofline: {res['roofline']}")
    return res


def run_box_grad(batches=3, frames_per_batch=5, size=128, spp=16, max_depth=12, warm=2,
                 device="cuda"):
    """Gradient-pass throughput: loss + material gradients on the box
    (size^2 @ spp a pass) through K2's record form and the replay
    (`diff.render.loss_and_grad`). The first pass draws from seed 5, pass i
    from chunk_seed(5, i), warm pass j from chunk_seed(5, 1000 + j); each
    batch waits once, on a host copy of its last loss."""
    from .core.config import RenderOptions
    from .diff.render import get_material_params, loss_and_grad
    from .integrator.rng import chunk_seed
    from .models.scenes import bench_box_scene, bench_camera

    scene = bench_box_scene(device=device)
    camera = bench_camera(device=device)
    options = RenderOptions(size, size, spp, spp, epsilon=1e-3, max_depth=max_depth)
    params = get_material_params(scene)
    target = torch.zeros((size * size, 4), device=device)

    def grad_pass(key):
        return loss_and_grad(params, scene, camera, options, target, key, spp)

    t0 = time.perf_counter()
    loss, _ = grad_pass(5)
    loss.cpu()
    first_s = time.perf_counter() - t0
    warm_outs = [grad_pass(chunk_seed(5, 1000 + j)) for j in range(warm)]
    if warm_outs:
        warm_outs[-1][0].cpu()

    rays = size * size * spp
    batch_s = []
    i = 0
    for b in range(batches):
        t0 = time.perf_counter()
        outs = []
        for _ in range(frames_per_batch):
            outs.append(grad_pass(chunk_seed(5, i)))
            i += 1
        outs[-1][0].cpu()
        dt = (time.perf_counter() - t0) / frames_per_batch
        batch_s.append(dt)
        log(f"# renderSceneBoxGrad batch {b}: {dt * 1000:.3f} ms/pass "
            f"({rays / dt / 1e6:.2f} Mrays/s fwd+bwd)")
    mrays, spread = _batch_stats(batch_s, rays)
    log(f"# renderSceneBoxGrad: first pass {first_s:.2f}s, loss {float(loss):.5f}")
    return {
        "metric": "renderSceneBoxGrad_throughput",
        "value": _mrays(mrays),
        "unit": "Mrays/s",
        "vs_baseline": round(mrays / REFERENCE_CPU_BOX_MRAYS, 2),
        "spread_pct": round(100 * spread, 1),
        "batch_ms_per_frame": [round(t * 1000, 3) for t in batch_s],
        "note": "loss+grad pass; baseline is the CPU reference's FORWARD "
                "box throughput (it has no differentiable rendering)",
        "first_frame_s": round(first_s, 3),
    }


def run_verify(binned_tris=20000, binned_rays=16384, tracer_rays=65536, n_seeds=8,
               max_depth=12, rel_tol=0.07, device="cuda"):
    """On-card parity (bench.py:322-439) in three checks: the binned wavefront (K6 + K7) against its sweep reference on every
    ray; K1, the sorted driver (K2) and the wavefront (K5 on the box) by
    their medians over `n_seeds` seeds within `rel_tol`, K1 and the sorted
    driver with equal coverage; K2's record form bit-equal to the unsorted
    driver, and the replay of its records bit-equal to its sums. Returns
    {check: passed}; the run passes when every check does."""
    from .accel.traverse import binned_intersect, binned_intersect_ref
    from .core.config import RenderOptions
    from .core.rays import Rays
    from .integrator.diff_megakernel import (
        DIFF_FIELDS,
        em_material_ids,
        replay_spectrum,
        trace_megakernel_diff,
    )
    from .integrator.megakernel import trace_megakernel
    from .integrator.sorted_wavefront import trace_megakernel_sorted
    from .integrator.wavefront import trace
    from .models.scenes import bench_box_scene, bench_dragon_scene

    checks = {}

    # The binned wavefront against the dense part + sweep, every ray.
    scene = bench_dragon_scene(dragon_tris=binned_tris, accel="binned", device=device)
    rng = np.random.default_rng(0)
    n = binned_rays
    o = rng.uniform(-0.95, 0.95, (n, 3)).astype(np.float32)
    d = rng.normal(size=(n, 3)).astype(np.float32)
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    o, d = torch.from_numpy(o).to(device), torch.from_numpy(d).to(device)
    t_k, p_k = binned_intersect(scene, o, d)
    t_r, p_r = binned_intersect_ref(scene, o, d)
    same = (p_k == p_r) | (t_k == t_r)
    log(f"# verify binned-vs-sweep on {device}: {int(same.sum())}/{n} exact")
    checks["binned_vs_sweep"] = bool(same.all())

    # The tracers on the box: single-run means of this estimator are heavy
    # tailed (bench.py:358-365), so medians over seeds are compared.
    box = bench_box_scene(device=device)
    opts = RenderOptions(64, 64, 64, 64, epsilon=1e-3, max_depth=max_depth)
    m = tracer_rays
    og = np.zeros((m, 3), np.float32)
    og[:, 2] = -2.9
    xs = rng.uniform(-0.8, 0.8, m)
    ys = rng.uniform(-0.8, 0.8, m)
    dg = np.stack([xs, ys, np.ones(m)], -1).astype(np.float32)
    dg /= np.linalg.norm(dg, axis=1, keepdims=True)
    rays = Rays(origin=torch.from_numpy(og).to(device), direction=torch.from_numpy(dg).to(device))

    def mean_rgb(spectrum):
        return float(spectrum[:, :3].mean())

    med_m = float(np.median([mean_rgb(trace_megakernel(box, rays, opts, 100 + 7 * i)[0])
                             for i in range(n_seeds)]))
    med_s = float(np.median([mean_rgb(trace_megakernel_sorted(box, rays, opts, 500 + 13 * i)[0])
                             for i in range(n_seeds)]))
    med_w = float(np.median([mean_rgb(trace(box, rays, opts, _generator(i, device))[0])
                             for i in range(n_seeds)]))
    rel = abs(med_m - med_w) / max(med_w, 1e-9)
    log(f"# verify megakernel-vs-wavefront on {device}: median {med_m:.5f} vs {med_w:.5f} "
        f"(rel {rel:.3f}, {n_seeds} seeds)")
    checks["megakernel_vs_wavefront"] = rel < rel_tol
    rel_s = abs(med_s - med_m) / max(med_m, 1e-9)
    log(f"# verify sorted-vs-megakernel on {device}: median {med_s:.5f} vs {med_m:.5f} "
        f"(rel {rel_s:.3f})")
    checks["sorted_vs_megakernel"] = rel_s < rel_tol
    # Coverage of the closed box is exact for every tracer and seed.
    s_m = trace_megakernel(box, rays, opts, 1234)[0]
    s_s = trace_megakernel_sorted(box, rays, opts, 1234)[0]
    same_cov = bool((s_s[:, 3] == s_m[:, 3]).all())
    log(f"# verify coverage sorted {'==' if same_cov else '!='} megakernel")
    checks["coverage"] = same_cov

    # The gradient path rests on two equalities: the recording forward is
    # the unsorted driver bit for bit, and the replay rebuilds its sums.
    spec_d, _, recs = trace_megakernel_diff(box, rays, opts, 1234)
    spec_u = trace_megakernel_sorted(box, rays, opts, 1234, sort=False)[0]
    same_fwd = bool(torch.equal(spec_d, spec_u))
    mats = {f: getattr(box, f) for f in DIFF_FIELDS}
    rep = replay_spectrum(mats, recs, em_material_ids(box), box.light_spectrum[:, :3],
                          int(box.n_point_lights), int(box.emissive_sample_count))
    same_rep = bool(torch.equal(rep, spec_d[:, :3]))
    log(f"# verify diff-megakernel on {device}: forward bitwise "
        f"{'==' if same_fwd else '!='} driver, replay bitwise "
        f"{'==' if same_rep else '!='} kernel")
    checks["record_forward"] = same_fwd
    checks["replay"] = same_rep
    return checks


def main(argv=None, device="cuda", sizes=Sizes(), cache_dir=None):
    """Prints one JSON line a workload (the box last); returns 0, or 1 when
    there is no card, the verify failed or a workload failed. `device`,
    `sizes` and `cache_dir` are for callers in Python (the tests); the
    command line runs bench.py's sizes on the card."""
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--verify", action="store_true", help="(default; kept for compatibility)")
    ap.add_argument("--no-verify", action="store_true", help="skip the on-card parity checks")
    ap.add_argument("--workloads", default=",".join(WORKLOADS))
    args = ap.parse_args(argv)
    workloads = args.workloads.split(",")
    unknown = sorted(set(workloads) - set(WORKLOADS))
    if unknown:
        ap.error(f"unknown workloads {unknown}; known: {','.join(WORKLOADS)}")

    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        log("bench: no CUDA device (torch.cuda.is_available() is False); the benchmark "
            "runs on the card only")
        return 1
    kind = torch.cuda.get_device_name(dev) if dev.type == "cuda" else "cpu"
    log(f"# device: {kind}")

    from .models.scenes import bench_camera

    verify_ok = None
    if not args.no_verify:
        try:
            checks = run_verify(sizes.verify_binned_tris, sizes.verify_binned_rays,
                                sizes.verify_tracer_rays, sizes.verify_seeds,
                                sizes.verify_max_depth, device=device)
            log(f"# verify checks: {checks}")
            verify_ok = all(checks.values())
        except Exception:  # noqa: BLE001 -- a crashed verify fails it; the timings go on
            log(f"# verify CRASHED:\n{traceback.format_exc()}")
            verify_ok = False
        log(f"# verify: {'PASS' if verify_ok else 'FAIL'}")

    camera = bench_camera(device=device)
    runners = {
        "dragonfull": lambda: run_dragon(sizes, camera, device, full=True, cache_dir=cache_dir),
        "dragon": lambda: run_dragon(sizes, camera, device),
        "box": lambda: run_box(sizes, camera, device),
        "boxgrad": lambda: run_box_grad(sizes.batches, sizes.grad_passes, sizes.grad_size,
                                        sizes.grad_spp, sizes.grad_max_depth, sizes.grad_warm,
                                        device),
    }
    results, failed = [], []
    # Workloads are independent: one that fails must not cost the others'
    # lines, but it fails the run.
    for name in WORKLOADS:
        if name not in workloads:
            continue
        try:
            res = runners[name]()
        except Exception:  # noqa: BLE001 -- report, keep benching, exit 1
            log(f"# {name} FAILED:\n{traceback.format_exc()}")
            failed.append(name)
            continue
        res["device"] = kind
        results.append(res)

    # The box metric prints last: it is the headline.
    results.sort(key=lambda r: r["metric"] == "renderSceneBox_throughput")
    for res in results:
        if verify_ok is not None:
            res["parity_verified"] = verify_ok
            if not verify_ok:
                # A failed parity check invalidates the number.
                res["error"] = "on-chip parity verify FAILED"
                res["vs_baseline"] = 0.0
        print(json.dumps(res), flush=True)
    if failed:
        log(f"# failed workloads: {','.join(failed)}")
    return 0 if verify_ok is not False and not failed else 1


if __name__ == "__main__":
    sys.exit(main())
