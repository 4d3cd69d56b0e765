"""Smoke run of the torch port (cpupathtrace_tpu_torch) on one CUDA card.

    python chip_smoke.py [--out DIR]

Phases, one line each; any failure exits non-zero:
  1. the card: torch's device name and nvidia-smi's name + power limit
  2. build the CUDA kernels from cpupathtrace_tpu_torch/csrc with nvcc,
     with ptxas's registers, shared memory and spills per kernel instance
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
  7. the binned build of renderSceneDragonBox (200k-triangle stand-in
     dragon), timed by stage (mesh, BVH and which builder ran, packing,
     upload), then the cluster query (K4) against its plain version on
     65,536 rays in the box, nearest and any-hit
  8. the bounce kernel (K2) against its twin: one bounce from the same
     state at depth 0 and 5 (all 18 planes), whole paths on 16,384 camera
     rays at max_depth 40, and the kernel's sorted and unsorted runs
  9. the binned main path at full size: render() of renderSceneDragonBox
     (128x128 @ 16 spp, max_depth 40) with K2's launch count, frame time
     and Mrays/s, K2 and sort+gather milliseconds per bounce (and the
     driver without the sort, for the host sync per bounce), one profiled
     frame, and K2's time beside the twin's on the frame's 262,144 rays
     at depth 1
 10. the demo scene with its 20k-triangle dragon (binned), as phase 6
 11. the dense query K5 against its plain version on 262,144 rays (the box
     frame's camera rays and one bounce's worth of random rays in the box):
     prim, hit and t equal on every ray; K5's and the plain version's ms
 12. the wavefront forward on the card (PTX_NO_MEGAKERNEL=1): golden parity
     at 32x32 with phase 4's checks, and the box at 128x128 @ 16 spp,
     max_depth 12 against K1's frame (mean within 4 standard errors), with
     K5's launch count > 0 and no plain calls
 13. K2's record form against its twin on the box (dense) and the 200k
     dragon (binned) at depths 0 and 5: the 18 planes and the record planes
     of live rays equal, and the recording forward bit-equal to the plain
 14. renderSceneBoxGrad at full width (bench.py:253-260: 128x128 @ 16 spp,
     max_depth 12, zero target) through `loss_and_grad`: ms per pass
     (median of 3 batches of 5 after 2 warm passes), Mrays/s fwd+bwd, K2
     record launches, peak memory, one profiled pass; the same pass with
     PTX_DIFF_MEGAKERNEL=0 (the wavefront and K5); analytic vs finite
     difference gradients for both routes at 32x32 @ 8 spp, max_depth 4
 15. inverse_render: 10 Adam steps at 32x32 @ 8 spp on the card
 16. the binned wavefront's kernels against their plain versions on the
     200k dragon built with lean=False: the candidate scan K6 and the
     cluster-major intersect K7 on phase 7's 65,536 rays (round 1 and a
     round with a nonzero lower bound) and on the first round of the
     dragon frame's 262,144 camera rays (the main path's shape, timed as
     the mean of 10 whole calls and as the best of 10 on the card alone);
     the whole `binned_intersect` (nearest; any-hit with t_max and a live
     mask) against `binned_intersect_ref` on a chunk of rays and against
     the cluster query K4 on every ray; rounds per query and host reads
 17. K8's entry point (`binned_intersect_cluster_major`, K7's kernel on
     its binned pairs) on the same rays: its compute stage against its
     plain version, its result against `binned_intersect`'s
 18. the binned wavefront at full width: render() of renderSceneDragonBox
     (128x128 @ 16 spp, max_depth 40) on the lean=False build with
     PTX_NO_MEGAKERNEL=1: frame time, K6 / K7 / K5 launches with no plain
     call, one profiled frame, the mean against the sorted driver's frame
     (within 4 standard errors); the scene rebuilt under PTX_KRN_MAX_TRIS
     below its small count (no kernel records) reaching the wavefront by
     the dispatch alone; the lean build through the wavefront (K4 + K5)
 19. gradients on the 200k dragon: loss_and_grad at 32x32 @ 8 spp,
     max_depth 4, through the wavefront (PTX_DIFF_MEGAKERNEL=0) and the
     record route, each against central differences
 20. K1's binned while-loop form against its twin on the first 16,384 of
     the dragon frame's camera rays: spectrum and collected bit-equal, the
     traversal counters (debug_visits) equal column by column; then the
     whole 262,144-ray chunk: the kernel timed, counted and held against
     the twin; all of it again on the dragon rebuilt (lean) with
     PTX_KRN_CLUSTER=128, its K1 ms beside the ms at 56 rows
 21. the 200k dragon (128x128 @ 16 spp, max_depth 40) through render()
     with PTX_SORTED_WAVEFRONT=0 (K1's binned form) beside the default
     sorted driver, in turns: frame ms, Mrays/s, launches and host reads
     of each, the means within 4 standard errors, one profiled K1 frame;
     K2's bound over one counted sorted frame
 22. the box (128x128 @ 256 spp) through the sorted driver
     (PTX_SORTED_WAVEFRONT=1, K2's dense form): frame ms, its mean within 4
     standard errors of K1's frame
 23. the microbenchmarks X1-X5 (cpupathtrace_tpu_torch/experiments):
     each kernel against its plain version on check inputs whose output
     depends on the work (X1: flags that differ by block and every ray's
     least slab entry, equal; X5: seeded x and tables and every launched
     block's staged copy, equal, in both staging instances at K1's
     launch shape and on the persistent grid; X3 within rtol 1e-6 serial
     / outer, 1e-5 matmul; X2: tiles that take and skip the conditional
     updates, outputs and per-tile update counts equal in all four
     instances; X4 on seeds 0 and 1 and on tie inputs (the first of two
     rows holding a column's minimum): fma equal in C, R and X, the TF32
     forms within 1e-5 of sum |B A| of their emulation, R and X the min
     and first argmin of the kernel's own C), then each TPU script's
     sweep on the script's own
     inputs; X5 also K1's box tables with each staging at K1's shape and
     on the persistent grid (its blocks per SM),
     K1's shape without tables and torch.add; X4 each form beside
     torch.matmul; both beside the card's name and power limit
Then the script's seconds, one JSON line with the kernels' figures and,
last, the result line. Bounds of the traversal kernels (K1's binned form,
K2, K4) come from their counters: filled record rows tested x 64 + slab
tests below the root gate x 31 + per query the root test (31) + per
ray-bounce (the nearest queries) 300 and the dense part's tests x 64.
With --out, the demo PNGs and every measured figure are also written there.
"""
from __future__ import annotations

import argparse
import json
import os
import re
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
# The binned path: the renderSceneDragonBox frame and the query/whole-path
# shapes of phases 7 and 8.
DRAGON_TRIS = 200000
DRAGON_W = DRAGON_H = 128
DRAGON_SPP = 16
QUERY_RAYS = 65536
PATH_RAYS = 16384
# K4 vs its plain version: hit mask and prim equal on >= QUERY_FRAC of the
# rays, t within QUERY_RTOL where both hit. K2 vs its twin: every state
# plane equal on >= PLANE_FRAC of the rays; whole paths at the K1 bounds
# above. Both kernels do their plain versions' float32 operations in the
# same order; on an H100 they measured equal on every ray.
QUERY_FRAC, QUERY_RTOL, PLANE_FRAC = 0.999, 1e-6, 0.999
KERNELS = ("megakernel", "bounce", "cluster_query", "dense_query", "binned_cand",
           "binned_isect", "bvh_build", "exp_supscan", "exp_record_variants", "exp_smem_tables",
           "exp_cond_fat", "exp_dot_formulations")
# The least time the card could take for a kernel's work: the larger of
# its bytes over HBM's rate
# and its float32 operations over the FP32 peak (NVIDIA H100 SXM data
# sheet), with the JAX package's work model (utils/roofline.py:84-116):
# 64 flops per ray-primitive test, ~300 estimator flops per ray-bounce.
H100_BYTES_S = 3.35e12
H100_FP32_S = 67e12
H100_TF32_S = 495e12
TEST_FLOPS = 64
VERTEX_FLOPS = 300
# renderSceneBoxGrad (bench.py:253-260) and the FD / inverse-rendering
# checks on the card.
GRAD_W = GRAD_H = 128
GRAD_SPP = 16
GRAD_DEPTH = 12
K5_RAYS = 262144
# The binned wavefront (phases 16-19): candidate slots per round, the
# share of rays on which the pipeline and the independent cluster query K4
# must give the same prim (they may differ only on exact-t ties between
# triangles), the rays of the oracle's chunk, and the work model of K6
# (csrc/binned_cand.cu): per scanned ray and cluster the slab test (12
# subtract / multiply, 10 min / max, the entry's compare and select, 7
# compares of the box, the best hit and the bound: 31 operations), and only
# for the clusters that pass it the insertion (per slot 3 compares and 4
# selects; 3 compares and 2 selects for the overflow row).
CAND_M = 4
K4_AGREE = 0.999
# X3's check and the record tests of its line in the kernels' JSON (the
# plain versions loop over records in Python).
X3_CHECK_RECORDS = 256
REF_RAYS = 8192
SLAB_FLOPS = 31
RAY_ROWS_BYTES = 36  # K6 reads 9 float planes per ray
# K1's binned form against its twin: the rays of the bit-equality and
# counter check (the twin's traversal is the slow part), and the record rows
# of the second build it runs on (bench.py's PTX_KRN_CLUSTER for 7.2M).
K1B_CHECK_RAYS = 16384
K1B_WIDE_CLUSTER = "128"
# X2's check and the iterations of its line in the kernels' JSON (the
# sweep's longer run).
X2_ITERS = 1024


def insert_flops(m):
    return 7 * m + 5


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


def phase_main_path(pt, mk, sw, scenes):
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
    n = int(rays.origin.shape[0])
    ray_bounces, live = twin_ray_bounces(sw, sc, camera.to("cuda"), opts, n)
    k1_bound = bound(n * (24 + 16), ray_bounces * (
        tests_per_vertex(sc, sc.n_tri + sc.n_sph) * TEST_FLOPS + VERTEX_FLOPS))
    return dict(launches=launches, twin_calls=twin_calls, image_mean=mean,
                frame_s=frames, frame_median_s=frame_s, mrays_per_s=mrays,
                rays=n, kernel_ms=kernel_ms,
                twin_ms=plain_ms, kernel_mrays_per_s=n / kernel_ms / 1e3,
                agreement=agree, ray_bounces=ray_bounces, twin_live_per_bounce=live, **k1_bound)


def bound(nbytes, flops, tf32_flops=0):
    """bound_ms / bound_by of a kernel call that must move `nbytes` and do
    `flops` float32 operations (and `tf32_flops` on the tensor cores, which
    run beside the float32 units)."""
    t_b = nbytes / H100_BYTES_S
    t_f = max(flops / H100_FP32_S, tf32_flops / H100_TF32_S)
    return dict(bound_ms=max(t_b, t_f) * 1e3, bound_by="bytes" if t_b >= t_f else "operations",
                bound_bytes=nbytes, bound_flops=flops, bound_tf32_flops=tf32_flops)


def traversal_flops(visits):
    """Operations of the cluster traversal from its counters (a [..., 9]
    K1 / K2 array or a [..., 4] K4 one): 64 per filled record row tested
    and 31 per slab test below the root gate (hypers, the superclusters of
    entered hypers, the clusters of descends; any-hit walks stop at the
    occluding row and box)."""
    from cpupathtrace_tpu_torch.accel import kernel_traverse as kt

    v = visits.reshape(-1, visits.shape[-1]).sum(0).long().tolist()
    if len(v) == kt.GEO_VISIT_COLS:
        descends, records, slabs, rows = (v[n] + v[s] for n, s in zip(kt.NEAR_COLS, kt.SHADOW_COLS))
    else:
        descends, records, slabs, rows = v
    return rows * TEST_FLOPS + slabs * SLAB_FLOPS, dict(
        descends=descends, record_visits=records, slab_tests=slabs, rows_tested=rows,
        counters=v)


def ray_bounces(visits):
    """The nearest queries of a K1 / K2 count: one per ray-bounce."""
    from cpupathtrace_tpu_torch.accel.kernel_traverse import QUERY_COL

    return int(visits[..., QUERY_COL].sum())


def vertex_flops(scene):
    """The estimator's work per ray-bounce outside the cluster walks: ~300
    operations, and for the nearest and each shadow query the dense part's
    tests (big partition and spheres) and the cluster set's root test."""
    queries = tests_per_vertex(scene, 1)
    return (VERTEX_FLOPS + tests_per_vertex(scene, scene.n_big + scene.n_sph) * TEST_FLOPS
            + queries * SLAB_FLOPS)


def tests_per_vertex(scene, n_prims):
    """Primitive tests of one ray-bounce of the estimator: the nearest query
    and one shadow query per point light and per emitter draw."""
    return (1 + scene.n_point_lights + scene.emissive_sample_count) * n_prims


def profile_frame(pt, scene, camera, opts, kernel="megakernel"):
    """One main-path frame under torch.profiler (see profile_run)."""
    return profile_run(lambda: pt.render(scene, camera, opts, seed=7, device="cuda"), kernel)


def profile_run(fn, kernel):
    """fn() under torch.profiler: device time by kernel name (top 6), the
    share of kernels named `kernel`, and the device's busy share of the
    wall time (the union of kernel intervals)."""
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        sync()
        t0 = time.perf_counter()
        fn()
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
    mine = sum(v for k, v in by_name.items() if kernel in k)
    return dict(wall_us=wall_us, device_kernel_us=total, device_busy_us=busy,
                busy_share=busy / wall_us, **{f"{kernel}_share_of_device": mine / total},
                n_kernels=len(kernels),
                top_us=dict(top))


def phase_demo(pt, scenes, out_dir, include_dragon=False):
    w = h = 256
    scene = scenes.cornell_demo_scene(include_dragon=include_dragon)
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
        name = "demo_dragon_torch.png" if include_dragon else "demo_torch.png"
        path = os.path.join(out_dir or tmp, name)
        pt.write_rgb_image(path, post)
        back = pt.read_rgb_image(path)
        size = os.path.getsize(path)
    want = np.clip(np.round(post * 255.0), 0, 255) / 255.0
    need(back.shape == (h, w, 4) and np.allclose(back, want, atol=1e-6), "PNG read-back differs")
    return dict(frame_s=frame_s, png_bytes=size, image_mean=float(image[..., :3].mean()),
                spp=f"{opts.min_sample_count}-{opts.max_sample_count}")


def phase_dragon_build(scenes):
    """Build renderSceneDragonBox on the card, timed by stage."""
    from cpupathtrace_tpu_torch.accel.build import build_bvh
    from cpupathtrace_tpu_torch.scene.scene import BUILD_SECONDS

    runs0 = dict(build_bvh.runs)
    t0 = time.perf_counter()
    scene = scenes.bench_dragon_scene(dragon_tris=DRAGON_TRIS, device="cuda")
    total = time.perf_counter() - t0
    ran = {k: build_bvh.runs[k] - runs0[k] for k in runs0}
    need(scene.accel == "binned" and scene.has_kernel_records, "dragon scene is not binned")
    need(ran["native"] >= 1, f"the C++ BVH builder did not run at {scene.n_tri} triangles: {ran}")
    return scene, dict(seconds=total, stages_s=dict(BUILD_SECONDS), bvh_builder_runs=ran,
                       n_tri=scene.n_tri, n_big=scene.n_big,
                       records=list(scene.krn_records.shape),
                       cl_bounds=list(scene.krn_cl_bounds.shape),
                       sup_bounds=list(scene.krn_sup_bounds.shape),
                       hyp_bounds=list(scene.krn_hyp_bounds.shape),
                       cull_modes=[scene.krn_cull_mode, scene.krn_big_cull_mode],
                       record_mb=scene.krn_records.numel() * 4 / 1e6)


def phase_cluster_query(kt, scene):
    """K4 through `cluster_intersect` (its path: counts zeroed just before,
    read just after), then against the plain traversal on the same rays."""
    rng = np.random.default_rng(1)
    n = QUERY_RAYS
    o = torch.tensor(rng.uniform(-0.95, 0.95, (n, 3)), dtype=torch.float32, device="cuda")
    d = rng.normal(size=(n, 3))
    d = torch.tensor(d / np.linalg.norm(d, axis=1, keepdims=True), dtype=torch.float32,
                     device="cuda")
    lim = torch.tensor(rng.uniform(0.05, 1.5, n), dtype=torch.float32, device="cuda")
    kt.cluster_intersect.launches = 0
    kt.cluster_intersect_reference.calls = 0
    t_k, p_k = kt.cluster_intersect(scene, o, d)
    ta_k, pa_k = kt.cluster_intersect(scene, o, d, lim, any_hit=True)
    sync()
    launches = kt.cluster_intersect.launches
    need(launches == 2 and kt.cluster_intersect_reference.calls == 0,
         f"cluster query path: {launches} launches, "
         f"{kt.cluster_intersect_reference.calls} plain calls")
    t0 = time.perf_counter()
    t_p, p_p = kt.cluster_intersect_reference(scene, o, d)
    sync()
    plain_s = time.perf_counter() - t0
    ta_p, pa_p = kt.cluster_intersect_reference(scene, o, d, lim, any_hit=True)
    out = dict(launches=launches, rays=n, plain_ms=plain_s * 1e3)
    for name, tk, pk, tp, pp in (("nearest", t_k, p_k, t_p, p_p),
                                 ("any_hit", ta_k, pa_k, ta_p, pa_p)):
        hit_eq = float(((pk >= 0) == (pp >= 0)).float().mean())
        prim_eq = float((pk == pp).float().mean())
        both = (pk >= 0) & (pp >= 0)
        err = float((tk[both] - tp[both]).abs().max()) if bool(both.any()) else 0.0
        rel_ok = bool(torch.allclose(tk[both], tp[both], rtol=QUERY_RTOL, atol=0.0))
        out[name] = dict(hits=int((pp >= 0).sum()), hit_equal=hit_eq, prim_equal=prim_eq,
                         max_abs_err=err)
        need(hit_eq >= QUERY_FRAC and prim_eq >= QUERY_FRAC and rel_ok and int(both.sum()) > 1000,
             f"cluster query {name} disagrees with its plain version: {out[name]}")
    out["max_abs_err"] = max(out["nearest"]["max_abs_err"], out["any_hit"]["max_abs_err"])
    out["ms"] = cuda_ms(lambda: kt.cluster_intersect(scene, o, d), 5)
    out["any_hit_ms"] = cuda_ms(lambda: kt.cluster_intersect(scene, o, d, lim, any_hit=True), 5)
    # The bound from the nearest query's counters, held against the plain
    # version's counts of the same rays.
    *_, vis = kt.cluster_intersect(scene, o, d, debug_visits=True)
    *_, vis_p = kt.cluster_intersect_reference(scene, o, d, debug_visits=True)
    need(torch.equal(vis, vis_p), "K4's counters differ from the plain version's")
    flops, counts = traversal_flops(vis)
    out.update(counts=counts, **bound(n * (24 + 4 + 8), flops + n * SLAB_FLOPS))
    return out


def camera_state(sw, camera, opts, spp, seed):
    """(rays, the sorted driver's fresh [18, R] state) of a frame of `spp`
    camera rays per pixel (sample-major), as render() shoots them."""
    from cpupathtrace_tpu_torch.camera.camera import shoot_rays
    from cpupathtrace_tpu_torch.integrator.film import pixel_camera_coords

    w, h = opts.image_width, opts.image_height
    xg, yg = np.meshgrid(np.arange(w, dtype=np.float32), np.arange(h, dtype=np.float32))
    x, y = pixel_camera_coords(opts, xg.ravel(), yg.ravel())
    gen = torch.Generator(device="cuda")
    gen.manual_seed(seed)
    rays = shoot_rays(camera, torch.tensor(x, device="cuda").repeat(spp),
                      torch.tensor(y, device="cuda").repeat(spp), 1.0 / w, 1.0 / h, gen)
    return rays, sw.initial_state(rays.origin, rays.direction, seed)


def compare_planes(k_state, t_state):
    """Per state plane, the share of rays whose bits are equal, and the
    largest difference of the float planes (plane 0 holds rng bits)."""
    same = (k_state.view(torch.int32) == t_state.view(torch.int32)).float().mean(1)
    err = float((k_state[1:] - t_state[1:]).abs().nan_to_num(0.0).max())
    return dict(min_plane_equal=float(same.min()),
                planes_equal=[round(float(v), 6) for v in same], max_abs_err=err)


def phase_bounce_vs_twin(sw, mk, scenes, scene, RenderOptions):
    camera = scenes.bench_camera(device="cuda")
    opts = RenderOptions(DRAGON_W, DRAGON_H, 1, 1, epsilon=1e-3, max_depth=MAX_DEPTH)
    tables = mk.pack_tables(scene)
    rays, st = camera_state(sw, camera, opts, 1, 77)
    need(rays.origin.shape[0] == PATH_RAYS, "camera state size")
    out = {}
    for depth in (0, 5):
        k, t = st.clone(), st.clone()
        sw.bounce(scene, k, torch.tensor([77, depth], dtype=torch.int32, device="cuda"),
                  opts, tables)
        sw.bounce_reference(scene, t, depth, opts, tables)
        sync()
        res = compare_planes(k, t)
        res["alive_after"] = int((k[17] > 0.5).sum())
        out[f"bounce_depth{depth}"] = res
        need(res["min_plane_equal"] >= PLANE_FRAC, f"K2 at depth {depth} disagrees: {res}")
        st = k
    ks, _ = sw.trace_megakernel_sorted(scene, rays, opts, 5)
    ku, _ = sw.trace_megakernel_sorted(scene, rays, opts, 5, sort=False)
    tw, _ = sw.trace_megakernel_sorted(scene, rays, opts, 5, reference=True)
    sync()
    out["sorted_equals_unsorted"] = bool(torch.equal(ks.view(torch.int32), ku.view(torch.int32)))
    need(out["sorted_equals_unsorted"], "K2's sorted run differs from its unsorted run")
    out["paths"] = compare(ks, tw)
    check_agreement("K2 whole paths", out["paths"])
    return out


def phase_dragon_main_path(pt, sw, mk, scenes, scene):
    opts = pt.RenderOptions(DRAGON_W, DRAGON_H, DRAGON_SPP, DRAGON_SPP, epsilon=1e-3,
                            max_depth=MAX_DEPTH)
    camera = scenes.bench_camera(device="cuda")
    sw.bounce.launches = 0
    sw.bounce_reference.calls = 0
    mk.trace_megakernel.launches = 0
    image = pt.render(scene, camera, opts, seed=0, device="cuda")
    sync()
    launches = sw.bounce.launches
    twin_calls = sw.bounce_reference.calls
    need(launches > 0, "dragon main path never launched the bounce kernel")
    need(twin_calls == 0, f"dragon main path called the twin {twin_calls} times on the card")
    need(mk.trace_megakernel.launches == 0, "dragon main path ran the dense megakernel")
    need(image.shape == (DRAGON_H, DRAGON_W, 4) and np.isfinite(image).all(), "non-finite image")
    need(bool((image[..., 3] == 1.0).all()), "closed box: alpha must be 1 everywhere")
    mean = float(image[..., :3].mean())
    need(0.005 < mean < 10.0, f"implausible dragon-box radiance {mean}")

    frames = []
    for seed in range(1, TIMED_FRAMES + 1):
        sync()
        t0 = time.perf_counter()
        pt.render(scene, camera, opts, seed=seed, device="cuda")
        sync()
        frames.append(time.perf_counter() - t0)
    frame_s = float(np.median(frames))
    n_paths = DRAGON_W * DRAGON_H * DRAGON_SPP

    # The sorted driver alone on the frame's 262,144 camera rays: its wall
    # time, and K2 / sort+gather per bounce by CUDA events.
    rays, st = camera_state(sw, camera, opts, DRAGON_SPP, 3)
    tables = mk.pack_tables(scene)
    sw.trace_megakernel_sorted(scene, rays, opts, 3, tables)
    sync()
    t0 = time.perf_counter()
    sw.trace_megakernel_sorted(scene, rays, opts, 3, tables)
    sync()
    driver_s = time.perf_counter() - t0
    timing: dict = {}
    sw.trace_megakernel_sorted(scene, rays, opts, 3, tables, timing=timing)
    events_ms = sum(timing["bounce_ms"]) + sum(timing["sort_ms"])
    # The same without the sort: its event time after each K2 is the one
    # host sync of the bounce (the alive count) with its two small kernels.
    sync()
    t0 = time.perf_counter()
    sw.trace_megakernel_sorted(scene, rays, opts, 3, tables, sort=False)
    sync()
    unsorted = dict(driver_wall_ms=(time.perf_counter() - t0) * 1e3)
    timing_u: dict = {}
    sw.trace_megakernel_sorted(scene, rays, opts, 3, tables, sort=False, timing=timing_u)
    unsorted.update(bounce_ms=timing_u["bounce_ms"], sync_ms=timing_u["sort_ms"])

    # K2 beside its twin on the frame's state after its first bounce: the
    # input of depth 1, where the bounces of the frame cost most (the first
    # bounce only meets the walls and the front of the dragon).
    sw.bounce(scene, st, torch.tensor([3, 0], dtype=torch.int32, device="cuda"), opts, tables)
    sd = torch.tensor([3, 1], dtype=torch.int32, device="cuda")
    k = st.clone()
    sw.bounce(scene, k, sd, opts, tables)
    t = st.clone()
    sync()
    t0 = time.perf_counter()
    sw.bounce_reference(scene, t, 1, opts, tables)
    sync()
    plain_ms = (time.perf_counter() - t0) * 1e3
    agree = compare_planes(k, t)
    agree["alive_in"] = int((st[17] > 0.5).sum())
    need(agree["min_plane_equal"] >= PLANE_FRAC, f"K2 at the main path's shape: {agree}")
    copies = iter([st.clone() for _ in range(5)])
    kernel_ms = cuda_ms(lambda: sw.bounce(scene, next(copies), sd, opts, tables), 5)
    profile = profile_frame(pt, scene, camera, opts, kernel="bounce_kernel")
    line("9 profile", **profile)
    # The bound of the timed bounce from its counters (the counting form on
    # the same state), held against the twin's counts.
    live = agree["alive_in"]
    n_blocks = -(-n_paths // 1024)
    vk = torch.zeros((n_blocks, sw.GEO_VISIT_COLS), dtype=torch.int32, device="cuda")
    vt = torch.zeros_like(vk)
    sw.bounce(scene, st.clone(), sd, opts, tables, visits=vk)
    sw.bounce_reference(scene, st.clone(), 1, opts, tables, visits=vt)
    need(torch.equal(vk, vt), "K2's counters differ from its twin's")
    need(ray_bounces(vk) == live, f"K2 counted {ray_bounces(vk)} nearest queries, {live} live")
    flops, counts = traversal_flops(vk)
    k2_bound = dict(counts=counts, **bound(live * 144 + (n_paths - live) * 4,
                                           flops + live * vertex_flops(scene)))
    return dict(launches=launches, twin_calls=twin_calls, image_mean=mean, frame_s=frames,
                frame_median_s=frame_s, mrays_per_s=n_paths / frame_s / 1e6, paths=n_paths,
                bounces=len(timing["bounce_ms"]), bounce_ms=timing["bounce_ms"],
                sort_gather_ms=timing["sort_ms"], driver_wall_ms=driver_s * 1e3,
                driver_events_ms=events_ms, unsorted=unsorted,
                kernel_ms=kernel_ms, twin_ms=plain_ms, agreement=agree,
                busy_share=profile["busy_share"], **k2_bound)


def twin_ray_bounces(sw, scene, camera, opts, n_rays):
    """Executed ray-bounces of a K1 frame of `n_rays` paths, from the live
    counts of the twin's bounce at a reduced size (128x128 @ 1 spp, the
    same estimator and stopping rules), scaled to `n_rays`."""
    from cpupathtrace_tpu_torch.core.config import RenderOptions

    small = RenderOptions(128, 128, 1, 1, epsilon=opts.epsilon, max_depth=opts.max_depth)
    _, st = camera_state(sw, camera, small, 1, 3)
    counts = []
    for depth in range(int(opts.max_depth)):
        live = int((st[17] > 0.5).sum())
        if live == 0:
            break
        counts.append(live)
        sw.bounce_reference(scene, st, depth, opts)
    return sum(counts) * n_rays / st.shape[1], counts


def phase_dense_query(oi, sw, scenes, RenderOptions):
    """K5 through `dense_intersect` (counts zeroed just before, read just
    after), then against its plain version on the same 262,144 rays."""
    scene = scenes.bench_box_scene()
    opts = RenderOptions(GRAD_W, GRAD_H, 8, 8)
    rays, _ = camera_state(sw, scenes.bench_camera(), opts, 8, 11)
    n_cam = rays.origin.shape[0]
    rng = np.random.default_rng(2)
    d2 = rng.normal(size=(K5_RAYS - n_cam, 3))
    d2 /= np.linalg.norm(d2, axis=1, keepdims=True)
    o = torch.cat([rays.origin, torch.tensor(rng.uniform(-0.95, 0.95, (K5_RAYS - n_cam, 3)),
                                             dtype=torch.float32, device="cuda")])
    d = torch.cat([rays.direction, torch.tensor(d2, dtype=torch.float32, device="cuda")])
    oi.dense_intersect.launches = 0
    oi.dense_intersect_reference.calls = 0
    t_k, p_k = oi.dense_intersect(scene, o, d)
    sync()
    launches, plain_calls = oi.dense_intersect.launches, oi.dense_intersect_reference.calls
    need(launches == 1 and plain_calls == 0,
         f"dense query path: {launches} launches, {plain_calls} plain calls")
    t_p, p_p = oi.dense_intersect_reference(scene, o, d)
    res = dict(rays=K5_RAYS, camera_rays=n_cam, launches=launches, hits=int((p_p >= 0).sum()),
               prim_equal=float((p_k == p_p).float().mean()),
               hit_equal=float(((p_k >= 0) == (p_p >= 0)).float().mean()),
               t_equal=float((t_k == t_p).float().mean()),
               max_abs_err=float((t_k - t_p).abs().max()))
    need(res["prim_equal"] == res["hit_equal"] == res["t_equal"] == 1.0,
         f"K5 disagrees with its plain version: {res}")
    tables = oi.dense_tables(scene)
    res["ms"] = cuda_ms(lambda: oi.dense_intersect(scene, o, d, tables), 20)
    res["plain_ms"] = cuda_ms(lambda: oi.dense_intersect_reference(scene, o, d, tables), 5)
    res.update(bound(K5_RAYS * (24 + 8), K5_RAYS * (scene.n_tri + scene.n_sph) * TEST_FLOPS))
    return res


def phase_wavefront(pt, film, oi, mk, scenes, RenderOptions):
    """The forward wavefront on the card (PTX_NO_MEGAKERNEL=1): golden
    parity, then the box frame against K1's."""
    opts = RenderOptions(GRAD_W, GRAD_H, GRAD_SPP, GRAD_SPP, epsilon=1e-3, max_depth=GRAD_DEPTH)
    scene, camera = scenes.bench_box_scene(), scenes.bench_camera()
    os.environ["PTX_NO_MEGAKERNEL"] = "1"
    try:
        oi.dense_intersect.launches = 0
        oi.dense_intersect_reference.calls = 0
        mk.trace_megakernel.launches = 0
        golden_res = phase_golden(film, RenderOptions)
        sync()
        t0 = time.perf_counter()
        img_w = pt.render(scene, camera, opts, seed=1, device="cuda")
        sync()
        frame_s = time.perf_counter() - t0
        k5, plain, k1 = (oi.dense_intersect.launches, oi.dense_intersect_reference.calls,
                         mk.trace_megakernel.launches)
    finally:
        del os.environ["PTX_NO_MEGAKERNEL"]
    need(k5 > 0 and plain == 0 and k1 == 0,
         f"wavefront path: K5 {k5} launches, {plain} plain calls, K1 {k1} launches")
    img_k = pt.render(scene, camera, opts, seed=2, device="cuda")
    need(np.isfinite(img_w).all() and bool((img_w[..., 3] == 1.0).all()), "wavefront box image")
    diff_px = img_w[..., :3].mean(-1).astype(np.float64) - img_k[..., :3].mean(-1)
    se = float(diff_px.std() / np.sqrt(diff_px.size))
    res = dict(golden=golden_res, k5_launches=k5, plain_calls=plain, box_frame_s=frame_s,
               box_mean_wavefront=float(img_w[..., :3].mean()),
               box_mean_k1=float(img_k[..., :3].mean()), mean_diff=float(diff_px.mean()),
               std_err=se)
    need(abs(res["mean_diff"]) <= 4 * se, f"wavefront box frame differs from K1's: {res}")
    return res


def compare_records(rk, rt, live):
    same = (rk[:, live].view(torch.int32) == rt[:, live].view(torch.int32)).float().mean(1)
    return [round(float(v), 6) for v in same], float((rk[:, live] - rt[:, live]).abs().max())


def phase_records(sw, mk, scenes, dragon, RenderOptions):
    """K2's record form against its twin from the same state, dense (the
    box) and binned (the 200k dragon); the recording forward against the
    plain kernel."""
    camera = scenes.bench_camera()
    opts = RenderOptions(DRAGON_W, DRAGON_H, 1, 1, epsilon=1e-3, max_depth=MAX_DEPTH)
    out = {}
    for name, scene in (("box", scenes.bench_box_scene()), ("dragon", dragon)):
        tables = mk.pack_tables(scene)
        _, st = camera_state(sw, camera, opts, 1, 77)
        n = st.shape[1]
        nd = sw.n_diff_records(scene.n_point_lights, scene.emissive_sample_count)
        for depth in (0, 5):
            k, t, plain = st.clone(), st.clone(), st.clone()
            rk = torch.empty((nd, n), device="cuda")
            rt = torch.empty((nd, n), device="cuda")
            sd = torch.tensor([77, depth], dtype=torch.int32, device="cuda")
            sw.bounce(scene, k, sd, opts, tables, records=rk)
            sw.bounce(scene, plain, sd, opts, tables)
            sw.bounce_reference(scene, t, depth, opts, tables, records=rt)
            sync()
            res = compare_planes(k, t)
            res["records_equal"], res["records_max_abs_err"] = compare_records(rk, rt, st[17] > 0.5)
            res["recording_equals_plain"] = bool(torch.equal(k.view(torch.int32),
                                                             plain.view(torch.int32)))
            res["alive_in"] = int((st[17] > 0.5).sum())
            out[f"{name}_depth{depth}"] = res
            need(res["min_plane_equal"] == 1.0 and min(res["records_equal"]) == 1.0
                 and res["recording_equals_plain"], f"K2 record form, {name} depth {depth}: {res}")
            st = k
    out["max_abs_err"] = max(max(v["max_abs_err"], v["records_max_abs_err"])
                             for v in out.values())
    return out


def grad_checks(diff, golden, RenderOptions, scene=None, cam=None, entries=None):
    """Analytic vs central-difference gradients on the card at 32x32 @ 8
    spp, max_depth 4 (test_diff.py:66's rtol 0.05, atol 1e-4), for the
    route PTX_DIFF_MEGAKERNEL currently selects; by default on the inward
    box, its wall albedo and its light's emission."""
    if scene is None:
        scene, cam = golden.inward_box_scene(), golden.box_camera()
    opts = RenderOptions(32, 32, 8, 8, max_depth=4)
    target = diff.render_image_diff(scene, cam, opts, 99, 8).detach()
    params = diff.get_material_params(scene)
    _, g = diff.loss_and_grad(params, scene, cam, opts, target, 0, 8)
    out = {}
    for field, idx in entries or (("mat_diffuse", (1, 0)), ("mat_emission", (2, 1))):
        fd = diff.finite_difference_grad(params, scene, cam, opts, target, 0, 8, field, idx,
                                         eps=2e-3)
        an = float(g[field][idx])
        out[f"{field}{list(idx)}"] = dict(analytic=an, fd=fd)
        need(np.isfinite(an) and abs(an - fd) <= 1e-4 + 0.05 * abs(fd),
             f"gradient vs FD on the card: {field}{idx} {an} vs {fd}")
    return out


def phase_box_grad(diff, sw, oi, scenes, golden, RenderOptions):
    """renderSceneBoxGrad through loss_and_grad (bench.py:240-319), the
    record route and then the wavefront route."""
    scene, camera = scenes.bench_box_scene(), scenes.bench_camera()
    opts = RenderOptions(GRAD_W, GRAD_H, GRAD_SPP, GRAD_SPP, epsilon=1e-3, max_depth=GRAD_DEPTH)
    params = diff.get_material_params(scene)
    target = torch.zeros((GRAD_W * GRAD_H, 4), device="cuda")
    n_rays = GRAD_W * GRAD_H * GRAD_SPP

    def one(key):
        return diff.loss_and_grad(params, scene, camera, opts, target, key, GRAD_SPP)

    def counts_zero():
        sw.bounce.launches = sw.bounce.record_launches = sw.bounce_reference.calls = 0
        oi.dense_intersect.launches = oi.dense_intersect_reference.calls = 0

    def counts():
        return dict(k2=sw.bounce.launches, k2_records=sw.bounce.record_launches,
                    k2_twin=sw.bounce_reference.calls, k5=oi.dense_intersect.launches,
                    k5_plain=oi.dense_intersect_reference.calls)

    def run_route(batches, per_batch, warm):
        counts_zero()
        torch.cuda.reset_peak_memory_stats()
        loss, g = one(5)
        sync()
        res = dict(counts=counts(), peak_gb=torch.cuda.max_memory_allocated() / 1e9,
                   loss=float(loss), grad_diffuse_wall=[float(v) for v in g["mat_diffuse"][1, :3]],
                   grad_emission_panel=[float(v) for v in g["mat_emission"][2, :3]])
        need(np.isfinite(res["loss"]) and all(torch.isfinite(v).all() for v in g.values())
             and float(g["mat_diffuse"][1].abs().sum()) > 0, f"gradient pass: {res}")
        for j in range(warm):
            one(1000 + j)
        sync()
        batch_ms, i = [], 0
        for _ in range(batches):
            t0 = time.perf_counter()
            for _ in range(per_batch):
                one(i)
                i += 1
            sync()
            batch_ms.append((time.perf_counter() - t0) / per_batch * 1e3)
        med = float(np.median(batch_ms))
        res.update(batch_ms_per_pass=batch_ms, ms_per_pass=med,
                   mrays_per_s_fwd_bwd=n_rays / med / 1e3)
        return res

    out = {"rays_per_pass": n_rays}
    out["replay"] = run_route(3, 5, 2)
    c = out["replay"]["counts"]
    need(c["k2_records"] > 0 and c["k2_twin"] == 0,
         f"renderSceneBoxGrad did not run K2's record form alone: {c}")
    out["replay"]["profile"] = profile_run(lambda: one(99), "bounce_kernel")
    out["replay"]["fd"] = grad_checks(diff, golden, RenderOptions)
    os.environ["PTX_DIFF_MEGAKERNEL"] = "0"
    try:
        out["wavefront"] = run_route(1, 3, 1)
        c = out["wavefront"]["counts"]
        need(c["k5"] > 0 and c["k5_plain"] == 0 and c["k2"] == 0,
             f"renderSceneBoxGrad's wavefront route: {c}")
        out["wavefront"]["profile"] = profile_run(lambda: one(98), "dense_query")
        out["wavefront"]["fd"] = grad_checks(diff, golden, RenderOptions)
    finally:
        del os.environ["PTX_DIFF_MEGAKERNEL"]

    # K2's record form alone on the pass's rays at depth 1, beside its twin.
    from cpupathtrace_tpu_torch.integrator import megakernel as mk

    tables = mk.pack_tables(scene)
    _, st = camera_state(sw, camera, opts, GRAD_SPP, 5)
    nd = sw.n_diff_records(scene.n_point_lights, scene.emissive_sample_count)
    rec = torch.empty((nd, n_rays), device="cuda")
    sw.bounce(scene, st, torch.tensor([5, 0], dtype=torch.int32, device="cuda"), opts, tables,
              records=rec)
    sd = torch.tensor([5, 1], dtype=torch.int32, device="cuda")
    k, t = st.clone(), st.clone()
    rk, rt = torch.empty_like(rec), torch.empty_like(rec)
    sw.bounce(scene, k, sd, opts, tables, records=rk)
    sync()
    t0 = time.perf_counter()
    sw.bounce_reference(scene, t, 1, opts, tables, records=rt)
    sync()
    kr = dict(plain_ms=(time.perf_counter() - t0) * 1e3, alive_in=int((st[17] > 0.5).sum()))
    kr.update(compare_planes(k, t))
    kr["records_equal"], kr["records_max_abs_err"] = compare_records(rk, rt, st[17] > 0.5)
    need(kr["min_plane_equal"] == 1.0 and min(kr["records_equal"]) == 1.0,
         f"K2 record form at the gradient pass's shape: {kr}")
    copies = iter([st.clone() for _ in range(5)])
    kr["ms"] = cuda_ms(lambda: sw.bounce(scene, next(copies), sd, opts, tables, records=rk), 5)
    live = kr["alive_in"]
    kr.update(bound(live * 144 + (n_rays - live) * 4 + n_rays * nd * 4,
                    live * (tests_per_vertex(scene, scene.n_tri + scene.n_sph) * TEST_FLOPS
                            + VERTEX_FLOPS)))
    out["record_kernel"] = kr
    return out


def phase_inverse_render(diff, golden, RenderOptions):
    """A few Adam steps of inverse_render on the card: the wall albedo from
    0.3 toward the target's 1.0."""
    scene, cam = golden.inward_box_scene(), golden.box_camera()
    opts = RenderOptions(32, 32, 8, 8, max_depth=4)
    target = diff.render_image_diff(scene, cam, opts, 7, 16).detach()
    init = {"mat_diffuse": scene.mat_diffuse.clone()}
    init["mat_diffuse"][1, :3] = 0.3
    sync()
    t0 = time.perf_counter()
    rec, losses = diff.inverse_render(scene, cam, opts, target, init, steps=10,
                                      learning_rate=0.05, spp=8)
    sync()
    res = dict(seconds=time.perf_counter() - t0, losses=[float(v) for v in losses],
               albedo=[float(v) for v in rec["mat_diffuse"][1, :3]])
    need(np.isfinite(losses).all() and losses[-1] < losses[0]
         and min(res["albedo"]) > 0.3, f"inverse_render did not move: {res}")
    return res


def query_rays_phase7(n=QUERY_RAYS):
    """Phase 7's rays (origins uniform in the box, uniform directions) and
    its shadow limits, from the same seed."""
    rng = np.random.default_rng(1)
    o = torch.tensor(rng.uniform(-0.95, 0.95, (n, 3)), dtype=torch.float32, device="cuda")
    d = rng.normal(size=(n, 3))
    d = torch.tensor(d / np.linalg.norm(d, axis=1, keepdims=True), dtype=torch.float32,
                     device="cuda")
    lim = torch.tensor(rng.uniform(0.05, 1.5, n), dtype=torch.float32, device="cuda")
    return o, d, lim


def first_round_rays(tt, scene, o, d):
    """K6's ray planes in `binned_intersect`'s first round: the rays that
    enter the small partition's box before their dense-part hit, with that
    hit as their bound and no lower bound yet."""
    tables = tt.binned_tables(scene)
    t0, _ = tt._dense_part(scene, o, d, tables)
    entry = tt._root_entry(scene, o, d)
    idx = torch.nonzero((entry >= 0.0) & (entry < t0)).squeeze(1)
    ninf = torch.full((idx.numel(),), float("-inf"), device="cuda")
    return tt.pack_rays(o[idx], d[idx], t0[idx], ninf, ninf)


def bits_equal(a, b):
    return bool(torch.equal(a.contiguous().view(torch.int32), b.contiguous().view(torch.int32)))


def max_err(a, b):
    """Largest |a - b| over the finite entries (0 for none)."""
    e = (a - b).nan_to_num(0.0, 0.0, 0.0).abs()
    return float(e.max()) if e.numel() else 0.0


def capture_main_path_inputs(pt, tt, scenes, dragon):
    """The largest K6 and K7 inputs of one wavefront frame of the dragon
    (phase 18's main path, rendered here once more): the shapes the main
    path gives the kernels. The frame's camera rays end on the box's
    two-sided front wall, so the dragon is reached from bounce 2 on."""
    opts = pt.RenderOptions(DRAGON_W, DRAGON_H, DRAGON_SPP, DRAGON_SPP, epsilon=1e-3,
                            max_depth=MAX_DEPTH)
    k6, k7 = tt.candidates, tt.isect
    seen = {}

    def cand(bounds, rays, m):
        if rays.shape[1] > seen.get("k6", (torch.empty(0, 0),))[0].shape[1]:
            seen["k6"] = (rays.clone(), m)
        return k6(bounds, rays, m)

    def isect(blocks, rays, offs):
        if rays.shape[1] > seen.get("k7", (torch.empty(0, 0),))[0].shape[1]:
            seen["k7"] = (rays.clone(), offs.clone())
        return k7(blocks, rays, offs)

    # The wrappers count their launches through their module's names,
    # which name these stand-ins while they are in place.
    cand.launches = isect.launches = 0
    tt.candidates, tt.isect = cand, isect
    os.environ["PTX_NO_MEGAKERNEL"] = "1"
    try:
        pt.render(dragon, scenes.bench_camera(), opts, seed=11, device="cuda")
        sync()
    finally:
        tt.candidates, tt.isect = k6, k7
        del os.environ["PTX_NO_MEGAKERNEL"]
    return seen["k6"], seen["k7"]


def check_k6(tt, bounds, rays, m, what):
    ik, ek = tt.candidates(bounds, rays, m)
    sync()
    ip, ep = tt.candidates_reference(bounds, rays, m)
    res = dict(rays=int(rays.shape[1]), m=m, ids_equal=bool(torch.equal(ik, ip)),
               entries_equal=bits_equal(ek, ep), kept=int((ik[:m] >= 0).sum()),
               overflow=int((ik[m] >= 0).sum()),
               max_abs_err=max_err(ek, ep))
    need(res["ids_equal"] and res["entries_equal"], f"K6 {what} disagrees: {res}")
    return res, ik, ek


def check_k7(tt, blocks, pair_rays, offs, what):
    tk, pk = tt.isect(blocks, pair_rays, offs)
    sync()
    tp, pp = tt.isect_reference(blocks, pair_rays, offs)
    n = int(offs[-1])
    res = dict(pairs=n, hits=int((pk[:n] >= 0).sum()), t_equal=bits_equal(tk, tp),
               prim_equal=bool(torch.equal(pk, pp)),
               max_abs_err=max_err(tk[:n], tp[:n]))
    need(res["t_equal"] and res["prim_equal"] and res["hits"] > 0, f"K7 {what} disagrees: {res}")
    return res


def k6_bound(tt, bounds, rays, m):
    """K6's bound on this input: the slab test for each (scanned ray,
    cluster) pair, the insertion only for the pairs that pass the test
    (counted here with the plain version's slab arithmetic)."""
    c = bounds.shape[0]
    cf = torch.arange(c, device=rays.device, dtype=torch.float32)[:, None]
    scanned = passed = 0
    for a in range(0, rays.shape[1], 8192):
        ox, oy, oz, dx, dy, dz, best, t_lo, id_lo = rays[:, a:a + 8192]
        entry, box_ok = tt._slab_entries(bounds, ox, oy, oz, tt._inv_dir(dx), tt._inv_dir(dy),
                                         tt._inv_dir(dz))
        after = (entry > t_lo) | ((entry == t_lo) & (cf > id_lo))
        scan = t_lo < float("inf")  # the kernel skips the other rays
        scanned += int(scan.sum())
        passed += int((box_ok & (entry < best) & after & scan).sum())
    n = rays.shape[1]
    return dict(scanned=scanned, passed=passed,
                **bound(n * (RAY_ROWS_BYTES + 8 * (m + 1)) + c * 32,
                        scanned * c * SLAB_FLOPS + passed * insert_flops(m)))


def k7_bound(tt, blocks, n_pairs, counts):
    """K7's bound from a run's pairs (`counts` [C] per cluster): each pair
    tests only its cluster's triangles (the rows with a prim; padding rows
    are no triangles), and each cluster with pairs is read once."""
    rows = (blocks[..., tt.C_PRIM] >= 0).sum(1).long()
    counts = counts.long()
    tests = int((counts * rows).sum())
    read_rows = int(rows[counts > 0].sum())
    return dict(tests=tests, **bound(n_pairs * (24 + 8) + read_rows * 64, tests * TEST_FLOPS))


def phase_binned_kernels(pt, tt, scenes, dragon, best_ms):
    """K6 and K7 against their plain versions, then the whole pipeline
    against its oracle and against K4."""
    o, d, lim = query_rays_phase7()
    c, l = dragon.trv_blocks.shape[0], dragon.trv_blocks.shape[1]
    out = dict(clusters=c, cluster_size=l)
    rays = first_round_rays(tt, dragon, o, d)
    for m in (1, CAND_M):
        out[f"k6_round1_m{m}"], ik, ek = check_k6(tt, dragon.trv_bounds, rays, m, f"m={m}")
    # A later round: the bound advanced past round 1's last valid slot.
    valid = ik[:CAND_M] >= 0
    last = valid.sum(0).clamp_min(1) - 1
    t_lo = torch.where(valid[0], ek.gather(0, last[None])[0], float("inf"))
    id_lo = torch.where(valid[0], ik.gather(0, last[None])[0].float(), float("inf"))
    later = rays.clone()
    later[7], later[8] = t_lo, id_lo
    out["k6_round2"], _, _ = check_k6(tt, dragon.trv_bounds, later, CAND_M, "round 2")
    need(out["k6_round2"]["kept"] > 0, "K6's later round kept no candidate")
    pair_rays, offs, _ = tt.bin_pairs(rays, ik, c, CAND_M)
    out["k7_round1"] = check_k7(tt, dragon.trv_blocks, pair_rays, offs, "round 1")

    # The main path's shapes: the largest K6 and K7 inputs of a wavefront
    # frame, the kernels timed beside their plain versions.
    (frays, fm), (fpairs, foffs) = capture_main_path_inputs(pt, tt, scenes, dragon)
    # `ms`: the mean of 10 whole calls by events, the wrapper's host time
    # in; `best_ms`: the least of 10 calls timed on the card alone
    # (experiments.best_ms), as the microbenchmarks are.
    k6, _, _ = check_k6(tt, dragon.trv_bounds, frays, fm, "at the main path's shape")
    k6["ms"] = cuda_ms(lambda: tt.candidates(dragon.trv_bounds, frays, fm), 10)
    k6["best_ms"] = best_ms(lambda: tt.candidates(dragon.trv_bounds, frays, fm), 10)
    k6["plain_ms"] = cuda_ms(lambda: tt.candidates_reference(dragon.trv_bounds, frays, fm), 1)
    k6.update(k6_bound(tt, dragon.trv_bounds, frays, fm))
    out["k6_frame"] = k6
    k7 = check_k7(tt, dragon.trv_blocks, fpairs, foffs, "at the main path's shape")
    k7["ms"] = cuda_ms(lambda: tt.isect(dragon.trv_blocks, fpairs, foffs), 10)
    k7["best_ms"] = best_ms(lambda: tt.isect(dragon.trv_blocks, fpairs, foffs), 10)
    k7["plain_ms"] = cuda_ms(lambda: tt.isect_reference(dragon.trv_blocks, fpairs, foffs), 1)
    k7.update(k7_bound(tt, dragon.trv_blocks, k7["pairs"], foffs[1:] - foffs[:-1]))
    out["k7_frame"] = k7

    # The whole query: against the oracle on a chunk, against K4 on all.
    reads0, rounds0 = tt.binned_intersect.host_reads, tt.binned_intersect.rounds
    tb, pb = tt.binned_intersect(dragon, o, d, m=CAND_M)
    sync()
    out["rounds_per_query"] = tt.binned_intersect.rounds - rounds0
    out["host_reads_per_query"] = tt.binned_intersect.host_reads - reads0
    tr, pr = tt.binned_intersect_ref(dragon, o[:REF_RAYS], d[:REF_RAYS])
    tq, pq = tt.krn_intersect(dragon, o, d)
    out["nearest"] = dict(
        hits=int((pb >= 0).sum()),
        ref_rays=REF_RAYS, ref_prim_equal=float((pb[:REF_RAYS] == pr).float().mean()),
        ref_t_equal=float((tb[:REF_RAYS] == tr).float().mean()),
        k4_prim_equal=float((pb == pq).float().mean()),
        k4_t_equal=float((tb == tq).float().mean()))
    need(out["nearest"]["ref_prim_equal"] == 1.0 and out["nearest"]["k4_prim_equal"] >= K4_AGREE,
         f"binned_intersect (nearest) disagrees: {out['nearest']}")
    live = torch.tensor(np.random.default_rng(5).random(QUERY_RAYS) < 0.5, device="cuda")
    ta, pa = tt.binned_intersect(dragon, o, d, t_max=lim, live=live, any_hit=True, m=CAND_M)
    _, par = tt.binned_intersect_ref(dragon, o[:REF_RAYS], d[:REF_RAYS], t_max=lim[:REF_RAYS])
    _, paq = tt.krn_intersect(dragon, o, d, t_max=lim, live=live, any_hit=True)
    lc = live[:REF_RAYS]
    out["any_hit"] = dict(
        live=int(live.sum()), occluded=int(((pa >= 0) & live).sum()),
        ref_occlusion_equal=float(((pa[:REF_RAYS] >= 0) == (par >= 0))[lc].float().mean()),
        k4_occlusion_equal=float(((pa >= 0) == (paq >= 0))[live].float().mean()),
        hits_within_t_max=bool(((pa < 0) | (ta < lim))[live].all()))
    need(out["any_hit"]["ref_occlusion_equal"] == 1.0 and out["any_hit"]["hits_within_t_max"]
         and out["any_hit"]["k4_occlusion_equal"] >= K4_AGREE,
         f"binned_intersect (any-hit) disagrees: {out['any_hit']}")
    out["query_ms"] = cuda_ms(lambda: tt.binned_intersect(dragon, o, d, m=CAND_M), 3)
    out["k4_query_ms"] = cuda_ms(lambda: tt.krn_intersect(dragon, o, d), 3)
    out["max_abs_err"] = max(out[k]["max_abs_err"] for k in ("k6_round1_m1", "k6_round2",
                                                             "k6_frame"))
    return out, (tb, pb)


def phase_cluster_major(cm, binned, tt, oi, dragon, nearest):
    """K8's entry point: its compute stage (K7's kernel on the binned
    pairs, counted by K7's wrapper where it launches) against its plain
    version, its result against binned_intersect's."""
    o, d, _ = query_rays_phase7()
    blocks = cm.cluster_blocks(dragon)
    ids, _ = binned.generate_candidates(dragon, o, d, CAND_M)
    tt.isect.launches = tt.isect_reference.calls = cm._test_candidates.calls = 0
    tk, pk = cm.test_candidates(blocks, o, d, ids)
    sync()
    need(tt.isect.launches == 1 and tt.isect_reference.calls == cm._test_candidates.calls == 0,
         "K8's compute stage did not launch its kernel alone")
    tp, pp = cm._test_candidates(blocks, o, d, ids)
    pairs = int((ids >= 0).sum())
    c = blocks.shape[0]
    res = dict(pairs=pairs, t_equal=bits_equal(tk, tp), prim_equal=bool(torch.equal(pk, pp)),
               max_abs_err=max_err(tk, tp), hits=int((pk >= 0).sum()))
    need(res["t_equal"] and res["prim_equal"], f"K8 disagrees with its plain version: {res}")
    res["ms"] = cuda_ms(lambda: cm.test_candidates(blocks, o, d, ids), 5)
    res["plain_ms"] = cuda_ms(lambda: cm._test_candidates(blocks, o, d, ids), 1)
    res.update(k7_bound(tt, blocks, pairs, torch.bincount(ids[ids >= 0].long(), minlength=c)))
    tt.isect.launches = 0
    t8, p8 = cm.binned_intersect_cluster_major(dragon, o, d, CAND_M, blocks)
    sync()
    res["launches"] = tt.isect.launches
    need(res["launches"] > 0, "K8's entry point launched no kernel")
    # K8's entry point intersects the cluster blocks (the small partition)
    # and the spheres, not the big triangles: where binned_intersect's
    # nearest is not a big triangle the two give the same prim, and where
    # it is, K8 finds nothing nearer. Both are exact nearest-hit
    # intersectors, so they may differ only in which of two triangles at
    # exactly the same t they report. On a chunk, K8 against its own
    # oracle, the sweep over the same blocks.
    tb, pb = nearest
    big = torch.isin(pb, dragon.big_prim[dragon.big_prim >= 0].long())
    same = (p8 == pb) | (t8 == tb)
    ts, ps = oi.sweep_intersect(dragon, o[:REF_RAYS], d[:REF_RAYS])
    res.update(entry_small_rays=int((~big).sum()),
               entry_small_agree=float(same[~big].float().mean()),
               entry_small_prim_equal=float((p8 == pb)[~big].float().mean()),
               entry_big_not_nearer=bool(((p8 < 0) | (t8 >= tb))[big].all()),
               sweep_agree=float(((p8[:REF_RAYS] == ps) | (t8[:REF_RAYS] == ts)).float().mean()),
               sweep_prim_equal=float((p8[:REF_RAYS] == ps).float().mean()))
    need(res["entry_small_agree"] == 1.0 and res["entry_big_not_nearer"]
         and res["sweep_agree"] == 1.0 and res["entry_small_rays"] > 1000,
         f"K8's entry point disagrees with binned_intersect: {res}")
    return res


def binned_counts(tt, oi, sw, mk, kt):
    return dict(k6=tt.candidates.launches, k6_plain=tt.candidates_reference.calls,
                k7=tt.isect.launches, k7_plain=tt.isect_reference.calls,
                k5=oi.dense_intersect.launches, k5_plain=oi.dense_intersect_reference.calls,
                k4=kt.cluster_intersect.launches, k4_plain=kt.cluster_intersect_reference.calls,
                k2=sw.bounce.launches, k1=mk.trace_megakernel.launches)


def binned_counts_zero(tt, oi, sw, mk, kt):
    tt.candidates.launches = tt.candidates_reference.calls = 0
    tt.isect.launches = tt.isect_reference.calls = 0
    oi.dense_intersect.launches = oi.dense_intersect_reference.calls = 0
    kt.cluster_intersect.launches = kt.cluster_intersect_reference.calls = 0
    sw.bounce.launches = mk.trace_megakernel.launches = 0


def phase_binned_wavefront(pt, tt, oi, sw, mk, kt, scenes, dragon):
    """renderSceneDragonBox through the binned wavefront (render(), the
    main path of this phase), then the dispatch to it without kernel
    records, then the lean build through K4."""
    opts = pt.RenderOptions(DRAGON_W, DRAGON_H, DRAGON_SPP, DRAGON_SPP, epsilon=1e-3,
                            max_depth=MAX_DEPTH)
    camera = scenes.bench_camera()
    out = {}
    os.environ["PTX_NO_MEGAKERNEL"] = "1"
    try:
        binned_counts_zero(tt, oi, sw, mk, kt)
        reads0, rounds0 = tt.binned_intersect.host_reads, tt.binned_intersect.rounds
        sync()
        t0 = time.perf_counter()
        img_w = pt.render(dragon, camera, opts, seed=1, device="cuda")
        sync()
        frames = [time.perf_counter() - t0]
        counts = binned_counts(tt, oi, sw, mk, kt)
        out.update(counts=counts, host_reads=tt.binned_intersect.host_reads - reads0,
                   rounds=tt.binned_intersect.rounds - rounds0)
        for seed in (2, 3):
            sync()
            t0 = time.perf_counter()
            pt.render(dragon, camera, opts, seed=seed, device="cuda")
            sync()
            frames.append(time.perf_counter() - t0)
        out["profile"] = profile_run(
            lambda: pt.render(dragon, camera, opts, seed=7, device="cuda"), "binned_")
    finally:
        del os.environ["PTX_NO_MEGAKERNEL"]
    c = out["counts"]
    need(c["k6"] > 0 and c["k7"] > 0 and c["k5"] > 0 and c["k6_plain"] == c["k7_plain"]
         == c["k5_plain"] == 0 and c["k2"] == c["k1"] == c["k4"] == 0,
         f"the binned wavefront's main path: {c}")
    need(img_w.shape == (DRAGON_H, DRAGON_W, 4) and np.isfinite(img_w).all()
         and bool((img_w[..., 3] == 1.0).all()), "binned wavefront image")
    img_k = pt.render(dragon, camera, opts, seed=4, device="cuda")  # K2, the sorted driver
    diff_px = img_w[..., :3].mean(-1).astype(np.float64) - img_k[..., :3].mean(-1)
    se = float(diff_px.std() / np.sqrt(diff_px.size))
    n_paths = DRAGON_W * DRAGON_H * DRAGON_SPP
    med = float(np.median(frames))
    out.update(frame_s=frames, frame_median_s=med, mrays_per_s=n_paths / med / 1e6,
               mean_wavefront=float(img_w[..., :3].mean()), mean_k2=float(img_k[..., :3].mean()),
               mean_diff=float(diff_px.mean()), std_err=se)
    need(abs(out["mean_diff"]) <= 4 * se, f"binned wavefront frame differs from K2's: {out}")

    # No kernel records: the scene rebuilt under PTX_KRN_MAX_TRIS below its
    # small count reaches the wavefront by the dispatch alone.
    os.environ["PTX_KRN_MAX_TRIS"] = "1000"
    try:
        bare = scenes.bench_dragon_scene(dragon_tris=DRAGON_TRIS)
    finally:
        del os.environ["PTX_KRN_MAX_TRIS"]
    need(not bare.has_kernel_records and not mk.megakernel_supported(bare),
         "the scene built under PTX_KRN_MAX_TRIS still has kernel records")
    low = pt.RenderOptions(DRAGON_W, DRAGON_H, 4, 4, epsilon=1e-3, max_depth=MAX_DEPTH)
    binned_counts_zero(tt, oi, sw, mk, kt)
    t0 = time.perf_counter()
    img = pt.render(bare, camera, low, seed=5, device="cuda")
    sync()
    c = binned_counts(tt, oi, sw, mk, kt)
    out["no_records"] = dict(frame_s=time.perf_counter() - t0, counts=c,
                             mean=float(img[..., :3].mean()))
    need(c["k6"] > 0 and c["k7"] > 0 and c["k2"] == c["k1"] == 0 and c["k6_plain"] == 0
         and np.isfinite(img).all(), f"no-records dragon did not take the wavefront: {c}")

    # The lean build through the wavefront: krn_intersect, K4 and K5.
    lean = scenes.bench_dragon_scene(dragon_tris=DRAGON_TRIS, lean=True)
    os.environ["PTX_NO_MEGAKERNEL"] = "1"
    try:
        binned_counts_zero(tt, oi, sw, mk, kt)
        t0 = time.perf_counter()
        img = pt.render(lean, camera, low, seed=6, device="cuda")
        sync()
    finally:
        del os.environ["PTX_NO_MEGAKERNEL"]
    c = binned_counts(tt, oi, sw, mk, kt)
    out["lean"] = dict(frame_s=time.perf_counter() - t0, counts=c, mean=float(img[..., :3].mean()))
    need(c["k4"] > 0 and c["k5"] > 0 and c["k6"] == c["k7"] == c["k2"] == 0
         and c["k4_plain"] == 0 and np.isfinite(img).all(),
         f"lean dragon through the wavefront: {c}")
    return out


def phase_dragon_grad(diff, golden, sw, tt, scenes, dragon, RenderOptions):
    """Gradients on the 200k dragon against central differences: the
    wavefront route (the binned wavefront) and the record route (K2)."""
    camera = scenes.bench_camera()
    entries = (("mat_diffuse", (1, 0)), ("mat_emission", (2, 1)))  # box walls, light
    out = {}
    os.environ["PTX_DIFF_MEGAKERNEL"] = "0"
    try:
        tt.candidates.launches = sw.bounce.record_launches = 0
        out["wavefront"] = grad_checks(diff, golden, RenderOptions, dragon, camera, entries)
        out["wavefront"]["k6_launches"] = tt.candidates.launches
        need(tt.candidates.launches > 0 and sw.bounce.record_launches == 0,
             "the dragon's wavefront gradients did not run the binned wavefront")
    finally:
        del os.environ["PTX_DIFF_MEGAKERNEL"]
    sw.bounce.record_launches = 0
    out["record"] = grad_checks(diff, golden, RenderOptions, dragon, camera, entries)
    out["record"]["k2_record_launches"] = sw.bounce.record_launches
    need(sw.bounce.record_launches > 0, "the dragon's record-route gradients did not run K2")
    return out


def phase_k1_binned(mk, sw, scenes, dragon, RenderOptions):
    """K1's binned form against its twin on the dragon frame's camera rays,
    on phase 7's build (56-triangle records) and on the dragon rebuilt with
    PTX_KRN_CLUSTER=128 (lean: the megakernel tables alone)."""
    opts = RenderOptions(DRAGON_W, DRAGON_H, DRAGON_SPP, DRAGON_SPP, epsilon=1e-3,
                         max_depth=MAX_DEPTH)
    rays, _ = camera_state(sw, scenes.bench_camera(device="cuda"), opts, DRAGON_SPP, 21)
    out = k1_binned_run(mk, dragon, rays, opts)
    old = os.environ.get("PTX_KRN_CLUSTER")
    os.environ["PTX_KRN_CLUSTER"] = K1B_WIDE_CLUSTER
    try:
        t0 = time.perf_counter()
        wide = scenes.bench_dragon_scene(dragon_tris=DRAGON_TRIS, lean=True, device="cuda")
        build_s = time.perf_counter() - t0
    finally:
        os.environ.pop("PTX_KRN_CLUSTER")
        if old is not None:
            os.environ["PTX_KRN_CLUSTER"] = old
    rows = int(K1B_WIDE_CLUSTER)
    need(wide.krn_cluster_size == rows and wide.krn_records.shape[1] == rows,
         f"PTX_KRN_CLUSTER={rows} did not reach the records: {tuple(wide.krn_records.shape)}")
    out[f"cluster{rows}"] = dict(build_s=build_s, records=list(wide.krn_records.shape),
                                 ms_at_56=out["ms"], **k1_binned_run(mk, wide, rays, opts))
    return out


def k1_binned_run(mk, dragon, rays, opts):
    """K1's binned form against its twin on `rays`: the first
    K1B_CHECK_RAYS bit-equal with equal counters; the whole chunk timed,
    counted and held against the twin at the K1 bounds."""
    n = int(rays.origin.shape[0])
    tables = mk.pack_tables(dragon)
    sub = type(rays)(rays.origin[:K1B_CHECK_RAYS].contiguous(),
                     rays.direction[:K1B_CHECK_RAYS].contiguous())
    k, kc, kv = mk.trace_megakernel(dragon, sub, opts, 21, tables, debug_visits=True)
    sync()
    t, tc, tv = mk.trace_megakernel_reference(dragon, sub, opts, 21, tables, debug_visits=True)
    out = dict(check_rays=K1B_CHECK_RAYS, rays=n,
               spectrum_bit_equal=float((k.view(torch.int32) == t.view(torch.int32))
                                        .all(1).float().mean()),
               collected_equal=bool(torch.equal(kc, tc)), counters_equal=bool(torch.equal(kv, tv)),
               counters=kv.sum(0).tolist(), max_abs_err=max_err(k, t))
    need(out["spectrum_bit_equal"] == 1.0 and out["collected_equal"] and out["counters_equal"],
         f"K1's binned form disagrees with its twin: {out}")
    # The whole chunk: the main path's shape.
    spec, _ = mk.trace_megakernel(dragon, rays, opts, 21, tables)
    out["ms"] = cuda_ms(lambda: mk.trace_megakernel(dragon, rays, opts, 21, tables), 3)
    _, _, vis = mk.trace_megakernel(dragon, rays, opts, 21, tables, debug_visits=True)
    sync()
    t0 = time.perf_counter()
    tspec, _ = mk.trace_megakernel_reference(dragon, rays, opts, 21, tables)
    sync()
    out["plain_ms"] = (time.perf_counter() - t0) * 1e3
    out["chunk"] = compare(spec, tspec)
    check_agreement("K1's binned form on the whole chunk", out["chunk"])
    flops, counts = traversal_flops(vis)
    rb = ray_bounces(vis)
    out.update(ray_bounces=rb, counts=counts,
               **bound(n * (24 + 16), flops + rb * vertex_flops(dragon)))
    out["max_abs_err"] = max(out["max_abs_err"], out["chunk"]["max_abs_err"])
    return out


def render_frames(pt, scene, camera, opts, flag, seeds):
    """Frames of `seeds` through render() under PTX_SORTED_WAVEFRONT=flag
    (None: unset): (images, seconds each)."""
    old = os.environ.pop("PTX_SORTED_WAVEFRONT", None)
    if flag is not None:
        os.environ["PTX_SORTED_WAVEFRONT"] = flag
    try:
        images, secs = [], []
        for seed in seeds:
            sync()
            t0 = time.perf_counter()
            images.append(pt.render(scene, camera, opts, seed=seed, device="cuda"))
            sync()
            secs.append(time.perf_counter() - t0)
    finally:
        os.environ.pop("PTX_SORTED_WAVEFRONT", None)
        if old is not None:
            os.environ["PTX_SORTED_WAVEFRONT"] = old
    return images, secs


def mean_gap(img_a, img_b):
    """Mean per-pixel difference of two frames and its standard error."""
    diff = img_a[..., :3].mean(-1).astype(np.float64) - img_b[..., :3].mean(-1)
    return float(diff.mean()), float(diff.std() / np.sqrt(diff.size))


def phase_dragon_k1_frame(pt, sw, mk, scenes, dragon):
    """renderSceneDragonBox through render() with PTX_SORTED_WAVEFRONT=0 (K1's
    binned form, this phase's main path) beside the default sorted driver,
    in turns; K2's bound over one counted sorted frame."""
    opts = pt.RenderOptions(DRAGON_W, DRAGON_H, DRAGON_SPP, DRAGON_SPP, epsilon=1e-3,
                            max_depth=MAX_DEPTH)
    camera = scenes.bench_camera()
    n_paths = DRAGON_W * DRAGON_H * DRAGON_SPP
    routes = {"k1": "0", "sorted": None}
    out = {name: {} for name in routes}
    first = {}
    for name, flag in routes.items():
        mk.trace_megakernel.launches = sw.bounce.launches = 0
        mk.trace_megakernel_reference.calls = sw.bounce_reference.calls = 0
        sw.trace_megakernel_sorted.host_reads = 0
        images, secs = render_frames(pt, dragon, camera, opts, flag, [30])
        sync()
        out[name].update(first_frame_s=secs[0], launches=dict(
            k1=mk.trace_megakernel.launches, k2=sw.bounce.launches,
            k1_twin=mk.trace_megakernel_reference.calls, k2_twin=sw.bounce_reference.calls),
            host_reads=sw.trace_megakernel_sorted.host_reads)
        first[name] = images[0]
    c1, c2 = out["k1"]["launches"], out["sorted"]["launches"]
    need(c1["k1"] > 0 and c1["k2"] == c1["k1_twin"] == c1["k2_twin"] == 0,
         f"PTX_SORTED_WAVEFRONT=0: the dragon frame did not run K1's binned form alone: {c1}")
    need(c2["k2"] > 0 and c2["k1"] == c2["k1_twin"] == c2["k2_twin"] == 0,
         f"the default dragon frame did not run the sorted driver alone: {c2}")
    # Timed frames in turns: K1, sorted, sorted, K1, K1, sorted.
    for order, seed in zip(("k1", "sorted", "sorted", "k1", "k1", "sorted"), range(31, 37)):
        _, secs = render_frames(pt, dragon, camera, opts, routes[order], [seed])
        out[order].setdefault("frame_s", []).extend(secs)
    for name, img in first.items():
        need(img.shape == (DRAGON_H, DRAGON_W, 4) and np.isfinite(img).all()
             and bool((img[..., 3] == 1.0).all()), f"{name} dragon frame")
        med = float(np.median(out[name]["frame_s"]))
        out[name].update(frame_median_s=med, mrays_per_s=n_paths / med / 1e6,
                         mean=float(img[..., :3].mean()))
    out["mean_diff"], out["std_err"] = mean_gap(first["k1"], first["sorted"])
    need(abs(out["mean_diff"]) <= 4 * out["std_err"],
         f"K1's binned frame differs from the sorted driver's: {out}")
    os.environ["PTX_SORTED_WAVEFRONT"] = "0"
    try:
        out["k1"]["profile"] = profile_run(
            lambda: pt.render(dragon, camera, opts, seed=37, device="cuda"), "megakernel")
    finally:
        del os.environ["PTX_SORTED_WAVEFRONT"]
    # One counted sorted frame: K2's work over all its bounces.
    rays, _ = camera_state(sw, scenes.bench_camera(device="cuda"), opts, DRAGON_SPP, 38)
    _, _, vis = sw.trace_megakernel_sorted(dragon, rays, opts, 38, debug_visits=True)
    entering = [a for a in (ray_bounces(v) for v in vis) if a > 0]
    flops, counts = traversal_flops(vis)
    frame_bound = bound(sum(a * 144 + (n_paths - a) * 4 for a in entering),
                        flops + sum(entering) * vertex_flops(dragon))
    out["sorted"]["k2_frame"] = dict(bounces=len(entering), ray_bounces=sum(entering),
                                     counts=counts, **frame_bound)
    return out


def phase_box_sorted(pt, sw, mk, scenes):
    """The box (phase 5's frame) through the sorted driver with
    PTX_SORTED_WAVEFRONT=1 (K2's dense form) against K1's frame."""
    opts = pt.RenderOptions(BOX_W, BOX_H, BOX_SPP, BOX_SPP, epsilon=1e-3, max_depth=MAX_DEPTH)
    scene, camera = scenes.bench_box_scene(), scenes.bench_camera()
    mk.trace_megakernel.launches = sw.bounce.launches = sw.bounce_reference.calls = 0
    images, secs = render_frames(pt, scene, camera, opts, "1", [40, 41, 42])
    counts = dict(k2=sw.bounce.launches, k1=mk.trace_megakernel.launches,
                  k2_twin=sw.bounce_reference.calls)
    need(counts["k2"] > 0 and counts["k1"] == counts["k2_twin"] == 0,
         f"PTX_SORTED_WAVEFRONT=1: the box did not run the sorted driver alone: {counts}")
    k1_images, k1_secs = render_frames(pt, scene, camera, opts, None, [43])
    img = images[0]
    need(np.isfinite(img).all() and bool((img[..., 3] == 1.0).all()), "sorted box frame")
    mean_diff, se = mean_gap(img, k1_images[0])
    out = dict(counts=counts, frame_s=secs, frame_median_s=float(np.median(secs)),
               k1_frame_s=k1_secs[0], mean_sorted=float(img[..., :3].mean()),
               mean_k1=float(k1_images[0][..., :3].mean()), mean_diff=mean_diff, std_err=se)
    need(abs(mean_diff) <= 4 * se, f"the sorted box frame differs from K1's: {out}")
    return out


def phase_experiments(ss, rv, smt, cf, df, best_ms):
    """X1-X5: each kernel against its plain version on check inputs whose
    output depends on the work, then the TPU script's sweep on the script's
    inputs (the microbenchmarks' own main path: counts zeroed just before,
    read just after)."""
    out = {}
    big = dict(sp=max(ss.SWEEP_SP), rows=max(ss.SWEEP_ROWS), n_iter=max(ss.SWEEP_ITERS))
    checked = {}
    for sp in ss.SWEEP_SP:
        xc_np, bc_np = ss.check_inputs(sp)
        xc, bc = torch.from_numpy(xc_np).cuda(), torch.from_numpy(bc_np).cuda()
        for rows in ss.SWEEP_ROWS:
            n_iter = big["n_iter"] if (sp, rows) == (big["sp"], big["rows"]) else 3
            ko, ke = ss.supscan(bc, xc, n_iter, rows, entries=True)
            po, pe = ss.supscan_reference(bc, xc, n_iter, rows, entries=True)
            acc = (ko.reshape(ss.BLOCKS, 8, 128)
                   - xc.reshape(ss.BLOCKS, ss.X_ROWS, 128)[:, :8])[:, 0, 0]
            res = dict(n_iter=n_iter, blocks_counting=int((acc > 0.5).sum()),
                       finite_entries=int(torch.isfinite(ke).sum()),
                       max_abs_err=max_err(ko, po))
            need(torch.equal(ko, po) and torch.equal(ke, pe)
                 and 0 < res["blocks_counting"] < ss.BLOCKS and res["finite_entries"] > 0,
                 f"X1 differs from its plain version at sp={sp} rows={rows}: {res}")
            checked[f"sp{sp}_rows{rows}"] = res
    xb_np, bb_np = ss.check_inputs(big["sp"])
    xb, bb = torch.from_numpy(xb_np).cuda(), torch.from_numpy(bb_np).cuda()
    ss.supscan.launches = 0
    x1 = dict(check=checked, sweep=ss.sweep())
    x1["launches"] = ss.supscan.launches
    x1["ms"] = min(r["ms"][big["n_iter"]] for r in x1["sweep"]
                   if r["sp"] == big["sp"] and r["rows"] == big["rows"])
    x1["plain_ms"] = cuda_ms(
        lambda: ss.supscan_reference(bb, xb, big["n_iter"], big["rows"]), 1)
    x1["max_abs_err"] = max(r["max_abs_err"] for r in checked.values())
    x1["sms"] = torch.cuda.get_device_properties(0).multi_processor_count
    x1.update(config=big, **bound(xb.numel() * 4 + bb.numel() * 4 + ss.BLOCKS * 8 * 128 * 4,
                                  ss.slab_ops(big["sp"], big["rows"], big["n_iter"])))
    out["supscan"] = x1

    tables, rays_np = rv.inputs()
    rays = torch.from_numpy(rays_np).cuda()
    x3 = {}
    for v in rv.VARIANTS:
        table = torch.from_numpy(tables[v]).cuda()
        k = rv.record_variant(v, table, rays, X3_CHECK_RECORDS)
        sync()
        t0 = time.perf_counter()
        p = rv.variant_reference(v, table, rays, X3_CHECK_RECORDS)
        sync()
        plain_ms = (time.perf_counter() - t0) * 1e3
        rtol = 1e-6 if v in ("serial", "outer") else 1e-5
        res = dict(records=X3_CHECK_RECORDS, hits=int((k < 100.0).sum()),
                   max_abs_err=max_err(k, p), plain_ms=plain_ms,
                   ms=cuda_ms(lambda: rv.record_variant(v, table, rays, X3_CHECK_RECORDS), 3))
        need(bool(torch.allclose(k, p, rtol=rtol, atol=0.0)) and res["hits"] > 0,
             f"X3 {v} differs from its plain version: {res}")
        ops, kind = rv.record_ops(v, X3_CHECK_RECORDS)
        res.update(bound(table.numel() * 4 + rays.numel() * 4 + 1024 * 4,
                         (ops if kind == "fp32" else 0) + rv.epilogue_ops(v, X3_CHECK_RECORDS),
                         ops if kind == "tf32" else 0))
        x3[v] = res
    for v in rv.VARIANTS:
        rv.record_variant.launches[v] = 0
    sweep = rv.sweep()
    for v in rv.VARIANTS:
        x3[v].update(sweep=sweep[v], launches=rv.record_variant.launches[v])
    out["record_variants"] = dict(variants=x3)

    # X5 in every check configuration, every staging instance, both launch
    # shapes (K1's, one block per tile, and the persistent grid).
    x5_check = {}
    for name, (xs, tbl, threads) in smt.check_configurations("cuda").items():
        for staging in smt.STAGINGS:
            for shape, blocks in (("k1_shape", None),
                                  ("persistent", smt.resident_blocks(xs, tbl, threads, staging))):
                ko, kst = smt.smem_tables(xs, tbl, threads, staged=True, blocks=blocks,
                                          staging=staging)
                po, pst = smt.smem_tables_reference(xs, tbl, threads, staged=True, blocks=blocks)
                res = dict(moved=float((po != xs).float().mean()), blocks=kst.shape[0],
                           staged_floats=kst.shape[1], max_abs_err=max_err(ko, po))
                need(torch.equal(ko, po) and torch.equal(kst, pst)
                     and (res["moved"] > 0.99 or not tbl),
                     f"X5 {name} ({staging}, {shape}) differs from its plain version: {res}")
                x5_check[f"{name}_{staging}_{shape}"] = res
    xk, tk, thk = smt.check_configurations("cuda")["k1_box_tables"]
    smt.smem_tables.launches = 0
    x5 = dict(check=x5_check, sweep=smt.sweep())
    x5["launches"] = smt.smem_tables.launches
    sw5 = x5["sweep"]
    x5.update(ms=sw5["k1_bulk"]["ms"], k1_staging_ms=sw5["k1_rows"]["ms"],
              persistent_ms=sw5["k1_bulk_persistent"]["ms"],
              k1_staging_persistent_ms=sw5["k1_rows_persistent"]["ms"],
              persistent_blocks=sw5["k1_bulk_persistent"]["blocks"],
              blocks_per_sm=sw5["k1_bulk_persistent"]["blocks_per_sm"],
              no_tables_ms=sw5["k1_no_tables"]["ms"], k1_shape_blocks=sw5["k1_bulk"]["blocks"],
              max_abs_err=max(r["max_abs_err"] for r in x5_check.values()),
              plain_ms=best_ms(lambda: smt.smem_tables_reference(xk, tk, thk), 5),
              library_ms=sw5["torch_add"]["ms"], library="torch.add(x, s)",
              card=nvidia_smi_name_power(),
              **bound(sw5["k1_bulk"]["bytes"], xk.numel()))
    out["smem_tables"] = x5
    out["cond_fat"] = phase_cond_fat(cf, best_ms)
    out["dot_formulations"] = phase_dot_formulations(df, best_ms)
    return out


def phase_cond_fat(cf, best_ms):
    """X2 bit-equal to its plain version on the check inputs at X2_ITERS
    iterations, outputs and per-tile update counts, in all four instances
    (tiles that take and tiles that skip the updates); then the script's
    sweep."""
    x = torch.from_numpy(cf.check_inputs()).cuda()
    checked = {}
    for n_live in cf.SWEEP_LIVE:
        for use_cond in cf.SWEEP_COND:
            name = cf.instance(n_live, use_cond)
            ko, kc = cf.cond_fat(x, X2_ITERS, n_live, use_cond, taken=True)
            sync()
            t0 = time.perf_counter()
            po, pc = cf.cond_fat_reference(x, X2_ITERS, n_live, use_cond, taken=True)
            sync()
            want = cf.expected_taken(x.cpu(), X2_ITERS, use_cond)
            res = dict(plain_ms=(time.perf_counter() - t0) * 1e3, max_abs_err=max_err(ko, po),
                       tiles_taking=int((kc > 0).sum()),
                       zero_tile_out=float(ko.reshape(cf.BLOCKS, -1)[0, 0]))
            need(torch.equal(ko.view(torch.int32), po.view(torch.int32)) and torch.equal(kc, pc)
                 and bool((kc.cpu().numpy() == want).all())
                 and (0 < res["tiles_taking"] < cf.BLOCKS or not use_cond),
                 f"X2 {name} differs from its plain version: {res}")
            checked[name] = res
    for name in cf.INSTANCES:
        cf.cond_fat.launches[name] = 0
    sweep = cf.sweep()
    out = {}
    for r in sweep:
        name = cf.instance(r["n_live"], r["use_cond"])
        out[name] = dict(checked[name], sweep=r, launches=cf.cond_fat.launches[name],
                         ms=r["ms"][X2_ITERS], n_iter=X2_ITERS,
                         **bound(2 * x.numel() * 4,
                                 cf.cond_fat_ops(r["n_live"], r["use_cond"], X2_ITERS)))
    return out


def phase_dot_formulations(df, best_ms):
    """X4 on the script's inputs (seeds 0 and 1) and on the tie inputs: fma
    bit-equal to its plain version in C, R and X; the TF32 forms within TOL_REL of sum_k |B A| of
    their emulation; every form's R and X exactly the min and first argmin
    of its own C; the script's error figures (fma and 3xtf32 held to
    float32, tf32 reported); on the tie inputs the first of two rows
    holding a column's minimum (-0.0 / +0.0, equal negatives, in other
    warps and in one thread). Then the sweep, which times each form beside
    the one-call library yardstick torch.matmul(B.T, A) (C only, full
    float32)."""
    out = {f: dict(check={}) for f in df.FORMS}
    for case in (0, 1, "ties"):
        inputs = df.tie_inputs() if case == "ties" else df.script_inputs(case)
        b, a, e = (torch.from_numpy(v).cuda() for v in inputs)
        for form in df.FORMS:
            c, r, x = df.dot_formulation(form, b, a, e)
            pc, pr, px = df.dot_reference(form, b, a, e)
            errs = df.script_errors(b, a, e, c, r, x)
            res = dict(max_abs_err=max(max_err(c, pc), max_err(r, pr)),
                       own_argmin=df.self_check(c, r, x, e),
                       x_equal_plain=bool(torch.equal(x, px)), **errs)
            ok = res["own_argmin"] and (
                torch.equal(c, pc) and torch.equal(r, pr) and res["x_equal_plain"]
                if form == "fma" else df.within_tolerance(c, pc, b, a))
            if form != "tf32":
                ok = ok and errs["matmul_rel_err"] < 1e-6 and errs["extract_err"] == 0.0
            if case == "ties":
                res["ties_hold"] = df.ties_hold(r, x, e)
                ok = ok and res["ties_hold"]
            need(ok, f"X4 {form} ({case}) differs from its plain version: {res}")
            out[form]["check"][f"seed{case}" if case != "ties" else case] = res
    b, a, e = (torch.from_numpy(v).cuda() for v in df.script_inputs(0))
    for form in df.FORMS:
        df.dot_formulation.launches[form] = 0
    sweep = df.sweep()
    for form in df.FORMS:
        ops, kind = df.dot_ops(form)
        out[form].update(sweep=sweep[form], launches=df.dot_formulation.launches[form],
                         ms=sweep[form]["ms"],
                         plain_ms=best_ms(lambda form=form: df.dot_reference(form, b, a, e), 5),
                         library_ms=sweep[form]["library_ms"],
                         library="torch.matmul(B.T, A), C only",
                         max_abs_err=max(v["max_abs_err"] for v in out[form]["check"].values()),
                         card=nvidia_smi_name_power(),
                         **bound(df.io_bytes(), ops if kind == "fp32" else 0,
                                 ops if kind == "tf32" else 0))
    return out


# A kernel instance in ptxas's report: its name and template arguments,
# read from the mangled entry name (`...18smem_tables_kernelILi1EE...`).
PTXAS_ENTRY = re.compile(r"entry function '\w*?\d+([a-z][a-z_]*kernel)(?:I((?:L[a-z]n?\d+E)+)E)?")


def ptxas_summary(text):
    """A library's ptxas report on one line: per kernel instance its name
    (`smem_tables_kernel<1>`), then its registers, shared memory and
    spills."""
    out = []
    for ln in text.splitlines():
        m = PTXAS_ENTRY.search(ln)
        if m:
            args = re.findall(r"L[a-z](n?\d+)E", m.group(2) or "")
            out.append(m.group(1) + (f"<{', '.join(a.replace('n', '-') for a in args)}>"
                                     if args else ""))
        elif "Used" in ln or "spill" in ln:
            out.append(ln.replace("ptxas info    :", "").strip())
    return " | ".join(out)


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--out", help="also write the demo PNGs and all figures here")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device (torch.cuda.is_available() is False)",
              file=sys.stderr)
        return 1

    t_start = time.perf_counter()
    import cpupathtrace_tpu_torch as pt
    from cpupathtrace_tpu_torch import _build
    from cpupathtrace_tpu_torch.accel import kernel_traverse as kt
    from cpupathtrace_tpu_torch.core.rays import Rays
    from cpupathtrace_tpu_torch.integrator import film
    from cpupathtrace_tpu_torch.integrator import megakernel as mk
    from cpupathtrace_tpu_torch.integrator import sorted_wavefront as sw
    from cpupathtrace_tpu_torch import diff
    from cpupathtrace_tpu_torch.models import golden, scenes
    from cpupathtrace_tpu_torch.ops import intersect as oi
    from cpupathtrace_tpu_torch.accel import binned, cluster_major as cm, traverse as tt
    from cpupathtrace_tpu_torch.experiments import best_ms
    from cpupathtrace_tpu_torch.experiments import cond_fat as cf
    from cpupathtrace_tpu_torch.experiments import dot_formulations as df
    from cpupathtrace_tpu_torch.experiments import record_variants as rv
    from cpupathtrace_tpu_torch.experiments import smem_tables as smt
    from cpupathtrace_tpu_torch.experiments import supscan as ss

    if args.out:
        os.makedirs(args.out, exist_ok=True)
    kind = torch.cuda.get_device_name(0)
    smi = nvidia_smi_name_power()
    report = {"device": kind, "nvidia_smi": smi, "torch": torch.__version__,
              "cuda": torch.version.cuda}
    print(f"[1 device] {kind} | count {torch.cuda.device_count()} | torch "
          f"{torch.__version__} cuda {torch.version.cuda}", flush=True)
    print(smi, flush=True)

    # Every kernel and the host BVH library, one compiler per source, all
    # started together.
    t0 = time.perf_counter()
    _build.build_all(KERNELS)
    for name in KERNELS:
        _build.load(name)
    ptxas = {name: ptxas_summary(_build.ptxas_report.get(name, ""))
             for name in KERNELS if name != "bvh_build"}
    report["build"] = dict(seconds=time.perf_counter() - t0,
                           compiler_seconds=dict(_build.build_seconds), ptxas=ptxas)
    line("2 build", **report["build"])

    report["kernel_vs_twin"] = phase_kernel_vs_twin(mk, scenes, Rays, pt.RenderOptions)
    line("3 kernel vs twin", **report["kernel_vs_twin"])
    report["golden"] = phase_golden(film, pt.RenderOptions)
    line("4 golden parity", **report["golden"])
    report["main_path"] = phase_main_path(pt, mk, sw, scenes)
    line("5 main path", **report["main_path"])
    report["demo"] = phase_demo(pt, scenes, args.out)
    line("6 demo", **report["demo"])

    dragon, report["dragon_build"] = phase_dragon_build(scenes)
    line("7 dragon build", **report["dragon_build"])
    report["cluster_query"] = phase_cluster_query(kt, dragon)
    line("7 cluster query vs plain", **report["cluster_query"])
    report["bounce_vs_twin"] = phase_bounce_vs_twin(sw, mk, scenes, dragon, pt.RenderOptions)
    line("8 bounce vs twin", **report["bounce_vs_twin"])
    report["dragon_main_path"] = phase_dragon_main_path(pt, sw, mk, scenes, dragon)
    line("9 dragon main path", **report["dragon_main_path"])
    sw.bounce.launches = 0
    sw.bounce_reference.calls = 0
    report["demo_dragon"] = phase_demo(pt, scenes, args.out, include_dragon=True)
    report["demo_dragon"].update(bounce_launches=sw.bounce.launches,
                                 twin_calls=sw.bounce_reference.calls)
    need(sw.bounce.launches > 0 and sw.bounce_reference.calls == 0,
         f"demo with dragon did not run the bounce kernel alone: {report['demo_dragon']}")
    line("10 demo with dragon", **report["demo_dragon"])

    report["dense_query"] = phase_dense_query(oi, sw, scenes, pt.RenderOptions)
    line("11 dense query vs plain", **report["dense_query"])
    report["wavefront"] = phase_wavefront(pt, film, oi, mk, scenes, pt.RenderOptions)
    line("12 wavefront forward", **report["wavefront"])
    report["records"] = phase_records(sw, mk, scenes, dragon, pt.RenderOptions)
    line("13 record form vs twin", **report["records"])
    report["box_grad"] = phase_box_grad(diff, sw, oi, scenes, golden, pt.RenderOptions)
    line("14 renderSceneBoxGrad", **report["box_grad"])
    report["inverse_render"] = phase_inverse_render(diff, golden, pt.RenderOptions)
    line("15 inverse_render", **report["inverse_render"])

    # The binned wavefront needs the dragon's K6/K7 tables: phase 7 built
    # the scene with lean=False, the builder's default.
    need(dragon.trv_bounds.shape[0] > 1 and not dragon.lean, "the dragon has no K6/K7 tables")
    report["binned_kernels"], nearest = phase_binned_kernels(pt, tt, scenes, dragon, best_ms)
    line("16 binned wavefront kernels vs plain", **report["binned_kernels"])
    report["cluster_major"] = phase_cluster_major(cm, binned, tt, oi, dragon, nearest)
    line("17 cluster-major entry (K8)", **report["cluster_major"])
    report["binned_wavefront"] = phase_binned_wavefront(pt, tt, oi, sw, mk, kt, scenes, dragon)
    line("18 binned wavefront frame", **report["binned_wavefront"])
    report["dragon_grad"] = phase_dragon_grad(diff, golden, sw, tt, scenes, dragon,
                                              pt.RenderOptions)
    line("19 dragon gradients vs FD", **report["dragon_grad"])
    report["k1_binned"] = phase_k1_binned(mk, sw, scenes, dragon, pt.RenderOptions)
    line("20 K1 binned form vs twin", **report["k1_binned"])
    report["dragon_k1_frame"] = phase_dragon_k1_frame(pt, sw, mk, scenes, dragon)
    line("21 dragon frame: K1 binned vs sorted driver", **report["dragon_k1_frame"])
    report["box_sorted"] = phase_box_sorted(pt, sw, mk, scenes)
    line("22 box through the sorted driver", **report["box_sorted"])
    report["experiments"] = phase_experiments(ss, rv, smt, cf, df, best_ms)
    line("23 microbenchmarks X1 X2 X3 X4 X5", **report["experiments"])

    main_path = report["main_path"]
    dragon_path = report["dragon_main_path"]
    query = report["cluster_query"]
    k5 = report["dense_query"]
    grad = report["box_grad"]
    krec = grad["record_kernel"]
    bk = report["binned_kernels"]
    bw = report["binned_wavefront"]["counts"]
    k8 = report["cluster_major"]
    k1b = report["k1_binned"]
    xp = report["experiments"]

    def figures(d):
        return {k: d[k] for k in ("ms", "plain_ms", "bound_ms", "bound_by")}

    k3 = ("K3, cpupathtrace_tpu_torch/csrc/cluster_traverse.cuh "
          "(cpupathtrace_tpu/accel/kernel_traverse.py:1041,1106)")
    kernels = {"kernels": [{
        "name": "megakernel", "route": "cuda",
        "source": "cpupathtrace_tpu_torch/csrc/megakernel.cu",
        "replaces": "cpupathtrace_tpu/integrator/pallas_megakernel.py:345",
        "launches": main_path["launches"],
        "max_abs_err": main_path["agreement"]["max_abs_err"],
        "ms": main_path["kernel_ms"], "plain_ms": main_path["twin_ms"],
        "bound_ms": main_path["bound_ms"], "bound_by": main_path["bound_by"],
        "library_ms": None,
    }, {
        "name": "bounce", "route": "cuda",
        "source": "cpupathtrace_tpu_torch/csrc/bounce.cu",
        "replaces": "cpupathtrace_tpu/integrator/sorted_wavefront.py:252",
        "inlines": k3,
        "launches": dragon_path["launches"],
        "max_abs_err": dragon_path["agreement"]["max_abs_err"],
        "ms": dragon_path["kernel_ms"], "plain_ms": dragon_path["twin_ms"],
        "bound_ms": dragon_path["bound_ms"], "bound_by": dragon_path["bound_by"],
        "library_ms": None,
    }, {
        "name": "bounce_records", "route": "cuda",
        "source": "cpupathtrace_tpu_torch/csrc/bounce.cu",
        "replaces": "cpupathtrace_tpu/integrator/sorted_wavefront.py:252",
        "launches": grad["replay"]["counts"]["k2_records"],
        "max_abs_err": max(report["records"]["max_abs_err"], krec["max_abs_err"],
                           krec["records_max_abs_err"]),
        **figures(krec), "library_ms": None,
    }, {
        "name": "cluster_query", "route": "cuda",
        "source": "cpupathtrace_tpu_torch/csrc/cluster_query.cu",
        "replaces": "cpupathtrace_tpu/accel/kernel_traverse.py:1201",
        "inlines": k3,
        "launches": query["launches"],
        "max_abs_err": query["max_abs_err"],
        **figures(query), "library_ms": None,
    }, {
        "name": "dense_intersect", "route": "cuda",
        "source": "cpupathtrace_tpu_torch/csrc/dense_query.cu",
        "replaces": "cpupathtrace_tpu/ops/pallas_intersect.py:31",
        "launches": grad["wavefront"]["counts"]["k5"],
        "max_abs_err": k5["max_abs_err"],
        **figures(k5), "library_ms": None,
    }, {
        "name": "binned_cand", "route": "cuda",
        "source": "cpupathtrace_tpu_torch/csrc/binned_cand.cu",
        "replaces": "cpupathtrace_tpu/accel/pallas_traverse.py:121",
        "launches": bw["k6"],
        "max_abs_err": bk["max_abs_err"],
        **figures(bk["k6_frame"]), "best_ms": bk["k6_frame"]["best_ms"], "library_ms": None,
    }, {
        "name": "binned_isect", "route": "cuda",
        "source": "cpupathtrace_tpu_torch/csrc/binned_isect.cu",
        "replaces": "cpupathtrace_tpu/accel/pallas_traverse.py:238",
        "launches": bw["k7"],
        "max_abs_err": max(bk["k7_round1"]["max_abs_err"], bk["k7_frame"]["max_abs_err"]),
        **figures(bk["k7_frame"]), "best_ms": bk["k7_frame"]["best_ms"], "library_ms": None,
    }, {
        "name": "cluster_major", "route": "cuda",
        "source": "cpupathtrace_tpu_torch/csrc/binned_isect.cu",
        "replaces": "cpupathtrace_tpu/accel/pallas_binned.py:62",
        "launches": k8["launches"],
        "max_abs_err": k8["max_abs_err"],
        **figures(k8), "library_ms": None,
    }, {
        "name": "megakernel_binned", "route": "cuda",
        "source": "cpupathtrace_tpu_torch/csrc/megakernel.cu",
        "replaces": "cpupathtrace_tpu/integrator/pallas_megakernel.py:1189",
        "inlines": k3,
        "launches": report["dragon_k1_frame"]["k1"]["launches"]["k1"],
        "max_abs_err": k1b["max_abs_err"],
        **figures(k1b), "library_ms": None,
    }, {
        "name": "supscan", "route": "cuda",
        "source": "cpupathtrace_tpu_torch/csrc/exp_supscan.cu",
        "replaces": "benchmarks/experiments/microbench_supscan.py:46",
        "launches": xp["supscan"]["launches"],
        "max_abs_err": xp["supscan"]["max_abs_err"],
        **figures(xp["supscan"]), "library_ms": None,
    }] + [{
        "name": f"record_variants_{v}", "route": "cuda",
        "source": "cpupathtrace_tpu_torch/csrc/exp_record_variants.cu",
        "replaces": "benchmarks/experiments/exp_record_variants.py:229",
        "launches": r["launches"],
        "max_abs_err": r["max_abs_err"],
        **figures(r), "library_ms": None,
    } for v, r in xp["record_variants"]["variants"].items()] + [{
        "name": "smem_tables", "route": "cuda",
        "source": "cpupathtrace_tpu_torch/csrc/exp_smem_tables.cu",
        "replaces": "benchmarks/experiments/microbench_smemtables.py:41",
        "launches": xp["smem_tables"]["launches"],
        "max_abs_err": xp["smem_tables"]["max_abs_err"],
        **figures(xp["smem_tables"]), "library_ms": xp["smem_tables"]["library_ms"],
    }] + [{
        "name": f"cond_fat_{name}", "route": "cuda",
        "source": "cpupathtrace_tpu_torch/csrc/exp_cond_fat.cu",
        "replaces": "benchmarks/experiments/microbench_cond_fat.py:39",
        "launches": r["launches"],
        "max_abs_err": r["max_abs_err"],
        **figures(r), "library_ms": None,
    } for name, r in xp["cond_fat"].items()] + [{
        "name": f"dot_formulations_{form}", "route": "cuda",
        "source": "cpupathtrace_tpu_torch/csrc/exp_dot_formulations.cu",
        "replaces": "benchmarks/experiments/exp_dot_formulations.py:56",
        "launches": r["launches"],
        "max_abs_err": r["max_abs_err"],
        **figures(r), "library_ms": r["library_ms"],
    } for form, r in xp["dot_formulations"].items()]}
    report["seconds"] = time.perf_counter() - t_start
    line("24 total", seconds=report["seconds"])
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
