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
Then one JSON line with the kernels' figures and, last, the result line.
With --out, the demo PNGs and every measured figure are also written there.
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
KERNELS = ("megakernel", "bounce", "cluster_query", "dense_query", "bvh_build")
# The least time the card could take for a kernel's work: the larger of
# its bytes over HBM's rate
# and its float32 operations over the FP32 peak (NVIDIA H100 SXM data
# sheet), with the JAX package's work model (utils/roofline.py:84-116):
# 64 flops per ray-primitive test, ~300 estimator flops per ray-bounce.
H100_BYTES_S = 3.35e12
H100_FP32_S = 67e12
TEST_FLOPS = 64
VERTEX_FLOPS = 300
# renderSceneBoxGrad (bench.py:253-260) and the FD / inverse-rendering
# checks on the card.
GRAD_W = GRAD_H = 128
GRAD_SPP = 16
GRAD_DEPTH = 12
K5_RAYS = 262144


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


def bound(nbytes, flops):
    """bound_ms / bound_by of a kernel call that must move `nbytes` and do
    `flops` float32 operations."""
    t_b, t_f = nbytes / H100_BYTES_S, flops / H100_FP32_S
    return dict(bound_ms=max(t_b, t_f) * 1e3, bound_by="bytes" if t_b >= t_f else "operations",
                bound_bytes=nbytes, bound_flops=flops)


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
    # Lower bound: each nearest hit tested at least one 56-triangle record
    # (the traversal's visit counters are not ported).
    out.update(bound(n * (24 + 4 + 8), out["nearest"]["hits"] * scene.krn_cluster_size
                     * TEST_FLOPS))
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
    # Lower bound: the big-partition tests of each query and the estimator;
    # the cluster tests are not counted (no visit counters).
    live = agree["alive_in"]
    k2_bound = bound(live * 144 + (n_paths - live) * 4, live * (
        tests_per_vertex(scene, scene.n_big + scene.n_sph) * TEST_FLOPS + VERTEX_FLOPS))
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


def grad_checks(diff, golden, RenderOptions):
    """Analytic vs central-difference gradients on the card at 32x32 @ 8
    spp, max_depth 4 (test_diff.py:66's rtol 0.05, atol 1e-4), for the
    route PTX_DIFF_MEGAKERNEL currently selects."""
    scene, cam = golden.inward_box_scene(), golden.box_camera()
    opts = RenderOptions(32, 32, 8, 8, max_depth=4)
    target = diff.render_image_diff(scene, cam, opts, 99, 8).detach()
    params = diff.get_material_params(scene)
    _, g = diff.loss_and_grad(params, scene, cam, opts, target, 0, 8)
    out = {}
    for field, idx in (("mat_diffuse", (1, 0)), ("mat_emission", (2, 1))):
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


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--out", help="also write the demo PNGs and all figures here")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device (torch.cuda.is_available() is False)",
              file=sys.stderr)
        return 1

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
    ptxas = {
        name: " | ".join(ln.strip() for ln in _build.ptxas_report.get(name, "").splitlines()
                         if "Used" in ln or "spill" in ln)
        for name in KERNELS if name != "bvh_build"
    }
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

    main_path = report["main_path"]
    dragon_path = report["dragon_main_path"]
    query = report["cluster_query"]
    k5 = report["dense_query"]
    grad = report["box_grad"]
    krec = grad["record_kernel"]

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
