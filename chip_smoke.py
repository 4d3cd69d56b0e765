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
KERNELS = ("megakernel", "bounce", "cluster_query", "bvh_build")


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


def profile_frame(pt, scene, camera, opts, kernel="megakernel"):
    """One main-path frame under torch.profiler: device time by kernel
    name (top 6), the share of kernels named `kernel`, and the device's
    busy share of the frame's wall time (the union of kernel intervals)."""
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
    return dict(launches=launches, twin_calls=twin_calls, image_mean=mean, frame_s=frames,
                frame_median_s=frame_s, mrays_per_s=n_paths / frame_s / 1e6, paths=n_paths,
                bounces=len(timing["bounce_ms"]), bounce_ms=timing["bounce_ms"],
                sort_gather_ms=timing["sort_ms"], driver_wall_ms=driver_s * 1e3,
                driver_events_ms=events_ms, unsorted=unsorted,
                kernel_ms=kernel_ms, twin_ms=plain_ms, agreement=agree,
                busy_share=profile["busy_share"])


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
    report["main_path"] = phase_main_path(pt, mk, scenes)
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

    main_path = report["main_path"]
    dragon_path = report["dragon_main_path"]
    query = report["cluster_query"]
    kernels = {"kernels": [{
        "name": "megakernel",
        "route": "cuda",
        "source": "cpupathtrace_tpu_torch/csrc/megakernel.cu",
        "replaces": "cpupathtrace_tpu/integrator/pallas_megakernel.py:345",
        "launches": main_path["launches"],
        "max_abs_err": main_path["agreement"]["max_abs_err"],
        "ms": main_path["kernel_ms"],
        "plain_ms": main_path["twin_ms"],
    }, {
        "name": "bounce",
        "route": "cuda",
        "source": "cpupathtrace_tpu_torch/csrc/bounce.cu",
        "replaces": "cpupathtrace_tpu/integrator/sorted_wavefront.py:252",
        "inlines": "K3, cpupathtrace_tpu_torch/csrc/cluster_traverse.cuh "
                   "(cpupathtrace_tpu/accel/kernel_traverse.py:1041,1106)",
        "launches": dragon_path["launches"],
        "max_abs_err": dragon_path["agreement"]["max_abs_err"],
        "ms": dragon_path["kernel_ms"],
        "plain_ms": dragon_path["twin_ms"],
    }, {
        "name": "cluster_query",
        "route": "cuda",
        "source": "cpupathtrace_tpu_torch/csrc/cluster_query.cu",
        "replaces": "cpupathtrace_tpu/accel/kernel_traverse.py:1201",
        "inlines": "K3, cpupathtrace_tpu_torch/csrc/cluster_traverse.cuh "
                   "(cpupathtrace_tpu/accel/kernel_traverse.py:1041,1106)",
        "launches": query["launches"],
        "max_abs_err": query["max_abs_err"],
        "ms": query["ms"],
        "plain_ms": query["plain_ms"],
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
