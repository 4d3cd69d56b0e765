"""Film: sample accumulation, adaptive sampling and the render driver.

Port of `cpupathtrace_tpu/integrator/film.py` (ref: src/worker.cpp:149-427).
The driver launches chunks of `stats` samples for a whole pixel tile and
applies the reference's stopping rule per pixel between chunks: a chunk
mean is one Welford stats sample (worker.cpp:200-232), accepted pixels
freeze. Up to PTX_ADAPTIVE_FUSE (default 4, read per call as film.py:378
reads it) stats batches go out in one launch (render_chunk_batched) and are
folded back one after another (_apply_stats_batches), so the estimator is
that of one launch per batch; a fuse of 1 is the unfused random stream.
The biased candidate selection (worker.cpp:273-317) runs only with
`allow_bias=True`.

Rays are sample-major (ray s * P + p is sample s of pixel p), except for
binned scenes on a CUDA device: there they launch pixel-major over the
Morton-ordered pixels (`morton_perm`), so neighbouring rays start through
neighbouring pixels, and the sums are scattered back (film.py:110-186).
"""
from __future__ import annotations

import math
import os

import numpy as np
import torch

from ..camera.camera import Camera, shoot_rays
from ..core.config import RenderOptions
from ..scene.scene import SceneData
from .diff_megakernel import diff_supported, trace_diff
from .megakernel import megakernel_supported, trace_megakernel
from .rng import RecordedDraws
from .sorted_wavefront import trace_megakernel_sorted
from .wavefront import trace

# The default of PTX_ADAPTIVE_FUSE: stats batches fused into one launch.
ADAPTIVE_FUSE = 4


def pixel_camera_coords(options: RenderOptions, px, py):
    """Pixel index -> [-1,1] sensor coordinates, y flipped
    (ref: worker.cpp:166-171). numpy in, numpy out."""
    x_cam = 2.0 * ((px + 0.5) / options.image_width - 0.5)
    y_cam = -2.0 * ((py + 0.5) / options.image_height - 0.5)
    return x_cam, y_cam


def adaptive_constants(options: RenderOptions):
    """The reference's batch constants, integer division preserved
    (ref: worker.cpp:158-163)."""
    min_sc = options.min_sample_count
    max_sc = options.max_sample_count
    stats = min(max(min_sc // 4, 1), 64)
    candidate_batch = max(max(min_sc, max_sc // 4) // stats, 2)
    check = (
        min(max(min_sc // 2, (max_sc - min_sc) // 8, 8, stats), 1024) // stats
    )
    return stats, candidate_batch, check


def _kernel_seed(generator, device):
    """The megakernels' int32 seed, drawn on the rays' device (no sync)."""
    if isinstance(generator, RecordedDraws):
        raise TypeError("recorded draws drive the wavefront only; the megakernels draw "
                        "their own stream (set PTX_NO_MEGAKERNEL=1 / PTX_DIFF_MEGAKERNEL=0)")
    return torch.randint(0, 2**31 - 1, (1,), generator=generator, device=device,
                         dtype=torch.int32)


def _dispatch_trace(scene: SceneData, rays, options: RenderOptions, generator,
                    differentiable: bool = False):
    """The tracer of a ray batch, as film.py:63-107 picks it. Differentiable
    traces take the record-and-replay path (`trace_diff`: K2 with records,
    backward over the replay) when the scene is within the kernels' limits,
    else the wavefront; forward traces take the megakernels when within
    their limits, else the wavefront (its intersections through K5 on the
    card). Among the megakernels PTX_SORTED_WAVEFRONT picks as in JAX:
    "1" sends every scene to the sorted driver and K2, "0" every scene to
    K1 (binned scenes to its binned while-loop form), anything else binned
    scenes to the sorted driver and dense scenes to K1.
    PTX_NO_MEGAKERNEL=1 and PTX_DIFF_MEGAKERNEL=0 are the JAX package's
    switches to the wavefront. CUDA rays run the kernels, CPU rays their
    twins."""
    no_mega = os.environ.get("PTX_NO_MEGAKERNEL") == "1"
    if differentiable:
        if (not no_mega and os.environ.get("PTX_DIFF_MEGAKERNEL", "1") != "0"
                and diff_supported(scene)):
            return trace_diff(scene, rays, options, _kernel_seed(generator, rays.origin.device))
    elif not no_mega and megakernel_supported(scene):
        seed = _kernel_seed(generator, rays.origin.device)
        flag = os.environ.get("PTX_SORTED_WAVEFRONT")
        if flag == "1" or (flag != "0" and scene.has_kernel_records):
            return trace_megakernel_sorted(scene, rays, options, seed)
        return trace_megakernel(scene, rays, options, seed)
    return trace(scene, rays, options, generator, differentiable)


def morton_perm(px: np.ndarray, py: np.ndarray) -> np.ndarray:
    """Permutation sorting integer pixel coordinates into Morton (Z-curve)
    order (film.py:110-126)."""
    px = np.asarray(px, np.int64)
    py = np.asarray(py, np.int64)
    if px.size and (px.max() >= 1 << 16 or py.max() >= 1 << 16):
        raise ValueError("morton_perm supports pixel coordinates < 65536")
    code = np.zeros_like(px)
    for b in range(16):
        code |= ((px >> b) & 1) << (2 * b)
        code |= ((py >> b) & 1) << (2 * b + 1)
    return np.argsort(code, kind="stable")


def use_pixel_order(scene: SceneData, device) -> bool:
    """Morton pixel order pays only on the cluster traversal, on a CUDA
    device."""
    return scene.has_kernel_records and torch.device(device).type == "cuda"


def _trace_samples(scene, camera, options, x_cam, y_cam, generator, spp,
                   pixel_order=None, differentiable=False):
    if pixel_order is not None:
        xs = x_cam[pixel_order].repeat_interleave(spp)
        ys = y_cam[pixel_order].repeat_interleave(spp)
    else:
        xs = x_cam.repeat(spp)
        ys = y_cam.repeat(spp)
    rays = shoot_rays(
        camera, xs, ys, 1.0 / options.image_width, 1.0 / options.image_height,
        generator,
    )
    return _dispatch_trace(scene, rays, options, generator, differentiable)


def render_chunk(scene: SceneData, camera: Camera, options: RenderOptions,
                 x_cam: torch.Tensor, y_cam: torch.Tensor,
                 generator: torch.Generator, spp: int, pixel_order=None,
                 differentiable: bool = False):
    """Trace `spp` samples for P pixels; returns (sum [P,4], collected [P]
    int32). With `pixel_order` ([P] permutation, see morton_perm) the rays
    launch pixel-major over the permuted pixels and the sums are scattered
    back, so the result is positionally that of the plain call.
    `differentiable` keeps the sums' graph to the scene's material
    tensors. `generator`: a torch.Generator or a RecordedDraws."""
    p = x_cam.shape[0]
    spectrum, collected = _trace_samples(
        scene, camera, options, x_cam, y_cam, generator, spp, pixel_order, differentiable
    )
    if pixel_order is not None:
        spectrum = spectrum.reshape(p, spp, 4)
        collected = collected.reshape(p, spp)
        s = torch.where(collected[..., None], spectrum, 0.0).sum(1)
        c = collected.sum(1, dtype=torch.int32)
        return (torch.zeros_like(s).index_copy_(0, pixel_order, s),
                torch.zeros_like(c).index_copy_(0, pixel_order, c))
    spectrum = spectrum.reshape(spp, p, 4)
    collected = collected.reshape(spp, p)
    return (
        torch.where(collected[..., None], spectrum, 0.0).sum(0),
        collected.sum(0, dtype=torch.int32),
    )


def render_chunk_batched(scene: SceneData, camera: Camera,
                         options: RenderOptions, x_cam: torch.Tensor,
                         y_cam: torch.Tensor, generator: torch.Generator,
                         spp_batch: int, k_batches: int, pixel_order=None):
    """`k_batches` stats batches in ONE launch of k_batches * spp_batch
    samples; returns per-batch (sums [K,P,4], counts [K,P])."""
    p = x_cam.shape[0]
    spectrum, collected = _trace_samples(
        scene, camera, options, x_cam, y_cam, generator, spp_batch * k_batches,
        pixel_order,
    )
    if pixel_order is not None:
        # Pixel-major: [P, K, spp_batch] sample groups per pixel.
        spectrum = spectrum.reshape(p, k_batches, spp_batch, 4)
        collected = collected.reshape(p, k_batches, spp_batch)
        s = torch.where(collected[..., None], spectrum, 0.0).sum(2).movedim(0, 1)
        c = collected.sum(2, dtype=torch.int32).movedim(0, 1)
        return (torch.zeros_like(s).index_copy_(1, pixel_order, s),
                torch.zeros_like(c).index_copy_(1, pixel_order, c))
    spectrum = spectrum.reshape(k_batches, spp_batch, p, 4)
    collected = collected.reshape(k_batches, spp_batch, p)
    return (
        torch.where(collected[..., None], spectrum, 0.0).sum(1),
        collected.sum(1, dtype=torch.int32),
    )


def _apply_stats_batches(s_b, coll_b, c0, pixel_sum, n_collected, frozen,
                         accepted, remaining, stats_means, stats_valid,
                         kb, min_sc, check):
    """Fold `kb` stats-batch results into the adaptive state one after
    another (ref: worker.cpp:200-259 Welford batches + consecutive-pass
    rule). Returns the new state plus the all-frozen early-break flag (a
    0-dim bool tensor)."""
    stats_means = stats_means.clone()
    stats_valid = stats_valid.clone()
    for j in range(kb):
        s = s_b[j]
        coll = coll_b[j]
        c = c0 + j
        live = ~frozen
        pixel_sum = torch.where(live[:, None], pixel_sum + s, pixel_sum)
        n_collected = torch.where(live, n_collected + coll, n_collected)
        chunk_mean = s / coll.clamp_min(1)[:, None]
        chunk_ok = live & (coll > 0)
        stats_means[:, c] = torch.where(chunk_ok[:, None], chunk_mean, 0.0)
        stats_valid[:, c] = chunk_ok

        ns = stats_valid.sum(1, dtype=torch.int32)
        safe_ns = ns.clamp_min(1)
        mean = torch.where(stats_valid[..., None], stats_means, 0.0).sum(1) / safe_ns[:, None]
        dev = torch.where(stats_valid[..., None], stats_means - mean[:, None, :], 0.0)
        m2 = (dev * dev).sum(1)
        m2w = m2 / (ns - 1).clamp_min(1)[:, None]
        stddev = torch.sqrt(m2w[..., 0] + m2w[..., 1] + m2w[..., 2])
        mean_contrib = (mean[..., 0] + mean[..., 1] + mean[..., 2]) / 3.0

        checkable = live & (n_collected >= min_sc) & (ns >= 2)
        passed = checkable & (
            (stddev < 1e-4) | (stddev / (3.0 * 3.0 * mean_contrib + 1e-5) < 0.2)
        )
        remaining = torch.where(
            passed, remaining - 1,
            torch.where(checkable, torch.full_like(remaining, check), remaining),
        )
        newly_accepted = passed & (remaining <= 0)
        accepted = accepted | newly_accepted
        frozen = frozen | newly_accepted
    return (pixel_sum, n_collected, frozen, accepted, remaining,
            stats_means, stats_valid, (frozen | accepted).all())


def _candidate_select(stats_means, stats_valid, cbc, fallback, min_count):
    """Biased candidate selection (ref: worker.cpp:273-317), vectorised:
    candidates are consecutive groups of `cbc` stats batches; the lowest
    stddev candidate wins, near ties are averaged in. Returns [P,4]."""
    p, ns, _ = stats_means.shape
    n_cand = math.ceil(ns / cbc)
    pad = n_cand * cbc - ns
    if pad:
        stats_means = torch.nn.functional.pad(stats_means, (0, 0, 0, pad))
        stats_valid = torch.nn.functional.pad(stats_valid, (0, pad))
    g_means = stats_means.reshape(p, n_cand, cbc, 4)
    g_valid = stats_valid.reshape(p, n_cand, cbc)

    count = g_valid.sum(-1, dtype=torch.int32)
    safe = count.clamp_min(1)
    mean = torch.where(g_valid[..., None], g_means, 0.0).sum(2) / safe[..., None]
    dev = torch.where(g_valid[..., None], g_means - mean[:, :, None, :], 0.0)
    m2 = (dev * dev).sum(2)
    m2w = m2 / safe[..., None]
    stddev = torch.sqrt(m2w[..., 0] + m2w[..., 1] + m2w[..., 2])
    stddev = torch.where(count >= min_count, stddev, float("inf"))

    order = torch.argsort(stddev, dim=1, stable=True)
    s_sorted = torch.gather(stddev, 1, order)
    c_sorted = torch.gather(mean, 1, order[..., None].expand(-1, -1, 4))

    any_valid = torch.isfinite(s_sorted[:, 0])
    pixel = c_sorted[:, 0]
    cur_s = s_sorted[:, 0]
    still = any_valid
    for i in range(1, n_cand):
        ok = still & (s_sorted[:, i] < torch.maximum(cur_s + 0.005, cur_s * 1.01))
        pixel = torch.where(ok[:, None], pixel + (c_sorted[:, i] - pixel) / (i + 1.0), pixel)
        cur_s = torch.where(ok, s_sorted[:, i], cur_s)
        still = ok
    return torch.where(any_valid[:, None], pixel, fallback)


def render_tile(scene: SceneData, camera: Camera, options: RenderOptions,
                x_cam: torch.Tensor, y_cam: torch.Tensor,
                generator: torch.Generator, pixel_order=None) -> torch.Tensor:
    """Adaptive render of one pixel tile; returns [P,4] pixel values."""
    p = x_cam.shape[0]
    dev = x_cam.device
    stats, cbc, check = adaptive_constants(options)
    min_sc = max(options.min_sample_count, 2)
    max_sc = options.max_sample_count
    n_full = max_sc // stats
    remainder = max_sc - n_full * stats

    pixel_sum = torch.zeros((p, 4), device=dev)
    n_collected = torch.zeros(p, dtype=torch.int32, device=dev)
    frozen = torch.zeros(p, dtype=torch.bool, device=dev)
    accepted = torch.zeros(p, dtype=torch.bool, device=dev)
    remaining = torch.full((p,), check, dtype=torch.int32, device=dev)
    stats_means = torch.zeros((p, max(n_full, 1), 4), device=dev)
    stats_valid = torch.zeros((p, max(n_full, 1)), dtype=torch.bool, device=dev)

    def single(spp):
        return render_chunk(scene, camera, options, x_cam, y_cam, generator, spp,
                            pixel_order)

    fuse = max(1, int(os.environ.get("PTX_ADAPTIVE_FUSE", str(ADAPTIVE_FUSE))))
    # The all-frozen flag of launch L is read only after launch L + lag is
    # enqueued, so the device has work while the host waits on the flag
    # (film.py:398). Frozen pixels stop accumulating, so extra launches
    # change nothing.
    flag_lag = 3 if fuse == 1 else 1
    pending_flags: list = []
    n_launches = math.ceil(n_full / fuse) if n_full else 0
    c0 = 0
    for _ in range(n_launches):
        kb = min(fuse, n_full - c0)
        if kb == 1:
            s, coll = single(stats)
            s_b, coll_b = s[None], coll[None]
        else:
            s_b, coll_b = render_chunk_batched(
                scene, camera, options, x_cam, y_cam, generator, stats, kb,
                pixel_order,
            )
        (pixel_sum, n_collected, frozen, accepted, remaining,
         stats_means, stats_valid, flag) = _apply_stats_batches(
            s_b, coll_b, c0, pixel_sum, n_collected, frozen, accepted,
            remaining, stats_means, stats_valid, kb=kb, min_sc=min_sc,
            check=check,
        )
        c0 += kb
        if max_sc > min_sc and c0 >= (min_sc // stats):
            pending_flags.append(flag)
            if len(pending_flags) > flag_lag and bool(pending_flags.pop(0)):
                break

    if remainder > 0:
        s, coll = single(remainder)
        live = ~frozen
        pixel_sum = torch.where(live[:, None], pixel_sum + s, pixel_sum)
        n_collected = torch.where(live, n_collected + coll, n_collected)

    pixel_value = pixel_sum / n_collected.clamp_min(1)[:, None]
    if options.allow_bias:
        min_count = max((cbc * 3) // 4, 2)
        biased = _candidate_select(stats_means, stats_valid, cbc, pixel_value, min_count)
        pixel_value = torch.where(accepted[:, None], pixel_value, biased)
    # Pixels that never collected anything stay exactly zero.
    return torch.where((n_collected > 0)[:, None], pixel_value, 0.0)


def render(scene: SceneData, camera: Camera, options: RenderOptions,
           seed: int = 0, progress_callback=None, rays_per_launch: int = 1 << 20,
           device=None) -> np.ndarray:
    """Full-frame render (ref: worker.cpp:389-427 processJob). Returns an
    [H, W, 4] float32 image (RGB radiance + any-hit alpha). Runs on
    `device` (default: the scene's); tiles of rows hold up to
    `rays_per_launch` rays per stats batch."""
    w, h = options.image_width, options.image_height
    if w <= 0 or h <= 0:
        return np.zeros((max(h, 0), max(w, 0), 4), np.float32)
    dev = torch.device(device) if device is not None else scene.device
    scene = scene.to(dev)
    camera = camera.to(dev)
    generator = torch.Generator(device=dev)
    generator.manual_seed(int(seed))

    stats, _, _ = adaptive_constants(options)
    rows_per_tile = max(1, min(h, rays_per_launch // max(w * stats, 1)))
    n_tiles = math.ceil(h / rows_per_tile)
    px = np.arange(w, dtype=np.float32)
    image = np.zeros((h, w, 4), np.float32)
    order = use_pixel_order(scene, dev)
    perm_cache: dict = {}  # tile height -> device permutation
    for i in range(n_tiles):
        y0 = i * rows_per_tile
        rows = min(rows_per_tile, h - y0)
        py = np.arange(y0, y0 + rows, dtype=np.float32)
        xg, yg = np.meshgrid(px, py)
        perm = None
        if order:
            perm = perm_cache.get(rows)
            if perm is None:
                perm = torch.from_numpy(morton_perm(xg.ravel(), yg.ravel() - y0)).to(dev)
                perm_cache[rows] = perm
        x_cam, y_cam = pixel_camera_coords(options, xg.ravel(), yg.ravel())
        tile = render_tile(
            scene, camera, options,
            torch.from_numpy(np.ascontiguousarray(x_cam, np.float32)).to(dev),
            torch.from_numpy(np.ascontiguousarray(y_cam, np.float32)).to(dev),
            generator, pixel_order=perm,
        )
        image[y0:y0 + rows] = tile.reshape(rows, w, 4).cpu().numpy()
        if progress_callback is not None:
            progress_callback(i + 1, n_tiles)
    return image
