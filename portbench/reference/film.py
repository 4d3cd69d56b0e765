"""The reference's camera and film: the rays and pixel sums of a frame.

A frame with a torch seed draws, in the order the program's film defines
(its launch plan, frozen below): per launch, the camera's uniforms for
every ray of the launch (the pinhole's jitter: [rays, 2] uniforms from one
torch.Generator on the device), then the launch's int32 path seed. Ray i of
a launch of S samples over P pixels is sample i // P of pixel i % P
("sample-major"), or, where the program orders binned scenes' rays by pixel
on the card ("pixel-major"), sample i % S of the pixel at Morton position
i // S. At a fixed sample count a pixel's value is the mean radiance of its
samples that hit anything, 0 where none did; an adaptive frame
(`render_pixels_adaptive`) applies the film's stopping rule between stats
batches.

The camera and the tracer are seams. A camera is a callable
`camera(gen, n, ray, x, y, width, height) -> (origin, direction)`: it draws
the launch's uniforms for all `n` rays from `gen`, in the program's order,
and returns the rays of the launch's ray indices `ray` through sensor
points `x`, `y`. A tracer is a callable `tracer(origin, direction, state,
max_depth, eps, params=None) -> (radiance [N,3], collected [N], entering)`.
`Pinhole` and `triangle_tracer` are the frozen defaults; a configuration's
module may give its own (portbench/run.py). The film (the launch plan, the
stopping rule and the pixel sums) is shared.

Frozen copies, with the file each was copied from: `camera_vectors`
(cpupathtrace_tpu_torch/camera/camera.py `make_camera`), and from
cpupathtrace_tpu_torch/integrator/film.py `pixel_coords`
(`pixel_camera_coords`), `morton_perm`, `adaptive_constants`,
`adaptive_plan` (`render_tile`'s fused launches at the default fuse of 4,
one tile of rows, and its remainder launch; `launch_plan` is its
fixed-count case), `fold_batch` (the body of `_apply_stats_batches`'
loop) and `candidate_select` (`_candidate_select`).
"""
from __future__ import annotations

import math

import numpy as np
import torch

from . import rng as prng
from .intersect import Geometry
from .scene import RefScene
from .tracer import trace

FUSE = 4
RAYS_PER_LAUNCH = 1 << 20
PATH_BLOCK = 1 << 20


def camera_vectors(cam: dict):
    """(origin, forward, up, right) float32 of a pinhole camera."""
    f32 = np.float32
    origin = np.asarray(cam["origin"], f32)
    look_at = np.asarray(cam["look_at"], f32)
    up = np.asarray(cam["up"], f32)
    fwd = look_at - origin
    fwd = fwd / np.linalg.norm(fwd)
    forward = fwd * cam["focal_length"]
    up_v = up / np.linalg.norm(up) * (cam["height"] / 2.0)
    right = np.cross(forward, up_v)
    right = right / np.linalg.norm(right) * (cam["height"] / 2.0 * cam["aspect_ratio"])
    return origin, forward.astype(f32), up_v.astype(f32), right.astype(f32)


def pixel_coords(width: int, height: int):
    """Sensor coordinates [P] float32 of the pixels, row-major."""
    xg, yg = np.meshgrid(np.arange(width, dtype=np.float32), np.arange(height, dtype=np.float32))
    x = 2.0 * ((xg.ravel() + 0.5) / width - 0.5)
    y = -2.0 * ((yg.ravel() + 0.5) / height - 0.5)
    return x.astype(np.float32), y.astype(np.float32)


def adaptive_constants(min_sc: int, max_sc: int):
    """The film's batch constants (stats, candidate_batch, check), integer
    division preserved."""
    stats = min(max(min_sc // 4, 1), 64)
    candidate_batch = max(max(min_sc, max_sc // 4) // stats, 2)
    check = min(max(min_sc // 2, (max_sc - min_sc) // 8, 8, stats), 1024) // stats
    return stats, candidate_batch, check


def adaptive_plan(min_sc: int, max_sc: int, width: int, height: int):
    """The launches of an adaptive frame that no early stop cuts short:
    (samples, stats batches) each, `stats` samples a batch and up to FUSE
    batches a launch, then the remainder launch, which holds no stats
    batch: (max_sc mod stats, 0)."""
    stats, _, _ = adaptive_constants(min_sc, max_sc)
    if RAYS_PER_LAUNCH // max(width * stats, 1) < height:
        raise ValueError("the reference's film covers frames of one tile")
    n_full = max_sc // stats
    plan = [(stats * min(FUSE, n_full - c), min(FUSE, n_full - c))
            for c in range(0, n_full, FUSE)]
    if max_sc - n_full * stats:
        plan.append((max_sc - n_full * stats, 0))
    return plan


def launch_plan(spp: int, width: int, height: int):
    """Samples per launch of a frame at a fixed sample count."""
    return [samples for samples, _ in adaptive_plan(spp, spp, width, height)]


def morton_perm(width: int, height: int) -> np.ndarray:
    xg, yg = np.meshgrid(np.arange(width, dtype=np.int64), np.arange(height, dtype=np.int64))
    px, py = xg.ravel(), yg.ravel()
    code = np.zeros_like(px)
    for b in range(16):
        code |= ((px >> b) & 1) << (2 * b)
        code |= ((py >> b) & 1) << (2 * b + 1)
    return np.argsort(code, kind="stable")


def camera_rays(cam: dict, x, y, jitter, width: int, height: int, dtype=torch.float32):
    """Pinhole rays through sensor points (x, y) [n] jittered by [n,2]."""
    dev = x.device
    origin, forward, up, right = (torch.as_tensor(v, device=dev) for v in camera_vectors(cam))
    sx = x + jitter[:, 0] * (1.0 / width)
    sy = y + jitter[:, 1] * (1.0 / height)
    sensor = origin - forward - up * sy[:, None] - right * sx[:, None]
    v = origin - sensor
    dirs = v / torch.sqrt(v[:, 0] * v[:, 0] + v[:, 1] * v[:, 1] + v[:, 2] * v[:, 2])[:, None]
    return origin.expand(x.shape[0], 3).to(dtype), dirs.to(dtype)


class Pinhole:
    """The frozen pinhole camera of a configuration's "camera": a launch
    draws [n, 2] jitter uniforms in [-0.5, 0.5)."""

    def __init__(self, cam: dict):
        self.cam = cam

    def __call__(self, gen, n: int, ray, x, y, width: int, height: int):
        jitter = torch.rand((n, 2), generator=gen, device=x.device) - 0.5
        return camera_rays(self.cam, x, y, jitter[ray], width, height)


def triangle_tracer(scene: RefScene, dtype=torch.float32):
    """The frozen triangle tracer (tracer.py) over `scene`'s triangles,
    queried through `Geometry` in `dtype`."""
    geo = Geometry(scene, dtype=dtype)

    def run(origin, direction, state, max_depth: int, eps: float, params=None):
        return trace(scene, geo, origin, direction, state, max_depth, eps, params=params,
                     dtype=dtype)

    return run


def frame_paths(camera, width: int, height: int, plan, torch_seed: int, pixels,
                pixel_major: bool, device):
    """The paths of `pixels` (flat indices) in a frame of launches of
    `plan` samples each: yields per launch (origin, direction, ray index,
    pixel slot, sample of the launch, path seed)."""
    gen = torch.Generator(device=device)
    gen.manual_seed(int(torch_seed))
    n_pix = width * height
    x_all, y_all = pixel_coords(width, height)
    pixels = torch.as_tensor(pixels, dtype=torch.int64, device=device)
    x = torch.as_tensor(x_all, device=device)[pixels]
    y = torch.as_tensor(y_all, device=device)[pixels]
    pos = None
    if pixel_major:
        inv = np.empty(n_pix, np.int64)
        inv[morton_perm(width, height)] = np.arange(n_pix)
        pos = torch.as_tensor(inv, device=device)[pixels]
    for s_launch in plan:
        slot = torch.arange(pixels.numel(), device=device).repeat(s_launch)
        sample = torch.arange(s_launch, device=device).repeat_interleave(pixels.numel())
        if pixel_major:
            ray = pos[slot] * s_launch + sample
        else:
            ray = sample * n_pix + pixels[slot]
        o, d = camera(gen, n_pix * s_launch, ray, x[slot], y[slot], width, height)
        kseed = int(torch.randint(0, 2**31 - 1, (1,), generator=gen, device=device,
                                  dtype=torch.int32))
        yield o, d, ray, slot, sample, kseed


def add_counts(a: list, b: list) -> list:
    """Element-wise sum of two lists of counts of unequal length."""
    n = max(len(a), len(b))
    return [(a[i] if i < len(a) else 0) + (b[i] if i < len(b) else 0) for i in range(n)]


def _accumulate(tracer, o, d, ray, group, total, count, layout: str, kseed: int,
                max_depth: int, eps: float, entering: list) -> list:
    """Traces a launch's paths in blocks and adds each collected radiance
    (float64) and collected count into `total` [G,3] and `count` [G] at its
    `group`. Returns the entering counts with the launch's added."""
    for a in range(0, ray.numel(), PATH_BLOCK):
        sl = slice(a, a + PATH_BLOCK)
        out, coll, ent = tracer(o[sl], d[sl], prng.seed_paths(layout, kseed, ray[sl]),
                                max_depth, eps)
        total.index_add_(0, group[sl], torch.where(coll[:, None], out, 0).double())
        count.index_add_(0, group[sl], coll.double())
        entering = add_counts(entering, ent)
    return entering


def render_pixels(tracer, camera, width: int, height: int, spp: int, torch_seed: int, pixels,
                  layout: str, pixel_major: bool, max_depth: int, eps: float, device):
    """Pixel values [len(pixels), 3] float64 of a frame at a fixed sample
    count, and the frame's path count entering each depth (summed over
    launches)."""
    n = len(pixels)
    total = torch.zeros((n, 3), dtype=torch.float64, device=device)
    count = torch.zeros(n, dtype=torch.float64, device=device)
    entering: list[int] = []
    for o, d, ray, slot, _, kseed in frame_paths(camera, width, height,
                                                 launch_plan(spp, width, height), torch_seed,
                                                 pixels, pixel_major, device):
        entering = _accumulate(tracer, o, d, ray, slot, total, count, layout, kseed, max_depth,
                               eps, entering)
    value = torch.where(count[:, None] > 0, total / count.clamp_min(1)[:, None], 0.0)
    return value, entering


def fold_batch(st: dict, s, coll, c: int, min_sc: int, check: int):
    """Folds stats batch `c` (sums s [n,3], collected counts coll [n]) into
    the per-pixel state `st`, as the film folds each batch: a frozen pixel
    takes nothing; a live one adds the batch and records its mean as stats
    sample c where it collected anything; a pixel with min_sc samples and
    two stats samples passes where its stddev is under 1e-4 or under a
    fifth of 9 x its mean, and is accepted and frozen after `check`
    consecutive passes."""
    live = ~st["frozen"]
    st["sum"] = torch.where(live[:, None], st["sum"] + s, st["sum"])
    st["n"] = torch.where(live, st["n"] + coll, st["n"])
    ok = live & (coll > 0)
    st["means"][:, c] = torch.where(ok[:, None], s / coll.clamp_min(1)[:, None], 0.0)
    st["valid"][:, c] = ok
    valid = st["valid"]
    ns = valid.sum(1)
    mean = torch.where(valid[..., None], st["means"], 0.0).sum(1) / ns.clamp_min(1)[:, None]
    dev = torch.where(valid[..., None], st["means"] - mean[:, None, :], 0.0)
    m2w = (dev * dev).sum(1) / (ns - 1).clamp_min(1)[:, None]
    stddev = torch.sqrt(m2w[:, 0] + m2w[:, 1] + m2w[:, 2])
    mean_contrib = (mean[:, 0] + mean[:, 1] + mean[:, 2]) / 3.0
    checkable = live & (st["n"] >= min_sc) & (ns >= 2)
    passed = checkable & ((stddev < 1e-4) | (stddev / (3.0 * 3.0 * mean_contrib + 1e-5) < 0.2))
    st["remaining"] = torch.where(passed, st["remaining"] - 1,
                                  torch.where(checkable, torch.full_like(st["remaining"], check),
                                              st["remaining"]))
    newly = passed & (st["remaining"] <= 0)
    st["accepted"] = st["accepted"] | newly
    st["frozen"] = st["frozen"] | newly


def candidate_select(means, valid, cbc: int, fallback, min_count: int):
    """The biased candidate selection: candidates are consecutive groups of
    `cbc` stats samples; the one of least stddev wins, and the next ones in
    order of stddev are averaged in while each is under max(s + 0.005,
    1.01 s) of the last taken; `fallback` where no candidate has
    `min_count` valid samples."""
    n, ns, k = means.shape
    n_cand = math.ceil(ns / cbc)
    pad = n_cand * cbc - ns
    if pad:
        means = torch.nn.functional.pad(means, (0, 0, 0, pad))
        valid = torch.nn.functional.pad(valid, (0, pad))
    g_means = means.reshape(n, n_cand, cbc, k)
    g_valid = valid.reshape(n, n_cand, cbc)
    count = g_valid.sum(-1)
    safe = count.clamp_min(1)
    mean = torch.where(g_valid[..., None], g_means, 0.0).sum(2) / safe[..., None]
    dev = torch.where(g_valid[..., None], g_means - mean[:, :, None, :], 0.0)
    m2w = (dev * dev).sum(2) / safe[..., None]
    stddev = torch.sqrt(m2w[..., 0] + m2w[..., 1] + m2w[..., 2])
    stddev = torch.where(count >= min_count, stddev, float("inf"))
    order = torch.argsort(stddev, dim=1, stable=True)
    s_sorted = torch.gather(stddev, 1, order)
    c_sorted = torch.gather(mean, 1, order[..., None].expand(-1, -1, k))
    any_valid = torch.isfinite(s_sorted[:, 0])
    pixel = c_sorted[:, 0]
    cur = s_sorted[:, 0]
    still = any_valid
    for i in range(1, n_cand):
        ok = still & (s_sorted[:, i] < torch.maximum(cur + 0.005, cur * 1.01))
        pixel = torch.where(ok[:, None], pixel + (c_sorted[:, i] - pixel) / (i + 1.0), pixel)
        cur = torch.where(ok, s_sorted[:, i], cur)
        still = ok
    return torch.where(any_valid[:, None], pixel, fallback)


def render_pixels_adaptive(tracer, camera, width: int, height: int, min_sc: int, max_sc: int,
                           allow_bias: bool, torch_seed: int, pixels, layout: str,
                           pixel_major: bool, max_depth: int, eps: float, device):
    """Pixel values [len(pixels), 3] float64 of an adaptive frame of
    min_sc to max_sc samples a pixel, and the entering counts of the
    sampled pixels' paths.

    The frame's launches are drawn as the program draws them, every launch
    of `adaptive_plan`, and each sampled pixel's stats batches are folded
    in order by `fold_batch` (in float64); the remainder launch adds to the
    pixels still live; with `allow_bias` a pixel not accepted takes
    `candidate_select`'s value. The program stops a frame's launches early
    once it reads that every pixel is frozen; the reference never does,
    and that changes no pixel: a stop comes only when every pixel is
    frozen, a frozen pixel takes no sample and no stats sample from any
    later launch (its stats samples stay invalid, as those of a launch
    never made), and the launches before the stop drew the same uniforms
    and seeds either way.
    """
    stats, cbc, check = adaptive_constants(min_sc, max_sc)
    plan = adaptive_plan(min_sc, max_sc, width, height)
    n_full = sum(b for _, b in plan)
    n = len(pixels)
    f64 = dict(dtype=torch.float64, device=device)
    flag = dict(dtype=torch.bool, device=device)
    st = {"sum": torch.zeros((n, 3), **f64), "n": torch.zeros(n, **f64),
          "frozen": torch.zeros(n, **flag), "accepted": torch.zeros(n, **flag),
          "remaining": torch.full((n,), check, dtype=torch.int64, device=device),
          "means": torch.zeros((n, max(n_full, 1), 3), **f64),
          "valid": torch.zeros((n, max(n_full, 1)), **flag)}
    entering: list[int] = []
    c0 = 0
    paths = frame_paths(camera, width, height, [s for s, _ in plan], torch_seed, pixels,
                        pixel_major, device)
    for (_, kb), (o, d, ray, slot, sample, kseed) in zip(plan, paths):
        groups = max(kb, 1)
        total = torch.zeros((n * groups, 3), **f64)
        count = torch.zeros(n * groups, **f64)
        group = slot * groups + (sample // stats if kb else 0)
        entering = _accumulate(tracer, o, d, ray, group, total, count, layout, kseed, max_depth,
                               eps, entering)
        total, count = total.reshape(n, groups, 3), count.reshape(n, groups)
        for j in range(kb):
            fold_batch(st, total[:, j], count[:, j], c0 + j, max(min_sc, 2), check)
        c0 += kb
        if not kb:
            live = ~st["frozen"]
            st["sum"] = torch.where(live[:, None], st["sum"] + total[:, 0], st["sum"])
            st["n"] = torch.where(live, st["n"] + count[:, 0], st["n"])
    value = st["sum"] / st["n"].clamp_min(1)[:, None]
    if allow_bias:
        biased = candidate_select(st["means"], st["valid"], cbc, value, max((cbc * 3) // 4, 2))
        value = torch.where(st["accepted"][:, None], value, biased)
    return torch.where((st["n"] > 0)[:, None], value, 0.0), entering


def loss_and_grad(tracer, camera, width: int, height: int, spp: int, torch_seed: int,
                  params: dict, target, max_depth: int, eps: float, device):
    """The mean squared error of a one-launch frame's RGB against `target`
    [P, >=3] and its gradient in `params` ({"mat_diffuse", "mat_specular",
    "mat_emission"}: [M, 4] tables); the frame's paths are sample-major
    with flat path seeds. Returns (loss, {name: grad}, entering counts)."""
    leaves = {k: torch.as_tensor(v, device=device).detach().float().clone().requires_grad_(True)
              for k, v in params.items()}
    mats = {"diffuse": leaves["mat_diffuse"][:, :3], "specular": leaves["mat_specular"][:, :3],
            "emission": leaves["mat_emission"][:, :3]}
    n_pix = width * height
    total = torch.zeros((n_pix, 3), dtype=torch.float64, device=device)
    count = torch.zeros(n_pix, dtype=torch.float64, device=device)
    entering: list[int] = []
    for o, d, ray, slot, _, kseed in frame_paths(camera, width, height,
                                                 launch_plan(spp, width, height), torch_seed,
                                                 np.arange(n_pix), False, device):
        for a in range(0, ray.numel(), PATH_BLOCK):
            sl = slice(a, a + PATH_BLOCK)
            out, coll, ent = tracer(o[sl], d[sl], prng.seed_flat(kseed, ray[sl]), max_depth, eps,
                                    params=mats)
            total = total.index_add(0, slot[sl], torch.where(coll[:, None], out, 0).double())
            count.index_add_(0, slot[sl], coll.double())
            entering = add_counts(entering, ent)
    img = total / count.clamp_min(1)[:, None]
    diff = img - torch.as_tensor(target, device=device)[:, :3].double()
    loss = (diff * diff).mean()
    grads = torch.autograd.grad(loss, list(leaves.values()))
    return float(loss.detach()), {k: g.double() for k, g in zip(leaves, grads)}, entering
