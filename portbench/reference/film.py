"""The reference's camera and film: the rays and pixel sums of a frame.

A frame with a torch seed draws, in the order the program's film defines
(its launch plan, frozen below): per launch, the camera jitter of every ray
of the launch ([rays, 2] uniforms from one torch.Generator on the device),
then the launch's int32 path seed. Ray i of a launch of S samples over P
pixels is sample i // P of pixel i % P ("sample-major"), or, where the
program orders binned scenes' rays by pixel on the card ("pixel-major"),
sample i % S of the pixel at Morton position i // S. A pixel's value is the
mean radiance of its samples that hit anything, 0 where none did.

Frozen copies, with the file each was copied from: `camera_vectors`
(cpupathtrace_tpu_torch/camera/camera.py `make_camera`), `pixel_coords`
(integrator/film.py `pixel_camera_coords`), `launch_plan` (film.py
`adaptive_constants`, `render_tile`'s fused launches at the default fuse
of 4, one tile of rows) and `morton_perm` (film.py).
"""
from __future__ import annotations

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


def launch_plan(spp: int, width: int, height: int):
    """Samples per launch of a frame at a fixed sample count."""
    stats = min(max(spp // 4, 1), 64)
    if RAYS_PER_LAUNCH // max(width * stats, 1) < height:
        raise ValueError("the reference's film covers frames of one tile")
    n_full = spp // stats
    plan = [stats * min(FUSE, n_full - c) for c in range(0, n_full, FUSE)]
    if spp - n_full * stats:
        plan.append(spp - n_full * stats)
    return plan


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


def frame_paths(cam: dict, width: int, height: int, spp: int, torch_seed: int, pixels,
                pixel_major: bool, device):
    """The paths of `pixels` (flat indices) in a frame: yields per launch
    (origin, direction, ray index, pixel slot, path seed)."""
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
    for s_launch in launch_plan(spp, width, height):
        jitter = torch.rand((n_pix * s_launch, 2), generator=gen, device=device) - 0.5
        kseed = int(torch.randint(0, 2**31 - 1, (1,), generator=gen, device=device,
                                  dtype=torch.int32))
        slot = torch.arange(pixels.numel(), device=device).repeat(s_launch)
        sample = torch.arange(s_launch, device=device).repeat_interleave(pixels.numel())
        if pixel_major:
            ray = pos[slot] * s_launch + sample
        else:
            ray = sample * n_pix + pixels[slot]
        o, d = camera_rays(cam, x[slot], y[slot], jitter[ray], width, height)
        yield o, d, ray, slot, kseed


def add_counts(a: list, b: list) -> list:
    """Element-wise sum of two lists of counts of unequal length."""
    n = max(len(a), len(b))
    return [(a[i] if i < len(a) else 0) + (b[i] if i < len(b) else 0) for i in range(n)]


def render_pixels(scene: RefScene, geo: Geometry, cam: dict, width: int, height: int,
                  spp: int, torch_seed: int, pixels, layout: str, pixel_major: bool,
                  max_depth: int, eps: float, device, dtype=torch.float32):
    """Pixel values [len(pixels), 3] float64 of a frame, and the frame's
    path count entering each depth (summed over launches)."""
    n = len(pixels)
    total = torch.zeros((n, 3), dtype=torch.float64, device=device)
    count = torch.zeros(n, dtype=torch.float64, device=device)
    entering: list[int] = []
    for o, d, ray, slot, kseed in frame_paths(cam, width, height, spp, torch_seed, pixels,
                                               pixel_major, device):
        for a in range(0, ray.numel(), PATH_BLOCK):
            sl = slice(a, a + PATH_BLOCK)
            out, coll, ent = trace(scene, geo, o[sl], d[sl], prng.seed_paths(layout, kseed, ray[sl]),
                                   max_depth, eps, dtype=dtype)
            total.index_add_(0, slot[sl], torch.where(coll[:, None], out, 0).double())
            count.index_add_(0, slot[sl], coll.double())
            entering = add_counts(entering, ent)
    value = torch.where(count[:, None] > 0, total / count.clamp_min(1)[:, None], 0.0)
    return value, entering


def loss_and_grad(scene: RefScene, geo: Geometry, cam: dict, width: int, height: int,
                  spp: int, torch_seed: int, params: dict, target, max_depth: int, eps: float,
                  device, dtype=torch.float32):
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
    for o, d, ray, slot, kseed in frame_paths(cam, width, height, spp, torch_seed,
                                               np.arange(n_pix), False, device):
        for a in range(0, ray.numel(), PATH_BLOCK):
            sl = slice(a, a + PATH_BLOCK)
            out, coll, ent = trace(scene, geo, o[sl], d[sl], prng.seed_flat(kseed, ray[sl]),
                                   max_depth, eps, params=mats, dtype=dtype)
            total = total.index_add(0, slot[sl], torch.where(coll[:, None], out, 0).double())
            count.index_add_(0, slot[sl], coll.double())
            entering = add_counts(entering, ent)
    img = total / count.clamp_min(1)[:, None]
    diff = img - torch.as_tensor(target, device=device)[:, :3].double()
    loss = (diff * diff).mean()
    grads = torch.autograd.grad(loss, list(leaves.values()))
    return float(loss.detach()), {k: g.double() for k, g in zip(leaves, grads)}, entering
