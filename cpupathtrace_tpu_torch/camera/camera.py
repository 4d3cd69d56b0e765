"""Batched perspective camera with aperture and thin lens, in torch.

Port of `cpupathtrace_tpu/camera/camera.py` (ref: src/camera.cpp:51-113):
look-at frame with signed aspect ratio, sub-pixel jitter, circular aperture
(sqrt polar warp), hexagonal aperture (16 fixed rejection rounds, then sign
flips), the reference's aperture-axis quirk (x along `up`, y along `right`,
camera.cpp:99) and the thin-lens focal plane.

The random draws come from an explicit `torch.Generator` (or a
RecordedDraws, integrator/rng.py), or are passed in through `uniforms`
(tests feed the JAX package's draws to compare rays).
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from ..core.config import resolve_device
from ..core.rays import Rays
from ..integrator.rng import uniform
from ..utils.math import PI, dot, normalize

APERTURE_NONE = "none"
APERTURE_CIRCULAR = "circular"
APERTURE_HEXAGONAL = "hexagonal"

HEX_ROUNDS = 16


@dataclasses.dataclass(frozen=True)
class Camera:
    origin: torch.Tensor  # [3] f32
    forward: torch.Tensor  # [3] forward_dir * focal_length
    up: torch.Tensor  # [3] up_dir * height/2
    right: torch.Tensor  # [3] right_dir * height/2 * aspect_ratio
    # Scalars, rounded to float32 as the JAX package stores them.
    aperture_width_half: float
    aperture_height_half: float
    hex_horizontal_ratio: float
    focal_plane_dist: float  # <= 0 disables the thin lens
    aperture: str  # one of APERTURE_*

    def to(self, device) -> "Camera":
        return dataclasses.replace(
            self,
            origin=self.origin.to(device), forward=self.forward.to(device),
            up=self.up.to(device), right=self.right.to(device),
        )


def make_camera(
    origin,
    look_at,
    up,
    focal_length: float = 1.0,
    height: float = 1.0,
    aspect_ratio: float = 1.0,
    aperture_width: float = 0.0,
    aperture_height: float = 0.0,
    aperture: str = APERTURE_NONE,
    hex_horizontal_ratio: float = 0.5,
    focal_plane_dist: float = 0.0,
    device=None,
) -> Camera:
    """Look-at construction (ref: src/camera.cpp:54-76), numpy arithmetic
    identical to the JAX package's, on `device` (default: the CUDA card)."""
    device = resolve_device(device)
    origin = np.asarray(origin, np.float32)
    look_at = np.asarray(look_at, np.float32)
    up = np.asarray(up, np.float32)

    forward_dir = look_at - origin
    forward_dir = forward_dir / np.linalg.norm(forward_dir)
    forward = forward_dir * focal_length

    up_dir = up / np.linalg.norm(up)
    height_half = height / 2.0
    up_v = up_dir * height_half
    right_dir = np.cross(forward, up_v)
    right_dir = right_dir / np.linalg.norm(right_dir)
    right = right_dir * (height_half * aspect_ratio)

    hr = min(max(float(hex_horizontal_ratio), 0.0), 1.0)

    def vec(v):
        return torch.tensor(np.asarray(v, np.float32), device=device)

    return Camera(
        origin=vec(origin),
        forward=vec(forward),
        up=vec(up_v),
        right=vec(right),
        aperture_width_half=float(np.float32(aperture_width / 2.0)),
        aperture_height_half=float(np.float32(aperture_height / 2.0)),
        hex_horizontal_ratio=float(np.float32(hr)),
        focal_plane_dist=float(np.float32(focal_plane_dist)),
        aperture=aperture,
    )


def draw_uniforms(camera: Camera, n: int, generator: torch.Generator,
                  device) -> dict:
    """The camera's random inputs for n rays: "jitter" [n,2] in
    [-0.5, 0.5); "aperture" [n,2] (circular) or "hex" [n,16,2] and
    "flips" [n,2] bool (hexagonal)."""
    def rand(*shape):
        return uniform(generator, shape, device)

    u = {"jitter": rand(n, 2) - 0.5}
    if camera.aperture == APERTURE_CIRCULAR:
        u["aperture"] = rand(n, 2)
    elif camera.aperture == APERTURE_HEXAGONAL:
        u["hex"] = rand(n, HEX_ROUNDS, 2)
        u["flips"] = rand(n, 2) < 0.5
    return u


def _sample_circular(u):
    """r = sqrt(u) polar warp (ref: camera.cpp:7-19)."""
    r = torch.sqrt(u[:, 0])
    theta = 2.0 * PI * u[:, 1]
    return r * torch.cos(theta), r * torch.sin(theta)


def _sample_hexagonal(cand, flips, horizontal_ratio):
    """First accepted candidate under the reference's rule
    `rel_x <= 0 || rel_x/(1-hr) >= y`, the last one when none is
    (probability < 2^-16), then sign flips (ref: camera.cpp:25-49)."""
    x = cand[..., 0]
    y = cand[..., 1]
    rel_x = x - horizontal_ratio
    denom = torch.tensor(
        np.float32(1.0) - np.float32(horizontal_ratio), device=cand.device
    )
    accept = (rel_x <= 0.0) | (rel_x / denom >= y)
    first = torch.argmax(accept.to(torch.int8), dim=-1)
    pick = torch.where(accept.any(dim=-1), first, HEX_ROUNDS - 1)
    x = torch.gather(x, -1, pick[:, None])[:, 0]
    y = torch.gather(y, -1, pick[:, None])[:, 0]
    x = torch.where(flips[:, 0], -x, x)
    y = torch.where(flips[:, 1], -y, y)
    return x, y


def shoot_rays(
    camera: Camera,
    x: torch.Tensor,
    y: torch.Tensor,
    pixel_width: float,
    pixel_height: float,
    generator: torch.Generator | None = None,
    uniforms: dict | None = None,
) -> Rays:
    """One camera ray per (x, y) in [-1, 1] sensor coordinates
    (ref: src/camera.cpp:78-113 Camera::shootRay)."""
    n = x.shape[0]
    if uniforms is None:
        uniforms = draw_uniforms(camera, n, generator, x.device)
    jit = uniforms["jitter"]
    sensor_x = x + jit[:, 0] * pixel_width
    sensor_y = y + jit[:, 1] * pixel_height

    sensor_pos = (
        camera.origin
        - camera.forward
        - camera.up * sensor_y[:, None]
        - camera.right * sensor_x[:, None]
    )

    if camera.aperture == APERTURE_CIRCULAR:
        ap_x, ap_y = _sample_circular(uniforms["aperture"])
    elif camera.aperture == APERTURE_HEXAGONAL:
        ap_x, ap_y = _sample_hexagonal(
            uniforms["hex"], uniforms["flips"], camera.hex_horizontal_ratio
        )
    else:
        ap_x = torch.zeros(n, device=x.device)
        ap_y = torch.zeros(n, device=x.device)

    ap_x = ap_x * camera.aperture_width_half
    ap_y = ap_y * camera.aperture_height_half

    # x offset along `up`, y along `right` (reference quirk, camera.cpp:99).
    ray_origin = camera.origin + camera.up * ap_x[:, None] + camera.right * ap_y[:, None]

    # Thin lens (ref: camera.cpp:102-110); both branches computed, selected.
    base_dir = normalize(camera.origin - sensor_pos)
    denom = dot(camera.forward.expand_as(base_dir), base_dir)
    # A fill on the device: a host value copied in would wait for the stream.
    fpd = torch.full((), camera.focal_plane_dist, dtype=torch.float32, device=x.device)
    ray_target = camera.origin + base_dir * (fpd / denom)[:, None]
    dir_lens = normalize(ray_target - ray_origin)
    dir_pinhole = normalize(ray_origin - sensor_pos)
    ray_dir = dir_lens if camera.focal_plane_dist > 0.0 else dir_pinhole

    return Rays(origin=ray_origin.expand(n, 3).contiguous(), direction=ray_dir)
