"""The reference's thin-lens camera with a circular aperture.

A frozen copy of cpupathtrace_tpu_torch/camera/camera.py (`draw_uniforms`,
`_sample_circular`, `shoot_rays`; upstream src/camera.cpp:7-19, 78-113):
a launch draws, from the frame's generator, the jitter uniforms of all its
rays ([n, 2], then shifted to [-0.5, 0.5)), then the aperture uniforms
([n, 2]). The aperture point is the sqrt polar warp of its two uniforms,
scaled by the half widths; its x offset runs along the camera's `up` and
its y offset along `right` (the upstream quirk, camera.cpp:99). The ray
leaves that point for the point where the pinhole ray through the sensor
point meets the focal plane.
"""
from __future__ import annotations

import math

import numpy as np
import torch

from .film import camera_vectors


def _normalize(v):
    return v / torch.sqrt(v[:, 0] * v[:, 0] + v[:, 1] * v[:, 1] + v[:, 2] * v[:, 2])[:, None]


class ThinLens:
    """The camera of a configuration's "camera" with "aperture" circular,
    "aperture_width", "aperture_height" and "focal_plane_dist" (> 0); a
    callable as reference/film.py describes."""

    def __init__(self, cam: dict):
        if cam.get("aperture") != "circular" or not cam.get("focal_plane_dist", 0) > 0:
            raise ValueError(f"ThinLens takes a circular aperture and a focal plane: {cam}")
        self.cam = cam
        # Stored as float32 values, as make_camera stores them.
        self.half_w = float(np.float32(cam["aperture_width"] / 2.0))
        self.half_h = float(np.float32(cam["aperture_height"] / 2.0))
        self.focal = float(np.float32(cam["focal_plane_dist"]))

    def __call__(self, gen, n: int, ray, x, y, width: int, height: int):
        dev = x.device
        jitter = torch.rand((n, 2), generator=gen, device=dev) - 0.5
        aperture = torch.rand((n, 2), generator=gen, device=dev)
        return self.rays(x, y, jitter[ray], aperture[ray], width, height)

    def rays(self, x, y, jitter, aperture, width: int, height: int):
        """(origin, direction) [n, 3] float32 of the sensor points (x, y)
        with their jitter and aperture uniforms."""
        dev = x.device
        origin, forward, up, right = (torch.as_tensor(v, device=dev)
                                      for v in camera_vectors(self.cam))
        sx = x + jitter[:, 0] * (1.0 / width)
        sy = y + jitter[:, 1] * (1.0 / height)
        sensor = origin - forward - up * sy[:, None] - right * sx[:, None]
        r = torch.sqrt(aperture[:, 0])
        theta = 2.0 * math.pi * aperture[:, 1]
        ap_x = r * torch.cos(theta) * self.half_w
        ap_y = r * torch.sin(theta) * self.half_h
        ray_origin = origin + up * ap_x[:, None] + right * ap_y[:, None]
        base = _normalize(origin - sensor)
        denom = forward[0] * base[:, 0] + forward[1] * base[:, 1] + forward[2] * base[:, 2]
        fpd = torch.full((), self.focal, dtype=torch.float32, device=dev)
        target = origin + base * (fpd / denom)[:, None]
        return ray_origin, _normalize(target - ray_origin)
