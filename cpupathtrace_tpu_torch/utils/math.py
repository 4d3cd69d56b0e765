"""Batched vector math on torch tensors whose last axis is the vector axis
(the parts of `cpupathtrace_tpu/utils/math.py` the render and gradient
paths use; ref: include/PathTrace/util/vector.h)."""
from __future__ import annotations

import torch

PI = 3.14159265358979323846


def dot(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Dot product over the last axis, summed x + y + z in that order."""
    return a[..., 0] * b[..., 0] + a[..., 1] * b[..., 1] + a[..., 2] * b[..., 2]


def cross(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """3D cross product over the last axis (ref: util/vector.h:234)."""
    return torch.stack(
        [
            a[..., 1] * b[..., 2] - a[..., 2] * b[..., 1],
            a[..., 2] * b[..., 0] - a[..., 0] * b[..., 2],
            a[..., 0] * b[..., 1] - a[..., 1] * b[..., 0],
        ],
        dim=-1,
    )


def length(v: torch.Tensor) -> torch.Tensor:
    return torch.sqrt(dot(v, v))


def normalize(v: torch.Tensor) -> torch.Tensor:
    """Unchecked normalize: a zero vector gives inf/nan like the reference."""
    return v / length(v)[..., None]


def length_squared(v: torch.Tensor) -> torch.Tensor:
    return dot(v, v)


def reflect(v: torch.Tensor, n: torch.Tensor) -> torch.Tensor:
    """Reflect direction v (pointing toward the surface) about unit normal n
    (ref: util/vector.h:250)."""
    return v - n * (2.0 * dot(v, n))[..., None]


def orthonormal_frame(n: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """Tangent and bitangent (b1, b2) with {b1, b2, n} orthonormal, by the
    reference's branch structure as selects (ref: propagation.cpp:24-62):
      |nx|>0 & |ny|>0 -> d = (0, -nx, ny);  |nx|>0 & ny==0 -> d = (0, -nx, nz)
      nx==0 & |ny|>0  -> d = (-ny, nz, 0);  nx==0 & ny==0  -> d = (1, 0, 0)
    then b1 = normalize(cross(d, n)), b2 = normalize(cross(b1, n))."""
    nx, ny, nz = n[..., 0], n[..., 1], n[..., 2]
    zero = torch.zeros_like(nx)
    one = torch.ones_like(nx)
    has_x = (nx.abs() > 0.0)[..., None]
    has_y = (ny.abs() > 0.0)[..., None]
    d = torch.where(
        has_x,
        torch.where(has_y, torch.stack([zero, -nx, ny], -1), torch.stack([zero, -nx, nz], -1)),
        torch.where(has_y, torch.stack([-ny, nz, zero], -1), torch.stack([one, zero, zero], -1)),
    )
    d = normalize(d)
    b1 = normalize(cross(d, n))
    b2 = normalize(cross(b1, n))
    return b1, b2


def local_to_global(vec: torch.Tensor, n: torch.Tensor) -> torch.Tensor:
    """Tangent-space vector (z = normal axis) to world space
    (ref: src/scene/propagation.cpp:24-62)."""
    b1, b2 = orthonormal_frame(n)
    return b1 * vec[..., 0:1] + b2 * vec[..., 1:2] + n * vec[..., 2:3]
