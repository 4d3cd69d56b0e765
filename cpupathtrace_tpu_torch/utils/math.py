"""Batched vector math on torch tensors whose last axis is the vector axis
(the parts of `cpupathtrace_tpu/utils/math.py` the dense render path uses;
ref: include/PathTrace/util/vector.h)."""
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
