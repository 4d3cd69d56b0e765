"""Color conventions (port of `cpupathtrace_tpu/utils/color.py`).

The reference wraps RGBA in `Color<T>` (ref: include/PathTrace/util/color.h)
and radiance in `Spectrum` (ref: scene/light.h:12); both are plain
`[..., 4]` float tensors here (last axis = RGBA).
"""
from __future__ import annotations

import torch


def rgba(r, g, b, a=1.0, device=None) -> torch.Tensor:
    return torch.tensor([r, g, b, a], dtype=torch.float32, device=device)


def rgb_mean(color: torch.Tensor) -> torch.Tensor:
    """(r+g+b)/3, the reference's getContribution (ref: worker.cpp:12-14)."""
    return color[..., :3].mean(dim=-1)


def brightness(color: torch.Tensor) -> torch.Tensor:
    """max(r,g,b) (ref: post_processing.cpp:22-24)."""
    return color[..., :3].amax(dim=-1)


def brightness_heuristic(color: torch.Tensor) -> torch.Tensor:
    """a * ((r+g+b)/3 + max(r,g,b)) / 2, the tone mapper's pixel weight
    (ref: post_processing.cpp:27-30)."""
    return color[..., 3] * (rgb_mean(color) + brightness(color)) / 2.0
