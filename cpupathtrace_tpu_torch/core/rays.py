"""A batch of rays: [R, 3] float32 origins and unit directions on one device."""
from __future__ import annotations

import dataclasses

import torch


@dataclasses.dataclass(frozen=True)
class Rays:
    origin: torch.Tensor  # [R, 3] f32
    direction: torch.Tensor  # [R, 3] f32
