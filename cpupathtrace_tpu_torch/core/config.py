"""Render configuration: the same frozen dataclass and fields as
`cpupathtrace_tpu/core/config.py` (ref: include/PathTrace/worker.h:14-31).

* `allow_bias` is honest: the biased candidate-selection fallback only runs
  when it is True (the reference declares the flag but never reads it).
* `max_depth` bounds the bounce loop; roulette (p <= 0.2 past depth 4) and
  the 1e-20 `bounce_pd` cutoff end paths long before 64 bounces.
"""
from __future__ import annotations

import dataclasses

import torch


def resolve_device(device) -> torch.device:
    """The device of an entry point that builds tensors: `device`, or the
    CUDA card when it is None. Raises when the card is asked for on a
    machine without CUDA; the CPU runs only when the caller names it."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            f"device {dev} requested (the default) but CUDA is not available; "
            "pass device='cpu' to run on the CPU"
        )
    return dev


@dataclasses.dataclass(frozen=True)
class RenderOptions:
    image_width: int
    image_height: int
    min_sample_count: int = 16
    max_sample_count: int = 64
    epsilon: float = 1e-3
    allow_bias: bool = False
    max_depth: int = 64
    # Kept for field parity with the JAX package; the port's film fuses
    # launches by rays_per_launch (integrator/film.py:render).
    samples_per_launch: int = 0
    dense_intersect_threshold: int = 128

    def __post_init__(self):
        if self.max_sample_count < self.min_sample_count:
            object.__setattr__(self, "max_sample_count", self.min_sample_count)
