"""The per-path random stream of the port's kernels, frozen here so that the
reference draws the same uniforms from the same seeds.

Copied from cpupathtrace_tpu_torch/integrator/rng.py (`mul32`, `finalise32`,
`fmix32`, `seed_rng`), cpupathtrace_tpu_torch/integrator/sorted_wavefront.py
(`_seed_rng_flat`) and cpupathtrace_tpu_torch/csrc/rng.cuh (`next_u01`): a
xorshift32 state per path, seeded through the murmur3 finaliser. Two seed
layouts exist: "block" (K1: ray i in blocks of `rows` x 128 lanes) and
"flat" (K2's sorted driver and the gradient path: the original ray index).
States ride int64 tensors holding values in [0, 2^32).
"""
from __future__ import annotations

import torch

MASK32 = 0xFFFFFFFF
LANES = 128
PID_STRIDE = 1000003


def mul32(a: torch.Tensor, b: int) -> torch.Tensor:
    """(a * b) mod 2^32 for int64 `a` in [0, 2^32) and a constant b."""
    lo = (a & 0xFFFF) * b
    hi = ((a >> 16) * b) & 0xFFFF
    return (lo + (hi << 16)) & MASK32


def finalise32(s: torch.Tensor) -> torch.Tensor:
    s = s ^ (s >> 16)
    s = mul32(s, 0x85EBCA6B)
    s = s ^ (s >> 13)
    s = mul32(s, 0xC2B2AE35)
    return s ^ (s >> 16)


def fmix32(s: torch.Tensor) -> torch.Tensor:
    return finalise32(s) | 1


def seed_block(seed: int, ray_index: torch.Tensor, rows: int) -> torch.Tensor:
    """State of ray `ray_index` in blocks of `rows` x 128 lanes; `seed` is
    the launch's int32 seed."""
    pid = ray_index // (rows * LANES)
    row = (ray_index // LANES) % rows
    lane = ray_index % LANES
    s0 = (int(seed) + pid * PID_STRIDE) & MASK32
    s = (mul32(s0, 2654435761)
         ^ ((row * 40503 + 0x9E3779B9) & MASK32)
         ^ ((lane * 2246822519 + 0x85EBCA6B) & MASK32))
    return fmix32(s)


def seed_flat(seed: int, ray_index: torch.Tensor) -> torch.Tensor:
    """State of ray `ray_index` in the flat layout."""
    idx = ray_index & MASK32
    s = (mul32(torch.full_like(idx, int(seed) & MASK32), 2654435761)
         ^ ((mul32(idx, 40503) + 0x9E3779B9) & MASK32)
         ^ ((mul32(idx >> 7, 2246822519) + 0x85EBCA6B) & MASK32))
    return fmix32(s)


def seed_paths(layout: str, seed: int, ray_index: torch.Tensor) -> torch.Tensor:
    """"block64", "block8" or "flat"."""
    if layout == "flat":
        return seed_flat(seed, ray_index)
    if layout.startswith("block"):
        return seed_block(seed, ray_index, int(layout[5:]))
    raise ValueError(f"unknown seed layout {layout!r}")


def next_u01(state: torch.Tensor):
    """(new state, uniform in [0, 1) from its top 24 bits as float32)."""
    s = state ^ ((state << 13) & MASK32)
    s = s ^ (s >> 17)
    s = s ^ ((s << 5) & MASK32)
    return s, (s >> 8).to(torch.float32) * (1.0 / 16777216.0)
