"""The megakernel's per-ray random stream: xorshift32 seeded through the
murmur3 finaliser.

Bit-exact port of `cpupathtrace_tpu/integrator/pallas_megakernel.py`
`_seed_rng` / `_fmix32` / `_next_u01`. torch has no uint32 shifts, so states
ride int64 tensors holding values in [0, 2^32), masked after every step,
and 32-bit products are split so no int64 product overflows.

The TPU megakernel seeds each lane by (seed + pid * 1000003, row, lane) of
its ray block of 128 lanes: (64, 128) for dense scenes and (8, 128) for
binned ones (pallas_megakernel.py _BLOCK_ROWS / _KRN_BLOCK_ROWS). For global
ray index i in blocks of R rows that is pid = i // (R * 128),
row = (i // 128) % R and lane = i % 128 (csrc/rng.cuh does the same).
"""
from __future__ import annotations

import torch

MASK32 = 0xFFFFFFFF
BLOCK_ROWS = 64
BINNED_BLOCK_ROWS = 8
LANES = 128
BLOCK_RAYS = BLOCK_ROWS * LANES
PID_STRIDE = 1000003


def mul32(a: torch.Tensor, b: int) -> torch.Tensor:
    """(a * b) mod 2^32 for int64 `a` in [0, 2^32) and a constant b."""
    lo = (a & 0xFFFF) * b
    hi = ((a >> 16) * b) & 0xFFFF
    return (lo + (hi << 16)) & MASK32


def finalise32(s: torch.Tensor) -> torch.Tensor:
    """The murmur3 finaliser: a bijection of [0, 2^32)."""
    s = s ^ (s >> 16)
    s = mul32(s, 0x85EBCA6B)
    s = s ^ (s >> 13)
    s = mul32(s, 0xC2B2AE35)
    return s ^ (s >> 16)


def fmix32(s: torch.Tensor) -> torch.Tensor:
    """murmur3 finaliser, then force the state non-zero."""
    return finalise32(s) | 1


def chunk_seed(seed: int, chunk: int) -> int:
    """The torch.Generator seed of chunk `chunk` of a resumable render with
    `seed` (integrator/checkpoint.py), the port's counterpart of JAX's
    fold_in(PRNGKey(seed), chunk): the high word mixes the seed's 64 bits,
    the low word finalises the chunk index xor that word (each word
    offset by a constant, as seed_rng offsets its terms). It depends
    on (seed, chunk) alone, and, the finaliser being a bijection, chunks
    below 2^32 of one seed get distinct seeds."""
    words = torch.tensor([seed & MASK32, (seed >> 32) & MASK32, chunk & MASK32],
                         dtype=torch.int64)
    hi = finalise32(words[0] ^ finalise32(words[1] ^ 0x9E3779B9))
    lo = finalise32(words[2] ^ hi ^ 0x85EBCA6B)
    return (int(hi) << 32) | int(lo)


def seed_rng(seed, ray_index: torch.Tensor, block_rows: int = BLOCK_ROWS) -> torch.Tensor:
    """Initial state of global ray `ray_index` (int64) for int32 `seed`
    (a Python int or a 1-element tensor) in ray blocks of `block_rows` x
    128. `seed + pid * 1000003` wraps as int32 and is then read as uint32,
    as on the TPU."""
    pid = ray_index // (block_rows * LANES)
    row = (ray_index // LANES) % block_rows
    lane = ray_index % LANES
    if isinstance(seed, torch.Tensor):
        seed = seed.reshape(-1)[:1].to(device=ray_index.device, dtype=torch.int64)
    s0 = (seed + pid * PID_STRIDE) & MASK32
    s = (
        mul32(s0, 2654435761)
        ^ ((row * 40503 + 0x9E3779B9) & MASK32)
        ^ ((lane * 2246822519 + 0x85EBCA6B) & MASK32)
    )
    return fmix32(s)


def next_u01(state: torch.Tensor):
    """Advance xorshift32; returns (state, float32 uniform in [0, 1))."""
    state = state ^ ((state << 13) & MASK32)
    state = state ^ (state >> 17)
    state = state ^ ((state << 5) & MASK32)
    u = (state >> 8).to(torch.float32) * (1.0 / (1 << 24))
    return state, u


# ---------------------------------------------------------------------------
# Host-drawn uniforms: the camera's and the wavefront's random inputs.
# ---------------------------------------------------------------------------


class RecordedDraws:
    """Uniform draws made elsewhere, handed out in the order the port asks
    for them: [n, 2] camera jitter, then per wavefront bounce [n] (roulette),
    [n, K, 3] (emitter NEE, when K > 0) and [n, 3] (BSDF sample). It stands
    where a torch.Generator or a seed goes, so a test can feed the JAX
    package's jax.random draws to the port."""

    def __init__(self, arrays):
        self.arrays = [torch.as_tensor(a, dtype=torch.float32) for a in arrays]
        self.pos = 0

    def next(self, shape, device) -> torch.Tensor:
        if self.pos >= len(self.arrays):
            raise IndexError(f"RecordedDraws: all {len(self.arrays)} draws used")
        a = self.arrays[self.pos]
        if tuple(a.shape) != tuple(shape):
            raise ValueError(f"RecordedDraws: draw {self.pos} has shape {tuple(a.shape)}, "
                             f"asked for {tuple(shape)}")
        self.pos += 1
        return a.to(device)


def uniform(source, shape, device) -> torch.Tensor:
    """float32 uniforms in [0, 1) of `shape` from `source`: a
    torch.Generator, or the next array of a RecordedDraws."""
    if isinstance(source, RecordedDraws):
        return source.next(shape, device)
    return torch.rand(shape, generator=source, device=device)


def draw_source(key, device):
    """A stream of uniforms from `key`: an int seeds a new generator on
    `device` (each call starts the same stream, as a JAX key does); a
    RecordedDraws starts again from its first draw; a torch.Generator is
    used as it stands and advances."""
    if isinstance(key, RecordedDraws):
        return RecordedDraws(key.arrays)
    if isinstance(key, torch.Generator):
        return key
    gen = torch.Generator(device=device)
    gen.manual_seed(int(key))
    return gen
