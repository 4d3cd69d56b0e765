"""X2: does a tile-wide conditional cost more as the live state around it
grows?

Port of benchmarks/experiments/microbench_cond_fat.py to the card: 64 tiles
of 8 x 128 float32 (x [512, 128]); each carries `n_live` copies of its tile
(copy i = x * float32(1 + 0.001 i)) through `n_iter` iterations. An
iteration takes y = copy 0 through K_CONDS = 8 updates y <- y * 1.000001 +
1e-6, each under the tile-wide predicate max(y) > -1 (`use_cond`, the
script's lax.cond) or unconditional, then adds y * 1e-12 to every copy.
Output: copy 0 + sum of copy i * 1e-6, in order [512, 128]; with
`taken=True` also each tile's count of updates applied [64] int32 (8 per
iteration without the predicate). The kernel is csrc/exp_cond_fat.cu, one
block per tile, the predicate a block-wide vote; `cond_fat_reference` is
the plain version. Both use `any(y > -1)` for the predicate, which is
max(y) > -1 for finite y (a NaN would make the script's max NaN and the
predicate false, and is ignored here).

The script's input (x = 0.5) cannot show the work: y * 1e-12 is below
float32 resolution next to 0.5, and whether an update ran never reaches the
output. The check inputs (`check_inputs`) mix tiles whose output moves with
the updates (zeros, small values) with tiles whose predicate is decided at
the edge: all -2 (not taken), -2 with one element at -0.999 (taken by the
whole tile), a maximum of exactly -1 (not taken) and of nextafter(-1, 0)
(taken); the taken counts show a predicate error where the output cannot.

`main()` runs the script's sweep (n_live in {2, 19}, with and without the
predicate, n_iter in {256, 1024}) and prints, from the difference between
the two iteration counts, two figures: the latency of one iteration (the
64 blocks run at once, one per SM, on 64 of the card's SMs) and the card's
time per block iteration (that over 64, the TPU script's figure, where one
core ran the tiles one after another).

    python -m cpupathtrace_tpu_torch.experiments.cond_fat
"""
from __future__ import annotations

import ctypes

import numpy as np
import torch

from .. import _build
from ..accel.kernel_traverse import check_tensor
from . import best_ms, card, need_cuda

ROWS, LANES, BLOCKS = 8, 128, 64
TILE = ROWS * LANES
K_CONDS = 8
SWEEP_LIVE = (2, 19)
SWEEP_COND = (True, False)
SWEEP_ITERS = (256, 1024)
REPS = 3
# The script's constants as float32, rounded from the Python floats as JAX
# rounds a weak-typed scalar: the copies' scales, the update's product and
# addend, the fold into the copies and the output's weight.
LIVE_SCALE = tuple(float(np.float32(1.0 + 0.001 * i)) for i in range(max(SWEEP_LIVE)))
MUL = float(np.float32(1.000001))
ADD = float(np.float32(0.000001))
FOLD = float(np.float32(1e-12))
WEIGHT = float(np.float32(1e-6))


def instance(n_live: int, use_cond: bool) -> str:
    """The name of a kernel instance: live2_cond, live19_inline, ..."""
    return f"live{n_live}_{'cond' if use_cond else 'inline'}"


INSTANCES = tuple(instance(n, c) for n in SWEEP_LIVE for c in SWEEP_COND)


def script_inputs():
    """The script's x (:47): [512, 128] of 0.5."""
    return np.full((ROWS * BLOCKS, LANES), 0.5, np.float32)


def check_inputs():
    """x [512, 128] from np.random.default_rng(2), tile b of kind b % 8:
    0 zeros; 1 all -2; 2 all -2 but one element -0.999; 3 uniform in
    [-3, -1) with one element exactly -1; 4 uniform in [-3, -1.5) with one
    element nextafter(-1, 0); 5 normal * 0.5; 6 uniform in [-1.5, -1.1];
    7 uniform in [0, 1e-3). Kinds 0, 2, 4, 5, 7 take every update, 1, 3, 6
    none."""
    rng = np.random.default_rng(2)
    x = np.zeros((BLOCKS, TILE), np.float32)
    for b in range(BLOCKS):
        kind = b % 8
        at = rng.integers(TILE)
        if kind in (1, 2):
            x[b] = -2.0
            if kind == 2:
                x[b, at] = -0.999
        elif kind == 3:
            x[b] = rng.uniform(-3.0, -1.0, TILE)
            x[b, at] = -1.0
        elif kind == 4:
            x[b] = rng.uniform(-3.0, -1.5, TILE)
            x[b, at] = np.nextafter(np.float32(-1.0), np.float32(0.0))
        elif kind == 5:
            x[b] = rng.normal(size=TILE) * 0.5
        elif kind == 6:
            x[b] = rng.uniform(-1.5, -1.1, TILE)
        elif kind == 7:
            x[b] = rng.uniform(0.0, 1e-3, TILE)
    return x.reshape(ROWS * BLOCKS, LANES)


def expected_taken(x, n_iter: int, use_cond: bool):
    """Each tile's update count on the check inputs, from the kinds: 8 per
    iteration where any element exceeds -1, else 0 (an update moves y by
    ~1e-6 of itself, too little to cross -1 within a run)."""
    tiles = np.asarray(x).reshape(-1, TILE)
    taken = (tiles > -1.0).any(1) if use_cond else np.ones(tiles.shape[0], bool)
    return np.where(taken, K_CONDS * n_iter, 0).astype(np.int32)


def cond_fat_reference(x, n_iter: int, n_live: int, use_cond: bool, taken: bool = False):
    """The plain version: o [512, 128] and with `taken` the per-tile
    update counts [64] int32; the kernel's float32 operations in its order
    (no fused multiply-add)."""
    cond_fat_reference.calls += 1
    blocks = x.shape[0] // ROWS
    xb = x.reshape(blocks, TILE)
    live = [xb * LIVE_SCALE[i] for i in range(n_live)]
    count = torch.zeros(blocks, dtype=torch.int32, device=x.device)
    for _ in range(n_iter):
        y = live[0]
        for _ in range(K_CONDS):
            upd = y * MUL + ADD
            if use_cond:
                pred = (y > -1.0).any(1)
                y = torch.where(pred[:, None], upd, y)
                count += pred.to(torch.int32)
            else:
                y = upd
                count += 1
        live = [a + y * FOLD for a in live]
    acc = live[0]
    for a in live[1:]:
        acc = acc + a * WEIGHT
    out = acc.reshape(blocks * ROWS, LANES)
    return (out, count) if taken else out


cond_fat_reference.calls = 0


def _launch_fn():
    fn = _build.load("exp_cond_fat").ptx_cond_fat_launch
    if fn.argtypes is None:
        p, i = ctypes.c_void_p, ctypes.c_int
        fn.argtypes = [p, p, p, p, i, i, i, i, p]
        fn.restype = ctypes.c_int
    return fn


def cond_fat(x, n_iter: int, n_live: int, use_cond: bool, taken: bool = False):
    """o [512, 128] (and with `taken` the per-tile update counts): CPU
    tensors take the plain version, CUDA tensors launch
    csrc/exp_cond_fat.cu (n_live 2 or 19)."""
    dev = x.device
    if dev.type == "cpu":
        return cond_fat_reference(x, n_iter, n_live, use_cond, taken)
    if dev.type != "cuda":
        raise ValueError(f"cond_fat: no kernel for device {dev}")
    if n_live not in SWEEP_LIVE:
        raise ValueError(f"cond_fat: n_live {n_live} must be one of {SWEEP_LIVE}")
    check_tensor("x", x, dev, torch.float32, (None, LANES))
    blocks = x.shape[0] // ROWS
    if x.shape[0] != blocks * ROWS:
        raise ValueError(f"cond_fat: x has {x.shape[0]} rows, not a multiple of {ROWS}")
    scale = (ctypes.c_float * n_live)(*LIVE_SCALE[:n_live])
    o = torch.empty_like(x)
    cnt = torch.empty(blocks, dtype=torch.int32, device=dev) if taken else None
    with torch.cuda.device(dev):
        err = _launch_fn()(x.data_ptr(), scale, o.data_ptr(),
                           None if cnt is None else cnt.data_ptr(), blocks, n_live,
                           int(use_cond), int(n_iter), torch.cuda.current_stream(dev).cuda_stream)
    if err:
        raise RuntimeError(f"cond_fat launch failed: cudaError_t {err}")
    cond_fat.launches[instance(n_live, use_cond)] += 1
    return (o, cnt) if taken else o


# Launches per instance.
cond_fat.launches = dict.fromkeys(INSTANCES, 0)


def cond_fat_ops(n_live: int, use_cond: bool, n_iter: int, blocks: int = BLOCKS) -> int:
    """Float operations of a call: per element and iteration 8 updates of
    a multiply and an add (and the predicate's compare with the
    conditional), then n_live multiply-adds of the fold; the copies'
    scaling and the output's weighted sum once."""
    per_iter = K_CONDS * (3 if use_cond else 2) + 2 * n_live
    return blocks * TILE * (n_iter * per_iter + n_live + 2 * (n_live - 1))


def sweep(reps: int = REPS):
    """The TPU script's sweep on the card: one dict per (n_live, use_cond)
    with the best launch ms at each n_iter, the latency of one iteration
    (`iter_us`: the 64 blocks at once) and the card's time per block
    iteration (`card_ns_per_block_iter`: iter_us / 64, the script's
    figure)."""
    need_cuda()
    x = torch.from_numpy(script_inputs()).cuda()
    out = []
    for n_live in SWEEP_LIVE:
        for use_cond in SWEEP_COND:
            ms = {n: best_ms(lambda n=n: cond_fat(x, n, n_live, use_cond), reps)
                  for n in SWEEP_ITERS}
            lo, hi = SWEEP_ITERS
            iter_us = (ms[hi] - ms[lo]) / (hi - lo) * 1e3
            out.append(dict(n_live=n_live, use_cond=use_cond, ms=ms, iter_us=iter_us,
                            card_ns_per_block_iter=iter_us / BLOCKS * 1e3))
    return out


def main():
    name = card()
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    for r in sweep():
        print(f"live={r['n_live']:3d} cond={r['use_cond']}: {r['iter_us']:8.4f} us per iteration "
              f"({BLOCKS} blocks at once on {BLOCKS} of {sms} SMs), card "
              f"{r['card_ns_per_block_iter']:9.2f} ns per block iteration "
              f"({K_CONDS} conds per iter)  ({name})", flush=True)


if __name__ == "__main__":
    main()
