"""X1: how much does the supercluster-tier slab pass cost per query?

Port of benchmarks/experiments/microbench_supscan.py to the card: 64 blocks
of `rows` x 128 rays (from x, as :23-28), `n_iter` iterations of every
ray's slab entries into `sp` supercluster boxes (the port's slab test, the
bounds in the port's [sp, 8] layout), each reducing a block-wide flag
(any entry < 1e30) into `acc`; output o [8 * 64, 128] = the block's first
8 rows of x + acc. The kernel is csrc/exp_supscan.cu; `supscan_reference`
is the plain version. `main()` runs the script's sweep (sp in {32, 128},
rows in {8, 16}, n_iter in {32, 128}) and prints, from the difference
between the two iteration counts as the TPU script did, two figures: the
latency of one iteration (all 64 blocks run at once, one per SM, on 64 of
the card's SMs) and the card's time per block iteration (that over 64).
The TPU ran the blocks one after another on one core, where the two were
the same figure.

The timed inputs are the script's, whose boxes all hold the ray origins,
so every block's flag is 1 whatever the slab tests give. The check inputs
(`check_inputs`) make the output depend on them: seeded boxes apart from
the origins, some invalid, rays that reach boxes in even blocks and leave
them all behind in odd ones, and the per-ray least entry (`entries=True`)
compared too.

    python -m cpupathtrace_tpu_torch.experiments.supscan
"""
from __future__ import annotations

import ctypes

import numpy as np
import torch

from .. import _build
from ..accel.kernel_traverse import BND_COLS, _inv_dir, check_tensor, pair_slab_entries
from . import best_ms, card, need_cuda

BLOCKS = 64
X_ROWS = 16  # rows of x per block
OUT_ROWS = 8
LANES = 128
SWEEP_SP = (32, 128)
SWEEP_ROWS = (8, 16)
SWEEP_ITERS = (32, 128)
# The TPU script's bounds rows are [sp, 128] lanes: lo 0:3, hi 3:6, valid 6.
_B_VALID = 6
REPS = 3


def script_inputs():
    """(x [16 * 64, 128], {sp: bounds [sp, 128]}) as the TPU script draws
    them from np.random.default_rng(0): x, then the bounds of sp = 32, 128."""
    rng = np.random.default_rng(0)
    x = rng.normal(size=(X_ROWS * BLOCKS, LANES)).astype(np.float32)
    sups = {}
    for sp in SWEEP_SP:
        sup = np.zeros((sp, 128), np.float32)
        sup[:, 0:3] = rng.uniform(-1, 0, (sp, 3))
        sup[:, 3:6] = rng.uniform(0, 1, (sp, 3))
        sup[:, _B_VALID] = 1.0
        sups[sp] = sup
    return x, sups


def inputs():
    """script_inputs with the bounds in the port's [sp, 8] layout."""
    x, sups = script_inputs()
    return x, {sp: to_port_bounds(s) for sp, s in sups.items()}


def check_inputs(sp: int):
    """(x [16 * 64, 128], bounds [sp, 8]) from np.random.default_rng(1) for
    the check: boxes of side 0.1-1.5 with lower corners in [0.3, 3]^3,
    every eighth one invalid. A ray is o = x (0.1, 0.2, 0.3), d = x + (1,
    2, 3): those of even blocks (x ~ N(0, 1)) start near the origin and
    head into the boxes' octant, those of odd blocks (x - 20) start below
    (-1.7, -3.4, -5.1) and move away from every box."""
    rng = np.random.default_rng(1)
    x = rng.normal(size=(BLOCKS, X_ROWS, LANES)).astype(np.float32)
    x[1::2] -= 20.0
    bnd = np.zeros((sp, BND_COLS), np.float32)
    bnd[:, 0:3] = rng.uniform(0.3, 3.0, (sp, 3))
    bnd[:, 3:6] = bnd[:, 0:3] + rng.uniform(0.1, 1.5, (sp, 3))
    bnd[:, _B_VALID] = (np.arange(sp) % 8 != 7).astype(np.float32)
    return x.reshape(BLOCKS * X_ROWS, LANES), bnd


def to_port_bounds(sup128):
    """The TPU's [sp, 128] bounds rows in the port's [sp, 8] layout."""
    out = np.zeros((sup128.shape[0], BND_COLS), np.float32)
    out[:, :7] = sup128[:, :7]
    return out


def supscan_reference(sup, x, n_iter: int, rows: int, entries: bool = False):
    """The plain version: o [8 * 64, 128], and with `entries` each ray's
    least entry over the boxes in the last iteration [64 * rows * 128]."""
    supscan_reference.calls += 1
    blocks = x.shape[0] // X_ROWS
    xb = x.reshape(blocks, X_ROWS, LANES)[:, :rows].reshape(blocks, -1)  # [B, rows * 128]
    ox, oy, oz = xb * 0.1, xb * 0.2, xb * 0.3
    ix, iy, iz = _inv_dir(xb + 1.0), _inv_dir(xb + 2.0), _inv_dir(xb + 3.0)
    acc = torch.zeros((blocks, 1), dtype=torch.float32, device=x.device)
    least = torch.full((blocks * rows * LANES,), float("inf"), device=x.device)
    for _ in range(n_iter):
        ent = pair_slab_entries(sup, (ox + acc * 1e-9).reshape(-1), oy.reshape(-1),
                                oz.reshape(-1), ix.reshape(-1), iy.reshape(-1), iz.reshape(-1))
        least = ent.amin(0)
        flag = (ent < 1e30).reshape(sup.shape[0], blocks, -1).any(2).any(0)
        acc = acc + flag.to(torch.float32)[:, None]
    out = x.reshape(blocks, X_ROWS, LANES)[:, :OUT_ROWS] + acc[:, :, None]
    out = out.reshape(blocks * OUT_ROWS, LANES)
    return (out, least) if entries else out


supscan_reference.calls = 0


def _launch_fn():
    fn = _build.load("exp_supscan").ptx_supscan_launch
    if fn.argtypes is None:
        p, i = ctypes.c_void_p, ctypes.c_int
        fn.argtypes = [p, i, p, p, p, i, i, i, p]
        fn.restype = ctypes.c_int
    return fn


def supscan(sup, x, n_iter: int, rows: int, entries: bool = False):
    """o [8 * 64, 128] (and with `entries` the per-ray least entry of the
    last iteration): CPU tensors take the plain version, CUDA tensors
    launch csrc/exp_supscan.cu."""
    dev = x.device
    if dev.type == "cpu":
        return supscan_reference(sup, x, n_iter, rows, entries)
    if dev.type != "cuda":
        raise ValueError(f"supscan: no kernel for device {dev}")
    if rows not in SWEEP_ROWS:
        raise ValueError(f"supscan: rows {rows} must be 8 or 16")
    check_tensor("sup", sup, dev, torch.float32, (None, BND_COLS))
    check_tensor("x", x, dev, torch.float32, (None, LANES))
    blocks = x.shape[0] // X_ROWS
    if x.shape[0] != blocks * X_ROWS:
        raise ValueError(f"supscan: x has {x.shape[0]} rows, not a multiple of {X_ROWS}")
    o = torch.empty((blocks * OUT_ROWS, LANES), dtype=torch.float32, device=dev)
    ent = (torch.empty(blocks * rows * LANES, dtype=torch.float32, device=dev)
           if entries else None)
    with torch.cuda.device(dev):
        err = _launch_fn()(sup.data_ptr(), sup.shape[0], x.data_ptr(), o.data_ptr(),
                           None if ent is None else ent.data_ptr(), blocks, rows, int(n_iter),
                           torch.cuda.current_stream(dev).cuda_stream)
    if err:
        raise RuntimeError(f"supscan launch failed: cudaError_t {err}")
    supscan.launches += 1
    return (o, ent) if entries else o


supscan.launches = 0


def slab_ops(sp: int, rows: int, n_iter: int, blocks: int = BLOCKS) -> int:
    """Float operations of a call: 31 per ray and box per iteration (12
    subtract / multiply, 10 min / max, 7 compares and selects of the miss
    test and the clamp, the running min and the flag compare)."""
    return blocks * rows * LANES * sp * n_iter * 31


def sweep(reps: int = REPS):
    """The TPU script's sweep on the card: a list of dicts, one per (sp,
    rows), with the launch ms at each n_iter, the latency of one iteration
    (`iter_us`: the 64 blocks at once) and the card's time per block
    iteration (`card_us_per_query`: iter_us / 64; the TPU script's
    figure)."""
    need_cuda()
    x_np, sups = inputs()
    x = torch.from_numpy(x_np).cuda()
    out = []
    for sp in SWEEP_SP:
        sup = torch.from_numpy(sups[sp]).cuda()
        for rows in SWEEP_ROWS:
            ms = {n: best_ms(lambda n=n: supscan(sup, x, n, rows), reps) for n in SWEEP_ITERS}
            lo, hi = SWEEP_ITERS
            iter_us = (ms[hi] - ms[lo]) / (hi - lo) * 1e3
            out.append(dict(sp=sp, rows=rows, ms=ms, iter_us=iter_us,
                            card_us_per_query=iter_us / BLOCKS))
    return out


def main():
    name = card()
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    for r in sweep():
        print(f"sup scan Sp={r['sp']:4d} rows={r['rows']:3d}: {r['iter_us']:8.4f} us per iteration"
              f" ({BLOCKS} blocks at once on {BLOCKS} of {sms} SMs), card "
              f"{r['card_us_per_query']:8.4f} us per block query  ({name})", flush=True)


if __name__ == "__main__":
    main()
