"""X1: how much does the supercluster-tier slab pass cost per query?

Port of benchmarks/experiments/microbench_supscan.py to the card: 64 blocks
of `rows` x 128 rays (from x, as :23-28), `n_iter` iterations of every
ray's slab entries into `sp` supercluster boxes (the port's slab test, the
bounds in the port's [sp, 8] layout), each reducing a block-wide flag
(any entry < 1e30) into `acc`; output o [8 * 64, 128] = the block's first
8 rows of x + acc. The kernel is csrc/exp_supscan.cu: each block a
thread-block cluster of two CTAs, each CTA half of the block's rays, one
ray a thread (`ray_map`), the flag ORed across the two through distributed
shared memory; `supscan_reference` is the plain version and `supscan_model` the
plain model of the kernel's map and flag. `main()` runs the script's sweep
(sp in {32, 128}, rows in {8, 16}, n_iter in {32, 128}) and prints, from
the difference between the two iteration counts as the TPU script did, two
figures: the latency of one iteration (all 64 blocks at once, on 128 of the
card's SMs) and the card's time per block iteration (that over 64). The
TPU ran the blocks one after another on one core, where the two were the
same figure.

The timed inputs are the script's, whose boxes all hold the ray origins,
so every block's flag is 1 whatever the slab tests give. The check inputs
(`check_inputs`) make the output depend on them: seeded boxes apart from
the origins, some invalid, rays that reach boxes in even blocks and leave
them all behind in odd ones, and the per-ray least entry (`entries=True`)
compared too; with `half_cta=True`, only rays of one of a block's two CTAs
reach a box, so a flag not ORed across the cluster changes the output.

    python -m cpupathtrace_tpu_torch.experiments.supscan [--parent ROOT] [--out DIR]

prints the sweep of the kernel as built (one ray a thread, `L1`) and of
copies of it with 2, 4 and 8 lanes a ray (`L2`, `L4`, `L8`: kRayLanes
rewritten in a copy of csrc/ in _build/sweep/, each held to the plain
version on every check input first) and, with --parent (a checkout of the
parent commit), its exp_supscan.cu, each through the same C interface, the
parent timed first and last.
"""
from __future__ import annotations

import argparse
import ctypes
import json
import os
from pathlib import Path

import numpy as np
import torch

from .. import _build
from ..accel.kernel_traverse import BND_COLS, _inv_dir, check_tensor, pair_slab_entries
from . import best_ms, card, need_cuda

BLOCKS = 64
CTAS = 2  # CTAs a block (csrc/exp_supscan.cu kCtas): a thread-block cluster
SWEEP_RAY_LANES = (2, 4, 8)  # the sweep's copies of the kernel (kRayLanes)
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


def check_inputs(sp: int, half_cta: bool = False):
    """(x [16 * 64, 128], bounds [sp, 8]) from np.random.default_rng(1) for
    the check: boxes of side 0.1-1.5 with lower corners in [0.3, 3]^3,
    every eighth one invalid. A ray is o = x (0.1, 0.2, 0.3), d = x + (1,
    2, 3): those of even blocks (x ~ N(0, 1)) start near the origin and
    head into the boxes' octant, those of odd blocks (x - 20) start below
    (-1.7, -3.4, -5.1) and move away from every box. With `half_cta`, every
    ray moves away but those of rows 4-7 of blocks 1 mod 4 and rows 12-15
    of blocks 3 mod 4: at rows 16 only CTA 0 (rows 0-7) or only CTA 1
    (rows 8-15) of a block has a ray that reaches a box, at rows 8 only
    CTA 1 (rows 4-7) of blocks 1 mod 4, and the other blocks none."""
    rng = np.random.default_rng(1)
    x = rng.normal(size=(BLOCKS, X_ROWS, LANES)).astype(np.float32)
    if half_cta:
        near = np.zeros((BLOCKS, X_ROWS), bool)
        near[1::4, 4:8] = True
        near[3::4, 12:16] = True
        x[~near] -= 20.0
    else:
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


def cta_threads(rows: int) -> int:
    """Threads of one CTA at `rows`: one for each of its rows * 64 rays."""
    return rows * LANES // CTAS


def ray_map(rows: int):
    """The kernel's map of a block's rows * 128 rays: (cta, thread) int64
    arrays [rows * 128]; ray r H + q is thread q of CTA r (H = rows * 64)."""
    ray = np.arange(rows * LANES)
    return np.divmod(ray, cta_threads(rows))


def supscan_model(sup, x, n_iter: int, rows: int, cluster_or: bool = True,
                  entries: bool = False):
    """The plain model of the kernel: each block's rays split between its
    two CTAs by `ray_map`, a flag per CTA (any of its rays' entries <
    1e30), ORed across the two CTAs (`cluster_or`; without it each CTA
    counts its own flag) into each CTA's acc; each CTA writes its half of
    the output rows with its acc. Returns what `supscan_reference`
    returns."""
    blocks = x.shape[0] // X_ROWS
    cta = torch.from_numpy(ray_map(rows)[0]).to(x.device)
    xb = x.reshape(blocks, X_ROWS, LANES)[:, :rows].reshape(blocks, -1)  # [B, rows * 128]
    ox, oy, oz = xb * 0.1, xb * 0.2, xb * 0.3
    ix, iy, iz = _inv_dir(xb + 1.0), _inv_dir(xb + 2.0), _inv_dir(xb + 3.0)
    acc = torch.zeros((blocks, CTAS), dtype=torch.float32, device=x.device)
    least = None
    for _ in range(n_iter):
        ox_it = ox + acc.gather(1, cta[None].expand(blocks, -1)) * 1e-9
        ent = pair_slab_entries(sup, ox_it.reshape(-1), oy.reshape(-1), oz.reshape(-1),
                                ix.reshape(-1), iy.reshape(-1), iz.reshape(-1))
        least = ent.amin(0)
        reach = (least < 1e30).reshape(blocks, CTAS, -1).any(2)  # rays of CTA r are a run
        flag = reach.any(1, keepdim=True).expand(-1, CTAS) if cluster_or else reach
        acc = acc + flag.to(torch.float32)
    half = OUT_ROWS * LANES // CTAS
    xo = x.reshape(blocks, X_ROWS * LANES)[:, :OUT_ROWS * LANES].reshape(blocks, CTAS, half)
    out = (xo + acc[:, :, None]).reshape(blocks * OUT_ROWS, LANES)
    return (out, least) if entries else out


def _bind(lib):
    """ptx_supscan_launch and ptx_supscan_layout of `lib` (either None where
    the library has no such entry point), their argtypes set."""
    p, i = ctypes.c_void_p, ctypes.c_int
    launch = lib.ptx_supscan_launch
    if launch.argtypes is None:
        # sup sp x o ent blocks rows n_iter stream
        launch.argtypes = [p, i, p, p, p, i, i, i, p]
        launch.restype = ctypes.c_int
    try:
        layout_fn = lib.ptx_supscan_layout
    except AttributeError:  # a parent before the cluster launch
        return launch, None
    if layout_fn.argtypes is None:
        layout_fn.argtypes = [i, i, i] + [ctypes.POINTER(i)] * 3
        layout_fn.restype = ctypes.c_int
    return launch, layout_fn


def layout(rows: int, sp: int, blocks: int = BLOCKS, lib=None):
    """The kernel's launch at (rows, sp): dict(ctas a cluster, threads a
    CTA, clusters resident at once by cudaOccupancyMaxActiveClusters) on
    the current card; `lib` (a library of exp_supscan.cu) defaults to the
    build's."""
    fn = _bind(_build.load("exp_supscan") if lib is None else lib)[1]
    out = [ctypes.c_int(0) for _ in range(3)]
    err = fn(rows, sp, blocks, *(ctypes.byref(v) for v in out))
    if err:
        raise RuntimeError(f"supscan layout query failed: cudaError_t {err}")
    return dict(ctas=out[0].value, threads=out[1].value, resident_clusters=out[2].value)


def _launch(lib, sup, x, n_iter, rows, entries):
    """One launch of `lib`'s kernel on the current stream: (o, ent or None)."""
    dev = x.device
    blocks = x.shape[0] // X_ROWS
    o = torch.empty((blocks * OUT_ROWS, LANES), dtype=torch.float32, device=dev)
    ent = (torch.empty(blocks * rows * LANES, dtype=torch.float32, device=dev)
           if entries else None)
    with torch.cuda.device(dev):
        err = _bind(lib)[0](sup.data_ptr(), sup.shape[0], x.data_ptr(), o.data_ptr(),
                            None if ent is None else ent.data_ptr(), blocks, rows, int(n_iter),
                            torch.cuda.current_stream(dev).cuda_stream)
    if err:
        raise RuntimeError(f"supscan launch failed: cudaError_t {err}")
    return o, ent


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
    if x.shape[0] % X_ROWS:
        raise ValueError(f"supscan: x has {x.shape[0]} rows, not a multiple of {X_ROWS}")
    o, ent = _launch(_build.load("exp_supscan"), sup, x, n_iter, rows, entries)
    supscan.launches += 1
    return (o, ent) if entries else o


supscan.launches = 0


def slab_ops(sp: int, rows: int, n_iter: int, blocks: int = BLOCKS) -> int:
    """Float operations of a call: 31 per ray and box per iteration (12
    subtract / multiply, 10 min / max, 7 compares and selects of the miss
    test and the clamp, the running min and the flag compare)."""
    return blocks * rows * LANES * sp * n_iter * 31


def sweep(reps: int = REPS, run=None):
    """The TPU script's sweep on the card: a list of dicts, one per (sp,
    rows), with the launch ms at each n_iter, the latency of one iteration
    (`iter_us`: the 64 blocks at once) and the card's time per block
    iteration (`card_us_per_query`: iter_us / 64; the TPU script's
    figure). `run(sup, x, n_iter, rows)` is the launch timed (`supscan`
    when None)."""
    need_cuda()
    run = supscan if run is None else run
    x_np, sups = inputs()
    x = torch.from_numpy(x_np).cuda()
    out = []
    for sp in SWEEP_SP:
        sup = torch.from_numpy(sups[sp]).cuda()
        for rows in SWEEP_ROWS:
            ms = {n: best_ms(lambda n=n: run(sup, x, n, rows), reps) for n in SWEEP_ITERS}
            lo, hi = SWEEP_ITERS
            iter_us = (ms[hi] - ms[lo]) / (hi - lo) * 1e3
            out.append(dict(sp=sp, rows=rows, ms=ms, iter_us=iter_us,
                            card_us_per_query=iter_us / BLOCKS))
    return out


class LibX1:
    """X1 from another library of exp_supscan.cu (a sweep's copy, or a parent
    commit's) through the same C interface."""

    def __init__(self, path):
        self.lib = ctypes.CDLL(str(path))

    def __call__(self, sup, x, n_iter, rows, entries=False):
        o, ent = _launch(self.lib, sup, x, n_iter, rows, entries)
        return (o, ent) if entries else o


def check_all(run, n_iter: int = 3):
    """`run` (sup, x, n_iter, rows, entries=True) against the plain version
    on every check input (both kinds, every sp and rows): o and the entries
    equal; raises where they differ. Returns the blocks counting per
    input."""
    counting = {}
    for half_cta in (False, True):
        for sp in SWEEP_SP:
            xc, bc = (torch.from_numpy(a).cuda() for a in check_inputs(sp, half_cta))
            for rows in SWEEP_ROWS:
                ko, ke = run(bc, xc, n_iter, rows, entries=True)
                po, pe = supscan_reference(bc, xc, n_iter, rows, entries=True)
                name = f"{'half_cta ' if half_cta else ''}sp{sp} rows{rows}"
                if not (torch.equal(ko, po) and torch.equal(ke, pe)):
                    raise RuntimeError(f"X1 differs from the plain version on {name}")
                acc = (ko.reshape(BLOCKS, OUT_ROWS, LANES)
                       - xc.reshape(BLOCKS, X_ROWS, LANES)[:, :OUT_ROWS])[:, 0, 0]
                counting[name] = int((acc > 0.5).sum())
    return counting


def main():
    ap = argparse.ArgumentParser(description="X1's sweep, also at 2, 4 and 8 lanes a ray")
    ap.add_argument("--parent", help="a checkout of the parent commit: its X1 beside")
    ap.add_argument("--out", help="also write the figures there (supscan_sweep.json)")
    args = ap.parse_args()
    need_cuda()
    from .dense_sweep import compile_all
    from .query_sweep import variant_csrc

    name = card()
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    sweep_dir = _build.BUILD_DIR / "sweep"
    sweep_dir.mkdir(parents=True, exist_ok=True)
    jobs, paths = [], {}
    for lanes in SWEEP_RAY_LANES:
        tree = variant_csrc(sweep_dir / f"x1_L{lanes}", "exp_supscan.cu", dict(kRayLanes=lanes))
        paths[f"L{lanes}"] = sweep_dir / f"libexp_supscan_L{lanes}.so"
        jobs.append((tree / "exp_supscan.cu", paths[f"L{lanes}"], list(_build.NVCC_FLAGS)))
    if args.parent:
        src = Path(args.parent).resolve() / "cpupathtrace_tpu_torch" / "csrc" / "exp_supscan.cu"
        paths["parent"] = sweep_dir / "libexp_supscan_parent.so"
        jobs.append((src, paths["parent"], list(_build.NVCC_FLAGS)))
    reports = compile_all(jobs)
    runs = {"L1": lambda sup, x, it, rows, entries=False: supscan(sup, x, it, rows, entries),
            **{k: LibX1(path) for k, path in paths.items()}}
    order = [k for k in runs if k != "parent"]
    order += order[::-1]
    if args.parent:
        order = ["parent"] + order + ["parent"]
    ptxas = {"L1": _build.ptxas_summary(_build.ptxas_report.get("exp_supscan", "")),
             **{k: _build.ptxas_summary(reports[path]) for k, path in paths.items()}}
    figures = {k: dict(config=k, card=name, ptxas=ptxas[k], check=check_all(run), sweeps=[])
               for k, run in runs.items()}
    for k, run in runs.items():
        if k != "parent":
            lib = None if k == "L1" else run.lib
            figures[k]["layout"] = {f"rows{rows} sp{sp}": layout(rows, sp, lib=lib)
                                    for rows in SWEEP_ROWS for sp in SWEEP_SP}
    for k in order:  # in turns: forward, then backward
        figures[k]["sweeps"].append(sweep(run=runs[k]))
    for k, fig in figures.items():
        for turn in fig["sweeps"]:
            for r in turn:
                print(f"{k:7s} sup scan Sp={r['sp']:4d} rows={r['rows']:3d}: "
                      f"{r['iter_us']:8.4f} us per iteration ({BLOCKS} blocks at once, "
                      f"{sms} SMs), card {r['card_us_per_query']:8.4f} us per block query, "
                      f"n_iter {SWEEP_ITERS[-1]} {r['ms'][SWEEP_ITERS[-1]]:.4f} ms  ({name})",
                      flush=True)
    print(json.dumps(dict(card=name, configs=list(figures.values())), default=float), flush=True)
    if args.out:
        os.makedirs(args.out, exist_ok=True)
        with open(os.path.join(args.out, "supscan_sweep.json"), "w") as f:
            json.dump(dict(card=name, configs=list(figures.values())), f, indent=1, default=float)


if __name__ == "__main__":
    main()
