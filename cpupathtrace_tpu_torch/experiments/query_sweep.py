"""K4's ring depth and block size, and K7's pairs a thread, swept on the card.

    python -m cpupathtrace_tpu_torch.experiments.query_sweep [--parent ROOT] [--out DIR]

K4 (csrc/cluster_query.cu): every `kQueryDepth` 2-6 with every
`kQueryThreads` 64 / 128 / 256; K7 (csrc/binned_isect.cu): `kPairs` 1 / 2
/ 4, `kMinBlocks` (the register cap of `__launch_bounds__`) 1 / 8 / 10 / 12
and `kTile` 64 / 128 / 256 rows (K7_CONFIGS). Each configuration is built
from a copy of csrc/ with its constants
rewritten, into _build/sweep/ (git-ignored), and driven through the port's
own wrappers on the 200k renderSceneDragonBox scene: K4 on 65,536 random
rays in the box (chip_smoke.py phase 7's) and on the dragon frame's
262,144 camera rays (128x128 @ 16 spp), nearest and any-hit; K7 on the
largest pairs of one wavefront frame of the dragon (phase 16's shape).
Every configuration is held bit-equal to the plain versions first, then
timed in turns (forward, then backward) by `best_ms`, the card's work
alone. Each line gives the ptxas registers and spills and the resident
blocks per SM beside the card's name and power limit.

With --parent ROOT (a checkout of the parent commit), its cluster_query.cu
and binned_isect.cu are built beside them and driven through their own C
interfaces, checked the same way and timed first and last.
"""
from __future__ import annotations

import argparse
import ctypes
import json
import os
import time
from pathlib import Path

import numpy as np
import torch

from .. import _build
from . import best_ms, card, need_cuda
from .dense_sweep import box_frame_rays, compile_all, tag

SWEEP_DIR = _build.BUILD_DIR / "sweep"
K4_DEPTHS = (2, 3, 4, 5, 6)
K4_THREADS = (64, 128, 256)
# K7: (pairs a thread, __launch_bounds__'s blocks a SM, rows a tile).
K7_CONFIGS = ((1, 1, 128), (2, 1, 128), (4, 1, 128), (1, 8, 128), (1, 10, 128), (1, 12, 128),
              (1, 1, 64), (1, 1, 256))
QUERY_RAYS = 65536
DRAGON_TRIS = 200000
FRAME = 128
FRAME_SPP = 16
MAX_DEPTH = 40
PARENT_PAIRS = 128  # the parent K7's pairs a block, one a thread
REPS = 5


def variant_csrc(dst: Path, source: str, values: dict) -> Path:
    """A copy of csrc/ at `dst` with `constexpr int NAME = N;` rewritten in
    csrc/<source> for each NAME: N of `values`."""
    import re
    import shutil

    shutil.rmtree(dst, ignore_errors=True)
    shutil.copytree(_build.CSRC, dst)
    path = dst / source
    text = path.read_text()
    for const, value in values.items():
        text, n = re.subn(rf"constexpr int {const} = \d+;", f"constexpr int {const} = {value};",
                          text)
        if n != 1:
            raise RuntimeError(f"{path}: {n} definitions of {const}, expected 1")
    path.write_text(text)
    return dst


def query_rays(n=QUERY_RAYS):
    """chip_smoke.py phase 7's rays: origins uniform in the box, uniform
    directions, shadow limits, from its seed."""
    rng = np.random.default_rng(1)
    o = rng.uniform(-0.95, 0.95, (n, 3))
    d = rng.normal(size=(n, 3))
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    lim = rng.uniform(0.05, 1.5, n)
    return tuple(torch.tensor(a, dtype=torch.float32, device="cuda") for a in (o, d, lim))


def frame_pairs(pt, tt, scene, camera):
    """The largest K7 input of one wavefront frame of `scene`."""
    opts = pt.RenderOptions(FRAME, FRAME, FRAME_SPP, FRAME_SPP, epsilon=1e-3,
                            max_depth=MAX_DEPTH)
    k7, seen = tt.isect, {}

    def isect(blocks, rays, offs):
        if rays.shape[1] > seen.get("n", 0):
            seen.update(n=rays.shape[1], rays=rays.clone(), offs=offs.clone())
        return k7(blocks, rays, offs)

    isect.launches = 0
    tt.isect = isect
    os.environ["PTX_NO_MEGAKERNEL"] = "1"
    try:
        pt.render(scene, camera, opts, seed=11, device="cuda")
        torch.cuda.synchronize()
    finally:
        tt.isect = k7
        del os.environ["PTX_NO_MEGAKERNEL"]
    return seen["rays"], seen["offs"]


def bits_equal(a, b):
    return bool(torch.equal(a.contiguous().view(torch.int32), b.contiguous().view(torch.int32)))


class ParentK4:
    """The parent's K4 through its C interface (one thread per ray, no
    refill, no ring)."""

    def __init__(self, path, kt):
        self.kt = kt
        self.fn = ctypes.CDLL(str(path)).ptx_cluster_query_launch
        p, i = ctypes.c_void_p, ctypes.c_int
        self.fn.argtypes = [p, p, p, p, p, i, p, i, i, p, p, i, p, i, p, i, i, p, p]
        self.fn.restype = ctypes.c_int

    def __call__(self, scene, o, d, lim, any_hit):
        kt = self.kt
        n = o.shape[0]
        lim = torch.full((n,), float("inf"), device="cuda") if lim is None else lim
        t = torch.empty(n, device="cuda")
        p = torch.empty(n, dtype=torch.int32, device="cuda")
        rec, clb, sup, hyp, root = kt.kernel_tables(scene)
        err = self.fn(o.data_ptr(), d.data_ptr(), lim.data_ptr(), t.data_ptr(), p.data_ptr(), n,
                      rec.data_ptr(), rec.shape[0], rec.shape[1], clb.data_ptr(), sup.data_ptr(),
                      sup.shape[0], hyp.data_ptr(), hyp.shape[0], root.data_ptr(),
                      int(scene.krn_cull_mode), int(any_hit), None,
                      torch.cuda.current_stream().cuda_stream)
        if err:
            raise RuntimeError(f"parent K4: cudaError_t {err}")
        return t, p.long()


class ParentK7:
    """The parent's K7 through its C interface (128-pair items, every row)."""

    def __init__(self, path):
        self.fn = ctypes.CDLL(str(path)).ptx_binned_isect_launch
        p, i = ctypes.c_void_p, ctypes.c_int
        self.fn.argtypes = [p, i, i, p, i, p, p, i, p, p, p]
        self.fn.restype = ctypes.c_int

    def __call__(self, blocks, rays, offs):
        n_pairs, c = rays.shape[1], blocks.shape[0]
        t = torch.full((n_pairs,), float("inf"), device="cuda")
        prim = torch.full((n_pairs,), -1, dtype=torch.int32, device="cuda")
        n_chunks = (offs[1:] - offs[:-1] + PARENT_PAIRS - 1) // PARENT_PAIRS
        start = torch.zeros(c + 1, dtype=torch.int32, device="cuda")
        start[1:] = torch.cumsum(n_chunks, 0)
        err = self.fn(blocks.data_ptr(), c, blocks.shape[1], rays.data_ptr(), n_pairs,
                      offs.data_ptr(), start.data_ptr(), -(-n_pairs // PARENT_PAIRS) + c,
                      t.data_ptr(), prim.data_ptr(), torch.cuda.current_stream().cuda_stream)
        if err:
            raise RuntimeError(f"parent K7: cudaError_t {err}")
        return t, prim


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--parent", help="a checkout of the parent commit: its K4 and K7 beside")
    ap.add_argument("--out", help="also write the figures there (query_sweep.json)")
    args = ap.parse_args()
    need_cuda()
    import cpupathtrace_tpu_torch as pt
    from ..accel import kernel_traverse as kt
    from ..accel import traverse as tt
    from ..models import scenes

    SWEEP_DIR.mkdir(parents=True, exist_ok=True)
    k4 = {f"D{dd} T{th}": dict(kQueryDepth=dd, kQueryThreads=th)
          for th in K4_THREADS for dd in K4_DEPTHS}
    k7 = {f"P{pp} B{bb} R{rr}": dict(kPairs=pp, kMinBlocks=bb, kTile=rr)
          for pp, bb, rr in K7_CONFIGS}
    jobs, libs = [], {}
    for kernel, source, configs in (("k4", "cluster_query", k4), ("k7", "binned_isect", k7)):
        for name, values in configs.items():
            tree = variant_csrc(SWEEP_DIR / f"{kernel}_{tag(name)}", f"{source}.cu", values)
            libs[(kernel, name)] = SWEEP_DIR / f"lib{source}_{tag(name)}.so"
            jobs.append((tree / f"{source}.cu", libs[(kernel, name)], list(_build.NVCC_FLAGS)))
    if args.parent:
        tree = Path(args.parent).resolve() / "cpupathtrace_tpu_torch" / "csrc"
        for kernel, source in (("k4", "cluster_query"), ("k7", "binned_isect")):
            libs[(kernel, "parent")] = SWEEP_DIR / f"lib{source}_parent.so"
            jobs.append((tree / f"{source}.cu", libs[(kernel, "parent")],
                         list(_build.NVCC_FLAGS)))
    reports = compile_all(jobs)

    smi = card()
    scene = scenes.bench_dragon_scene(dragon_tris=DRAGON_TRIS, device="cuda")
    camera = scenes.bench_camera()
    o, d, lim = query_rays()
    opts = pt.RenderOptions(FRAME, FRAME, FRAME_SPP, FRAME_SPP, epsilon=1e-3, max_depth=MAX_DEPTH)
    frame = box_frame_rays(scenes, opts, FRAME_SPP, 3)
    fo, fd = frame.origin.contiguous(), frame.direction.contiguous()
    # Shadow limits from the nearest hit (chip_smoke.py frame_limits): half
    # to one and a half times it, uniform in [0.05, 6] on a miss.
    t_near = kt.cluster_intersect_reference(scene, fo, fd)[0]
    u = torch.tensor(np.random.default_rng(2).uniform(0.5, 1.5, fo.shape[0]),
                     dtype=torch.float32, device="cuda")
    flim = torch.where(t_near > 0, t_near * u, 0.05 + 5.95 * (u - 0.5))
    cases = {f"{shape} {kind}": (qo, qd, ql if kind == "any_hit" else None, kind == "any_hit")
             for shape, (qo, qd, ql) in (("phase7", (o, d, lim)), ("frame", (fo, fd, flim)))
             for kind in ("nearest", "any_hit")}
    plain = {name: kt.cluster_intersect_reference(scene, *c[:3], any_hit=c[3])
             for name, c in cases.items()}
    pairs, offs = frame_pairs(pt, tt, scene, camera)
    plain7 = tt.isect_reference(scene.trv_blocks, pairs, offs)
    torch.cuda.synchronize()
    item_pairs = tt.ITEM_PAIRS

    def use_k4(name):
        if name == "parent":
            return ParentK4(libs[("k4", name)], kt)
        _build._LIBS["cluster_query"] = ctypes.CDLL(str(libs[("k4", name)]))
        kt._LAYOUTS.pop("cluster_query", None)
        return lambda scene, qo, qd, ql, any_hit: kt.cluster_intersect(scene, qo, qd, ql,
                                                                       any_hit=any_hit)

    def use_k7(name):
        if name == "parent":
            return ParentK7(libs[("k7", name)])
        _build._LIBS["binned_isect"] = ctypes.CDLL(str(libs[("k7", name)]))
        tt.ITEM_PAIRS = 128 * k7[name]["kPairs"]
        return tt.isect

    figures = {}
    for (kernel, name), path in libs.items():
        inst = _build.ptxas_instances(reports[path])
        fig = dict(kernel=kernel, config=name, card=smi, ms={},
                   ptxas={k: v for k, v in inst.items() if "kernel" in k})
        if kernel == "k4":
            run = use_k4(name)
            for case, c in cases.items():
                t, p = run(scene, *c)
                tp, pp = plain[case]
                if not (bits_equal(t, tp) and torch.equal(p, pp)):
                    raise RuntimeError(f"K4 {name} differs from the plain version on {case}")
            if name != "parent":
                layout = kt.walk_layout("cluster_query")
                smem = kt.query_smem_bytes(scene.krn_sup_bounds.shape[0])
                fig.update(depth=layout.depth, threads=layout.threads, smem_bytes=smem,
                           blocks_per_sm=kt.query_occupancy(smem)[0])
        else:
            run = use_k7(name)
            t, p = run(scene.trv_blocks, pairs, offs)
            if not (bits_equal(t, plain7[0]) and torch.equal(p, plain7[1])):
                raise RuntimeError(f"K7 {name} differs from the plain version")
            if name != "parent":
                fig.update(blocks_per_sm=tt.isect_occupancy()[0], item_pairs=tt.ITEM_PAIRS)
        figures[(kernel, name)] = fig

    def timed(fn):
        """best_ms of fn, and the host's milliseconds to enqueue it once
        (the card's work must outlast them for best_ms to time the card)."""
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn()
        host = (time.perf_counter() - t0) * 1e3
        torch.cuda.synchronize()
        try:
            best = best_ms(fn, REPS)
        except RuntimeError:  # the host never got ahead: no card-alone time
            best = None
        return dict(best_ms=best, host_ms=host)

    # In turns: the parent first and last, the configurations forward then
    # backward.
    for kernel, configs in (("k4", k4), ("k7", k7)):
        names = list(configs)
        order = (["parent"] if args.parent else []) + names + names[::-1] + (
            ["parent"] if args.parent else [])
        for name in order:
            fig = figures[(kernel, name)]
            if kernel == "k4":
                run = use_k4(name)
                for case, c in cases.items():
                    fig["ms"].setdefault(case, []).append(timed(lambda: run(scene, *c)))
            else:
                run = use_k7(name)
                fig["ms"].setdefault("frame pairs", []).append(
                    timed(lambda: run(scene.trv_blocks, pairs, offs)))
    tt.ITEM_PAIRS = item_pairs
    for fig in figures.values():
        print(json.dumps(fig, default=float), flush=True)
    summary = dict(card=smi, k4_rays={k: int(c[0].shape[0]) for k, c in cases.items()},
                   k7_pairs=int(offs[-1]), k7_clusters=int(offs.shape[0] - 1))
    print(json.dumps(summary), flush=True)
    if args.out:
        os.makedirs(args.out, exist_ok=True)
        with open(os.path.join(args.out, "query_sweep.json"), "w") as f:
            json.dump(dict(configs=[figures[k] for k in figures], **summary), f, indent=1,
                      default=float)


if __name__ == "__main__":
    main()
