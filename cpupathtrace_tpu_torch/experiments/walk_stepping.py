"""How K1's binned form and K2 step the cluster walk, swept on the card.

    python -m cpupathtrace_tpu_torch.experiments.walk_stepping [--parent ROOT] [--out DIR]
        [--cache DIR]

K1's binned form (csrc/megakernel.cu) and K2 (csrc/bounce.cu) step each
lane's walk alone (cluster_traverse.cuh `cluster_nearest`,
`cluster_anyhit`: `while (!w.done()) w.step(...)`). The sweep sets each
walk against stepping it converged: the lanes that reach the query
together (a `cooperative_groups::coalesced_threads()` group taken at the
walk's entry) take one test each a turn and meet again at a vote,
`while (lanes.any(!w.done())) if (!w.done()) w.step(...)`. Bit 0 of a
stepping value steps the nearest walk converged, bit 1 the shadow walks;
every value 0-3, the same in both kernels (0 is the shipped source). Each
value's libraries are built from a copy of csrc/ whose
cluster_traverse.cuh has those loops rewritten (`stepping_csrc`), into
_build/sweep/ (git-ignored), and driven
through the port's wrappers on the renderSceneDragonBox frame's 262,144
camera rays (128x128 @ 16 spp, max_depth 40) in the 200k dragon and in
the 7.2M dragon (`dragon_full_scene`, the scene cache under --cache): K1's
binned form by `best_ms` (the card's work alone), K2 as the sorted
driver's launches of one frame by CUDA events (their sum, the least of
REPS frames). Every configuration's spectra are held bit-equal to the
first one's (each walk takes the same tests in the same order whichever
way it is stepped); then all are timed in turns, forward and backward.
Each line gives the plain instances' ptxas registers and spills beside
the card's name and power limit.

With --parent ROOT (a checkout of the parent commit), its megakernel.cu
and bounce.cu are built beside them, driven through the same wrappers
(their C interfaces are this tree's), checked the same way and timed first
and last.
"""
from __future__ import annotations

import argparse
import ctypes
import json
import os
import shutil
from pathlib import Path

import torch

from .. import _build
from . import best_ms, card, need_cuda
from .dense_sweep import box_frame_rays, compile_all
from .query_sweep import bits_equal

SWEEP_DIR = _build.BUILD_DIR / "sweep"
STEPPINGS = (3, 1, 2, 0)
LIBS = ("megakernel", "bounce")
DRAGON_TRIS = 200000
FRAME = 128
FRAME_SPP = 16
MAX_DEPTH = 40
SEED = 21
REPS = 5


# The shipped stepping loops of cluster_nearest and cluster_anyhit, by the
# bound each walk starts from.
WALK_BOUNDS = ("h.t", "t_lim")
ALONE = """  w.start(T, r, {bound});
  while (!w.done()) w.step(T, rows, count);
"""
CONVERGED = """  const cooperative_groups::coalesced_group lanes = cooperative_groups::coalesced_threads();
  w.start(T, r, {bound});
  while (lanes.any(!w.done())) {{
    if (!w.done()) w.step(T, rows, count);
  }}
"""


def stepping_csrc(dst: Path, step: int) -> Path:
    """A copy of csrc/ at `dst` whose walks are stepped as `step` says: bit
    0 the nearest walk converged, bit 1 the shadow walks."""
    shutil.rmtree(dst, ignore_errors=True)
    shutil.copytree(_build.CSRC, dst)
    path = dst / "cluster_traverse.cuh"
    text = path.read_text()
    for bit, bound in enumerate(WALK_BOUNDS):
        loop = ALONE.format(bound=bound)
        if text.count(loop) != 1:
            raise RuntimeError(f"{path}: the stepping loop from {bound} is not found once")
        if step >> bit & 1:
            text = text.replace(loop, CONVERGED.format(bound=bound))
    head = "#include <float.h>\n"
    if text.count(head) != 1:
        raise RuntimeError(f"{path}: its includes are not found")
    path.write_text(text.replace(head, "#include <cooperative_groups.h>\n" + head))
    return dst


def plain_ptxas(report):
    """(registers, spill stores) of the plain binned instances (cull -1)."""
    inst = _build.ptxas_instances(report)
    return {k: (v.get("registers"), v.get("spill_stores", 0)) for k, v in inst.items()
            if k in ("megakernel_binned<-1, 0>", "bounce_binned_kernel<-1, 0, 0>")}


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--parent", help="a checkout of the parent commit: its K1 and K2 beside")
    ap.add_argument("--out", help="also write the figures there (walk_stepping.json)")
    ap.add_argument("--cache", default=str(_build.BUILD_DIR / "sweep" / "scene_cache"),
                    help="the 7.2M scene's cache directory")
    args = ap.parse_args()
    need_cuda()
    import cpupathtrace_tpu_torch as pt
    from ..integrator import megakernel as mk
    from ..integrator import sorted_wavefront as sw
    from ..models import scenes

    SWEEP_DIR.mkdir(parents=True, exist_ok=True)
    jobs, libs = [], {}
    for step in STEPPINGS:
        tree = stepping_csrc(SWEEP_DIR / f"stepping_{step}", step)
        for lib in LIBS:
            libs[(step, lib)] = SWEEP_DIR / f"lib{lib}_stepping_{step}.so"
            jobs.append((tree / f"{lib}.cu", libs[(step, lib)], list(_build.NVCC_FLAGS)))
    names = list(STEPPINGS)
    if args.parent:
        tree = Path(args.parent).resolve() / "cpupathtrace_tpu_torch" / "csrc"
        for lib in LIBS:
            libs[("parent", lib)] = SWEEP_DIR / f"lib{lib}_parent.so"
            jobs.append((tree / f"{lib}.cu", libs[("parent", lib)], list(_build.NVCC_FLAGS)))
        names = ["parent"] + names
    reports = compile_all(jobs)

    smi = card()
    opts = pt.RenderOptions(FRAME, FRAME, FRAME_SPP, FRAME_SPP, epsilon=1e-3, max_depth=MAX_DEPTH)
    rays = box_frame_rays(scenes, opts, FRAME_SPP, 3)
    dragon = scenes.bench_dragon_scene(dragon_tris=DRAGON_TRIS, device="cuda")
    full, _ = scenes.dragon_full_scene(args.cache, device="cuda")
    cells = {"dragon_200k": (dragon, mk.pack_tables(dragon)),
             "dragon_7p2m": (full, mk.pack_tables(full))}

    def use(name):
        for lib in LIBS:
            _build._LIBS[lib] = ctypes.CDLL(str(libs[(name, lib)]))

    # The seed on the card: a host number would be copied with a sync.
    seed = torch.tensor([SEED], dtype=torch.int32, device="cuda")

    def k1(scene, tables):
        return mk.trace_megakernel(scene, rays, opts, seed, tables)[0]

    def k2(scene, tables, timing=None):
        return sw.trace_megakernel_sorted(scene, rays, opts, SEED, tables, timing=timing)[0]

    figures = {name: dict(config=name, card=smi, ms={},
                          ptxas={lib: plain_ptxas(reports[libs[(name, lib)]]) for lib in LIBS})
               for name in names}
    first = {}
    for name in names:
        use(name)
        for cell, (scene, tables) in cells.items():
            for tracer, fn in (("k1", k1), ("k2", k2)):
                out = fn(scene, tables)
                torch.cuda.synchronize()
                ref = first.setdefault((cell, tracer), out)
                if not bits_equal(out, ref):
                    raise RuntimeError(f"{name}: {tracer} on {cell} differs from {names[0]}")
    # In turns: the parent first and last, the configurations forward then
    # backward.
    steps = list(STEPPINGS)
    order = (["parent"] if args.parent else []) + steps + steps[::-1] + (
        ["parent"] if args.parent else [])
    for name in order:
        use(name)
        ms = figures[name]["ms"]
        for cell, (scene, tables) in cells.items():
            ms.setdefault(f"{cell} k1", []).append(best_ms(lambda: k1(scene, tables), REPS))
            frames = []
            for _ in range(REPS):
                timing: dict = {}
                k2(scene, tables, timing)
                frames.append(sum(timing["bounce_ms"]))
            ms.setdefault(f"{cell} k2", []).append(min(frames))
    for fig in figures.values():
        print(json.dumps(fig, default=float), flush=True)
    summary = dict(card=smi, rays=int(rays.origin.shape[0]), steppings=list(STEPPINGS))
    print(json.dumps(summary), flush=True)
    if args.out:
        os.makedirs(args.out, exist_ok=True)
        with open(os.path.join(args.out, "walk_stepping.json"), "w") as f:
            json.dump(dict(configs=list(figures.values()), **summary), f, indent=1, default=float)


if __name__ == "__main__":
    main()
