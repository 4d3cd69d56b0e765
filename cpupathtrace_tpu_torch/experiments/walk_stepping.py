"""How K1's binned form and K2 test the rows of the records the cluster
walk visits, swept on the card.

    python -m cpupathtrace_tpu_torch.experiments.walk_stepping [--parent ROOT] [--out DIR]
        [--cache DIR]

K1's binned form (csrc/megakernel.cu) and K2 (csrc/bounce.cu) step each
lane's walk through its boxes and test a visited record's rows across the
warp (cluster_traverse.cuh `walk_together`: a lane whose cluster box
passes posts the cluster and waits; the warp serves the posted clusters in
rounds of one row a lane). The sweep sets the shipped walk against the
walk that tests each visited record's rows on the visiting lane alone
(the earlier walk, `while (!w.done()) w.step(...)`, K4's) and against other
moments to serve: a stepping value names when the warp serves
(kServeWaiting: 0 once no lane can take another box step, n > 0 also as
soon as n lanes wait; the shipped value is 1) and which walks serve
together where their caller asks for it (the nearest walk, the shadow
walks); the others step alone. Each value's libraries are built from a
copy of csrc/ whose cluster_traverse.cuh has the constant and the loops
rewritten (`stepping_csrc`), into _build/sweep/
(git-ignored), and driven through the port's wrappers on the
renderSceneDragonBox frame's 262,144 camera rays (128x128 @ 16 spp,
max_depth 40) in the 200k dragon and in the 7.2M dragon
(`dragon_full_scene`, the scene cache under --cache): K1's binned form by
`best_ms` (the card's work alone), K2 as the sorted driver's launches of
one frame by CUDA events (their sum, the least of REPS frames). Every
configuration's spectra are held bit-equal to the first one's (each walk
takes the same tests in the same order whichever way its rows are
tested); then all are timed in turns, forward and backward. Each line
gives the plain instances' ptxas registers and spills beside the card's
name and power limit, and the counting instances' lane use at a row and a
slab step and record visits per record stream on each frame.

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
import re
import shutil
from pathlib import Path

import torch

from .. import _build
from . import best_ms, card, need_cuda
from .dense_sweep import box_frame_rays, compile_all
from .query_sweep import bits_equal

SWEEP_DIR = _build.BUILD_DIR / "sweep"
# Stepping values: (kServeWaiting, nearest walk together, shadow walks
# together). SHIPPED is the source as it is; "alone" tests every record's
# rows on the visiting lane.
STEPPINGS = {
    "alone": (0, False, False),
    "all": (0, True, True),
    "first": (1, True, True),
    "w2": (2, True, True),
    "w4": (4, True, True),
    "w8": (8, True, True),
    "w16": (16, True, True),
    "near_only": (1, True, False),
}
SHIPPED = "first"
LIBS = ("megakernel", "bounce")
DRAGON_TRIS = 200000
FRAME = 128
FRAME_SPP = 16
MAX_DEPTH = 40
SEED = 21
REPS = 5


# The shipped walks of cluster_nearest (from h.t) and cluster_anyhit (from
# t_lim), together where their caller asks (BinnedGeo's kTogether), each
# beside the source that tests every record's rows on the visiting lane
# alone.
WALKS = {
    "h.t": ("""  w.start(T, r, h.t);
  if constexpr (kTogether)
""", """  w.start(T, r, h.t);
  if constexpr (false)
"""),
    "t_lim": ("""  w.start(T, r, t_lim);
  if constexpr (kTogether)
""", """  w.start(T, r, t_lim);
  if constexpr (false)
"""),
}
SERVE = re.compile(r"^constexpr int kServeWaiting = (\d+);$", re.M)


def stepping_csrc(dst: Path, step: str) -> Path:
    """A copy of csrc/ at `dst` whose walks are stepped as STEPPINGS[step]
    says: kServeWaiting rewritten, and the walks that do not serve
    together stepped alone."""
    serve, *together = STEPPINGS[step]
    shutil.rmtree(dst, ignore_errors=True)
    shutil.copytree(_build.CSRC, dst)
    path = dst / "cluster_traverse.cuh"
    text = path.read_text()
    for (bound, (shipped, alone)), keep in zip(WALKS.items(), together):
        if text.count(shipped) != 1:
            raise RuntimeError(f"{path}: the walk from {bound} is not found once")
        if not keep:
            text = text.replace(shipped, alone)
    if len(SERVE.findall(text)) != 1:
        raise RuntimeError(f"{path}: kServeWaiting is not found once")
    path.write_text(SERVE.sub(f"constexpr int kServeWaiting = {serve};", text))
    return dst


def walk_counts(vis, steps):
    """Lane use at a row and a slab step and record visits per stream from
    counters and warp steps, for any build (a walk that tests rows alone
    counts no stream)."""
    from ..accel import kernel_traverse as kt

    v = vis.reshape(-1, vis.shape[-1]).long().sum(0).tolist()
    st = steps.reshape(-1).long().tolist()
    rows = v[kt.NEAR_COLS[3]] + v[kt.SHADOW_COLS[3]]
    slabs = v[kt.NEAR_COLS[2]] + v[kt.SHADOW_COLS[2]]
    visits = v[kt.NEAR_COLS[1]] + v[kt.SHADOW_COLS[1]]
    lanes = kt.WARP_LANES
    return dict(slab_steps=st[0], row_steps=st[1], streams=st[2], slabs=slabs, rows=rows,
                record_visits=visits,
                row_lane_use=rows / (lanes * st[1]) if st[1] else None,
                slab_lane_use=slabs / (lanes * st[0]) if st[0] else None,
                visits_per_stream=visits / st[2] if st[2] else None)


def plain_ptxas(report):
    """(registers, spill stores) of the plain binned instances (K2's record
    form too), each cull class."""
    inst = _build.ptxas_instances(report)
    plain = {f"megakernel_binned<{c}, 0>" for c in (-1, 0, 1)} | {
        f"bounce_binned_kernel<{c}, {rec}, 0>" for c in (-1, 0, 1) for rec in (0, 1)}
    return {k: (v.get("registers"), v.get("spill_stores", 0)) for k, v in inst.items()
            if k in plain}


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--parent", help="a checkout of the parent commit: its K1 and K2 beside")
    ap.add_argument("--out", help="also write the figures there (walk_stepping.json)")
    ap.add_argument("--cache", default=str(_build.BUILD_DIR / "sweep" / "scene_cache"),
                    help="the 7.2M scene's cache directory")
    args = ap.parse_args()
    need_cuda()
    import cpupathtrace_tpu_torch as pt
    from ..accel import kernel_traverse as kt
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
    cells = {"dragon_200k": (dragon, mk.kernel_scene(dragon)),
             "dragon_7p2m": (full, mk.kernel_scene(full))}

    def use(name):
        for lib in LIBS:
            _build._LIBS[lib] = ctypes.CDLL(str(libs[(name, lib)]))

    # The seed on the card: a host number would be copied with a sync.
    seed = torch.tensor([SEED], dtype=torch.int32, device="cuda")

    def k1(scene, ks):
        return mk.trace_megakernel(scene, rays, opts, seed, ks)[0]

    def k2(scene, ks, timing=None):
        return sw.trace_megakernel_sorted(scene, rays, opts, SEED, ks, timing=timing)[0]

    def counted(scene, ks):
        """The counting instances' walk figures: K1's, then K2's frame."""
        out = {}
        for tracer in ("k1", "k2"):
            steps = torch.zeros(kt.WARP_STEP_COLS, dtype=torch.int64, device="cuda")
            if tracer == "k1":
                vis = mk.trace_megakernel(scene, rays, opts, seed, ks, debug_visits=True,
                                          warp_steps=steps)[2]
            else:
                vis = sw.trace_megakernel_sorted(scene, rays, opts, SEED, ks,
                                                 debug_visits=True, warp_steps=steps)[2]
            out[tracer] = walk_counts(vis.cpu(), steps.cpu())
        return out

    figures = {name: dict(config=name, stepping=STEPPINGS.get(name), card=smi, ms={},
                          counts={},
                          ptxas={lib: plain_ptxas(reports[libs[(name, lib)]]) for lib in LIBS})
               for name in names}
    first = {}
    for name in names:
        use(name)
        for cell, (scene, ks) in cells.items():
            for tracer, fn in (("k1", k1), ("k2", k2)):
                out = fn(scene, ks)
                torch.cuda.synchronize()
                ref = first.setdefault((cell, tracer), out)
                if not bits_equal(out, ref):
                    raise RuntimeError(f"{name}: {tracer} on {cell} differs from {names[0]}")
            figures[name]["counts"][cell] = counted(scene, ks)
    # In turns: the parent first and last, the configurations forward then
    # backward.
    steps = list(STEPPINGS)
    order = (["parent"] if args.parent else []) + steps + steps[::-1] + (
        ["parent"] if args.parent else [])
    for name in order:
        use(name)
        ms = figures[name]["ms"]
        for cell, (scene, ks) in cells.items():
            ms.setdefault(f"{cell} k1", []).append(best_ms(lambda: k1(scene, ks), REPS))
            frames = []
            for _ in range(REPS):
                timing: dict = {}
                k2(scene, ks, timing)
                frames.append(sum(timing["bounce_ms"]))
            ms.setdefault(f"{cell} k2", []).append(min(frames))
    for fig in figures.values():
        print(json.dumps(fig, default=float), flush=True)
    summary = dict(card=smi, rays=int(rays.origin.shape[0]), steppings=STEPPINGS)
    print(json.dumps(summary), flush=True)
    if args.out:
        os.makedirs(args.out, exist_ok=True)
        with open(os.path.join(args.out, "walk_stepping.json"), "w") as f:
            json.dump(dict(configs=list(figures.values()), **summary), f, indent=1, default=float)


if __name__ == "__main__":
    main()
