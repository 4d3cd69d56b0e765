"""K6's lanes a ray and block, and K5's block and stage limit, swept on the
card.

    python -m cpupathtrace_tpu_torch.experiments.intersect_sweep [--parent ROOT] [--out DIR]

K6 (csrc/binned_cand.cu): `kThreads` 128 / 256, each with the lanes a ray
the wrapper picks (`auto`: traverse.cand_grid) and with every fixed 1-32
lanes a ray of a launch (its C entry point's lanes_log2 argument, the grid
the resident blocks at those lanes; sparser windows still widen their
groups up to a warp); K5 (csrc/dense_query.cu): `kThreads` 128 / 256 and
`kMaxStage` 0 / 96 KB / 200 KB. Each block shape and stage limit is built
from a copy of csrc/ with its constants rewritten, into _build/sweep/
(git-ignored), and driven through the port's own wrappers.
K6 runs on the 200k renderSceneDragonBox scene (lean=False) on one
wavefront frame's largest round-1 input and its round-2 input with the
most pending rays (128x128 @ 16 spp, max_depth 40, chip_smoke.py phase
16's frame), and on that round-1 input against a synthetic table of 2,048
clusters in the dragon's box, each at m = 1 and 4. K5 runs on
chip_smoke.py phase 11's shape (262,144 rays in the box), on the largest
K5 input of the lean dragon's wavefront frame (its big-partition table),
and on 65,536 rays against a random table of 2,000 triangles (192 KB:
staged at the 200 KB limit, read through L1 at the others).
Every configuration is held bit-equal to the plain versions first, then
timed in turns (forward, then backward) by `best_ms`, the card's work
alone. Each line gives the ptxas registers and spills and the resident
blocks per SM beside the card's name and power limit.

With --parent ROOT (a checkout of the parent commit), its binned_cand.cu
and dense_query.cu are built beside them and driven through their own C
interfaces, checked the same way and timed first and last (K5 as its
launch alone and with its wrapper's int64 conversion).
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
from . import best_ms, card, need_cuda
from .dense_sweep import compile_all, tag
from .query_sweep import bits_equal, variant_csrc

SWEEP_DIR = _build.BUILD_DIR / "sweep"
K6_LANES = (None, 1, 2, 4, 8, 16, 32)  # None: the wrapper's choice
K6_THREADS = (128, 256)
K6_M = (1, 4)
K5_THREADS = (128, 256)
K5_STAGE = (0, 96 * 1024, 200 * 1024)
DRAGON_TRIS = 200000
FRAME = 128
FRAME_SPP = 16
MAX_DEPTH = 40
SYNTH_CLUSTERS = 2048
K5_BOX_RAYS = 262144
K5_BIG_ROWS = 2000
K5_BIG_RAYS = 65536
REPS = 5


def frame_inputs(pt, tt, oi, scene, camera, seed=11):
    """Every K6 input of one wavefront frame of `scene` (PTX_NO_MEGAKERNEL
    =1), as dicts (query, round, rays, m) in launch order (round 1 is the
    launch whose lower bounds are all -inf), the largest K7 input (pairs,
    offs) and the largest K5 input (o, d, tables, n_tri_rows)."""
    opts = pt.RenderOptions(FRAME, FRAME, FRAME_SPP, FRAME_SPP, epsilon=1e-3,
                            max_depth=MAX_DEPTH)
    k6, k7, k5 = tt.candidates, tt.isect, oi.dense_intersect
    seen = dict(k6=[], query=-1, rnd=0)

    def cand(bounds, rays, m):
        if bool((rays[7] == float("-inf")).all()):
            seen["query"] += 1
            seen["rnd"] = 0
        seen["rnd"] += 1
        seen["k6"].append(dict(query=seen["query"], round=seen["rnd"], rays=rays.clone(), m=m))
        return k6(bounds, rays, m)

    def isect(blocks, rays, offs):
        if rays.shape[1] > seen.get("k7", (torch.empty(0, 0),))[0].shape[1]:
            seen["k7"] = (rays.clone(), offs.clone())
        return k7(blocks, rays, offs)

    def dense(scene, o, d, tables=None, n_tri_rows=None):
        if o.shape[0] > seen.get("k5", (torch.empty(0),))[0].shape[0]:
            seen["k5"] = (o.clone(), d.clone(), tables, n_tri_rows)
        return k5(scene, o, d, tables, n_tri_rows)

    # The wrappers count their launches through their module's names,
    # which name these stand-ins while they are in place.
    cand.launches = isect.launches = dense.launches = 0
    tt.candidates, tt.isect, oi.dense_intersect = cand, isect, dense
    os.environ["PTX_NO_MEGAKERNEL"] = "1"
    try:
        pt.render(scene, camera, opts, seed=seed, device="cuda")
        torch.cuda.synchronize()
    finally:
        tt.candidates, tt.isect, oi.dense_intersect = k6, k7, k5
        del os.environ["PTX_NO_MEGAKERNEL"]
    return seen["k6"], seen.get("k7"), seen.get("k5")


def pending(rays):
    """The rays K6 scans: a finite or -inf lower bound (t_lo < inf)."""
    return int((rays[7] < float("inf")).sum())


def synthetic_bounds(scene, c=SYNTH_CLUSTERS, seed=4):
    """A bounds table of `c` boxes inside the scene's root box: corners
    uniform in it, sides 2-10% of its extent, every 20th box invalid."""
    rng = np.random.default_rng(seed)
    lo, hi = scene.root_lo.cpu().numpy(), scene.root_hi.cpu().numpy()
    ext = hi - lo
    a = lo + rng.random((c, 3)) * ext
    b = np.zeros((c, 8), np.float32)
    b[:, :3] = a
    b[:, 3:6] = a + ext * rng.uniform(0.02, 0.10, (c, 3))
    b[:, 6] = (np.arange(c) % 20 != 19)
    return torch.tensor(b, device=scene.root_lo.device)


def big_table(rows=K5_BIG_ROWS, rays=K5_BIG_RAYS, seed=6):
    """K5's tables past the stage limit: `rows` random triangles (a third
    culling, 5% invalid) and three spheres in [-1, 1]^3, and `rays` rays
    from points in the box: (o, d, (tri, sph))."""
    rng = np.random.default_rng(seed)
    tri = np.zeros((rows, 24), np.float32)
    tri[:, :3] = rng.uniform(-1, 1, (rows, 3))
    tri[:, 3:6] = rng.normal(0, 0.2, (rows, 3))
    tri[:, 6:9] = rng.normal(0, 0.2, (rows, 3))
    tri[:, 9] = rng.random(rows) < 1 / 3
    tri[:, 10] = rng.random(rows) < 0.95
    sph = np.zeros((3, 8), np.float32)
    sph[:, :3] = rng.uniform(-0.5, 0.5, (3, 3))
    sph[:, 3], sph[:, 4] = 0.2, 1.0
    o = rng.uniform(-0.95, 0.95, (rays, 3))
    d = rng.normal(size=(rays, 3))
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    f = lambda a: torch.tensor(a, dtype=torch.float32, device="cuda")  # noqa: E731
    return f(o), f(d), (f(tri), f(sph))


def box_rays(scenes, sw, n=K5_BOX_RAYS):
    """chip_smoke.py phase 11's rays: the box frame's 128x128 @ 8 spp
    camera rays, then random rays from points in the box."""
    import cpupathtrace_tpu_torch as pt

    from .dense_sweep import box_frame_rays

    rays = box_frame_rays(scenes, pt.RenderOptions(FRAME, FRAME, 8, 8), 8, 11)
    n_cam = rays.origin.shape[0]
    rng = np.random.default_rng(2)
    d2 = rng.normal(size=(n - n_cam, 3))
    d2 /= np.linalg.norm(d2, axis=1, keepdims=True)
    o = torch.cat([rays.origin, torch.tensor(rng.uniform(-0.95, 0.95, (n - n_cam, 3)),
                                             dtype=torch.float32, device="cuda")])
    d = torch.cat([rays.direction, torch.tensor(d2, dtype=torch.float32, device="cuda")])
    return o.contiguous(), d.contiguous()


class ParentK6:
    """The parent's K6 through its C interface (the same arguments)."""

    def __init__(self, path):
        self.fn = ctypes.CDLL(str(path)).ptx_binned_cand_launch
        p, i = ctypes.c_void_p, ctypes.c_int
        self.fn.argtypes = [p, i, p, i, i, p, p, p]
        self.fn.restype = ctypes.c_int

    def __call__(self, bounds, rays, m):
        n = rays.shape[1]
        ids = torch.empty((m + 1, n), dtype=torch.int32, device="cuda")
        ent = torch.empty((m + 1, n), device="cuda")
        err = self.fn(bounds.data_ptr(), bounds.shape[0], rays.data_ptr(), n, m,
                      ids.data_ptr(), ent.data_ptr(), torch.cuda.current_stream().cuda_stream)
        if err:
            raise RuntimeError(f"parent K6: cudaError_t {err}")
        return ids, ent


def fixed_lanes(tt, lanes):
    """K6 through its C entry point with `lanes` lanes a ray for the whole
    launch (a power of two up to 32) on the resident blocks at those lanes,
    as `candidates` launches it with the lanes of `cand_grid`."""
    from ..accel.kernel_traverse import resident_grid

    lg = lanes.bit_length() - 1
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    grids = {}

    def run(bounds, rays, m):
        n, c = rays.shape[1], bounds.shape[0]
        if (m, c, n) not in grids:
            per_sm, threads, _ = tt.cand_occupancy(m, c)
            grids[(m, c, n)] = resident_grid(n << lg, threads, per_sm, sms)
        ids = torch.empty((m + 1, n), dtype=torch.int32, device="cuda")
        ent = torch.empty((m + 1, n), device="cuda")
        err = tt._cand_fn()(bounds.data_ptr(), c, rays.data_ptr(), n, m, ids.data_ptr(),
                            ent.data_ptr(), grids[(m, c, n)], lg,
                            torch.cuda.current_stream().cuda_stream)
        if err:
            raise RuntimeError(f"K6 at {lanes} lanes a ray: cudaError_t {err}")
        return ids, ent

    return run


class ParentK5:
    """The parent's K5 through its C interface (int32 prim, one thread a
    ray); `widen` adds its wrapper's second kernel, prim.long()."""

    def __init__(self, path, widen):
        self.widen = widen
        self.fn = ctypes.CDLL(str(path)).ptx_dense_query_launch
        p, i = ctypes.c_void_p, ctypes.c_int
        self.fn.argtypes = [p, p, p, p, i, p, i, p, i, p]
        self.fn.restype = ctypes.c_int

    def __call__(self, o, d, tables, n_tri):
        r = o.shape[0]
        tri, sph = tables
        t = torch.empty(r, device="cuda")
        p = torch.empty(r, dtype=torch.int32, device="cuda")
        err = self.fn(o.data_ptr(), d.data_ptr(), t.data_ptr(), p.data_ptr(), r, tri.data_ptr(),
                      n_tri, sph.data_ptr(), sph.shape[0], torch.cuda.current_stream().cuda_stream)
        if err:
            raise RuntimeError(f"parent K5: cudaError_t {err}")
        return t, p.long() if self.widen else p


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--parent", help="a checkout of the parent commit: its K6 and K5 beside")
    ap.add_argument("--out", help="also write the figures there (intersect_sweep.json)")
    args = ap.parse_args()
    need_cuda()
    import cpupathtrace_tpu_torch as pt
    from ..accel import traverse as tt
    from ..integrator import sorted_wavefront as sw
    from ..models import scenes
    from ..ops import intersect as oi

    SWEEP_DIR.mkdir(parents=True, exist_ok=True)
    k6_builds = {f"T{th}": dict(kThreads=th) for th in K6_THREADS}
    k6 = {f"T{th} {f'G{g}' if g else 'auto'}": (f"T{th}", g)
          for th in K6_THREADS for g in K6_LANES}
    k5 = {f"T{th} S{ss // 1024}K": dict(kThreads=th, kMaxStage=ss)
          for ss in K5_STAGE for th in K5_THREADS}
    jobs, libs = [], {}
    for kernel, source, configs in (("k6", "binned_cand", k6_builds),
                                    ("k5", "dense_query", k5)):
        for name, values in configs.items():
            tree = variant_csrc(SWEEP_DIR / f"{kernel}_{tag(name)}", f"{source}.cu", values)
            libs[(kernel, name)] = SWEEP_DIR / f"lib{source}_{tag(name)}.so"
            jobs.append((tree / f"{source}.cu", libs[(kernel, name)], list(_build.NVCC_FLAGS)))
    if args.parent:
        tree = Path(args.parent).resolve() / "cpupathtrace_tpu_torch" / "csrc"
        for kernel, source in (("k6", "binned_cand"), ("k5", "dense_query")):
            libs[(kernel, "parent")] = SWEEP_DIR / f"lib{source}_parent.so"
            jobs.append((tree / f"{source}.cu", libs[(kernel, "parent")],
                         list(_build.NVCC_FLAGS)))
    reports = compile_all(jobs)

    smi = card()
    dragon = scenes.bench_dragon_scene(dragon_tris=DRAGON_TRIS, device="cuda")
    camera = scenes.bench_camera()
    k6_inputs, _, _ = frame_inputs(pt, tt, oi, dragon, camera)
    lean = scenes.bench_dragon_scene(dragon_tris=DRAGON_TRIS, lean=True, device="cuda")
    _, _, (lo, ld, ltables, lrows) = frame_inputs(pt, tt, oi, lean, camera)
    round1 = max((x for x in k6_inputs if x["round"] == 1), key=lambda x: x["rays"].shape[1])
    round2 = max((x for x in k6_inputs if x["round"] == 2), key=lambda x: pending(x["rays"]))
    bounds = dragon.trv_bounds
    synth = synthetic_bounds(dragon)
    k6_cases = {f"{shape} m{m}": (b, x["rays"], m)
                for shape, b, x in (("round1", bounds, round1), ("round2", bounds, round2),
                                    ("synthetic2048", synth, round1)) for m in K6_M}
    k6_plain = {name: tt.candidates_reference(*c) for name, c in k6_cases.items()}
    bo, bd = box_rays(scenes, sw)
    box = scenes.bench_box_scene()
    go, gd, gtables = big_table()
    k5_cases = {"box": (bo, bd, oi.dense_tables(box), box.n_tri),
                "lean frame": (lo, ld, ltables, lrows),
                f"table {K5_BIG_ROWS}": (go, gd, gtables, K5_BIG_ROWS)}
    k5_plain = {name: oi.dense_intersect_reference(box, o, d, tabs, n)
                for name, (o, d, tabs, n) in k5_cases.items()}
    torch.cuda.synchronize()

    def use_k6(name):
        if name == "parent":
            return ParentK6(libs[("k6", name)])
        build, lanes = k6[name]
        _build._LIBS["binned_cand"] = ctypes.CDLL(str(libs[("k6", build)]))
        return fixed_lanes(tt, lanes) if lanes else tt.candidates

    def use_k5(name, widen=False):
        if name == "parent":
            run = ParentK5(libs[("k5", name)], widen)
            return lambda o, d, tabs, n: run(o, d, tabs, n)
        _build._LIBS["dense_query"] = ctypes.CDLL(str(libs[("k5", name)]))
        return lambda o, d, tabs, n: oi.dense_intersect(box, o, d, tabs, n_tri_rows=n)

    figures = {}
    instances = [(kernel, name, libs[(kernel, k6[name][0] if kernel == "k6" else name)])
                 for kernel, names in (("k6", k6), ("k5", k5)) for name in names]
    if args.parent:
        instances += [(kernel, "parent", libs[(kernel, "parent")]) for kernel in ("k6", "k5")]
    for kernel, name, path in instances:
        inst = _build.ptxas_instances(reports[path])
        fig = dict(kernel=kernel, config=name, card=smi, ms={},
                   ptxas={k: v for k, v in inst.items() if "kernel" in k})
        if kernel == "k6":
            run = use_k6(name)
            for case, c in k6_cases.items():
                ik, ek = run(*c)
                ip, ep = k6_plain[case]
                if not (torch.equal(ik, ip) and bits_equal(ek, ep)):
                    raise RuntimeError(f"K6 {name} differs from the plain version on {case}")
            if name != "parent":
                fig["occupancy"] = {f"m{m} C{b.shape[0]}": tt.cand_occupancy(m, b.shape[0])
                                    for b in (bounds, synth) for m in K6_M}
        else:
            run = use_k5(name)
            for case, (o, d, tabs, n) in k5_cases.items():
                t, p = run(o, d, tabs, n)
                tp, pp = k5_plain[case]
                if not (bits_equal(t, tp) and torch.equal(p.long(), pp)):
                    raise RuntimeError(f"K5 {name} differs from the plain version on {case}")
            if name != "parent":
                fig["occupancy"] = {case: oi.dense_occupancy(n, tabs[1].shape[0])
                                    for case, (o, d, tabs, n) in k5_cases.items()}
        figures[(kernel, name)] = fig

    # In turns: the parent first and last, the configurations forward then
    # backward.
    for kernel, configs in (("k6", k6), ("k5", k5)):
        names = list(configs)
        order = (["parent"] if args.parent else []) + names + names[::-1] + (
            ["parent"] if args.parent else [])
        for name in order:
            fig = figures[(kernel, name)]
            if kernel == "k6":
                run = use_k6(name)
                for case, c in k6_cases.items():
                    fig["ms"].setdefault(case, []).append(best_ms(lambda: run(*c), REPS))
            else:
                runs = {"": use_k5(name)}
                if name == "parent":
                    runs[" with long()"] = use_k5(name, widen=True)
                for suffix, run in runs.items():
                    for case, c in k5_cases.items():
                        fig["ms"].setdefault(case + suffix, []).append(
                            best_ms(lambda: run(*c), REPS))
    for fig in figures.values():
        print(json.dumps(fig, default=float), flush=True)
    summary = dict(
        card=smi, k6_launches=[dict(query=x["query"], round=x["round"], rays=x["rays"].shape[1],
                                    pending=pending(x["rays"])) for x in k6_inputs],
        k6_clusters=int(bounds.shape[0]),
        k6_rays={k: [int(c[1].shape[1]), pending(c[1])] for k, c in k6_cases.items()},
        k5_rays={k: int(c[0].shape[0]) for k, c in k5_cases.items()},
        k5_rows={k: [int(c[3]), int(c[2][1].shape[0])] for k, c in k5_cases.items()})
    print(json.dumps(summary), flush=True)
    if args.out:
        os.makedirs(args.out, exist_ok=True)
        with open(os.path.join(args.out, "intersect_sweep.json"), "w") as f:
            json.dump(dict(configs=[figures[k] for k in figures], **summary), f, indent=1,
                      default=float)


if __name__ == "__main__":
    main()
