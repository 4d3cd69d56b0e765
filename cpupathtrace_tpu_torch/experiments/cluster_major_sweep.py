"""K8's row splits, block, row source and register cap, swept on the card.

    python -m cpupathtrace_tpu_torch.experiments.cluster_major_sweep [--parent ROOT] [--out DIR]

K8 (csrc/cluster_major.cu: the row source a template instance, S a launch
argument) at every S of 1 / 2 / 4 / 8 the block holds and the wrapper's own
(`auto`: cluster_major.stage_splits), with rows read through L1 (`L1`) or
staged by one bulk copy a work item (`bulk`), in blocks of 64, 128 (the
build's kThreads) and 256 threads, each with and without its registers
capped at 64 (`cap64`: kMinWarps 32): each (block, cap) but the build's is
a copy of csrc/ in _build/sweep/ with those constants rewritten. The input
is chip_smoke.py phase 17's: the stage's candidates for phase 7's 65,536
rays on the 200k renderSceneDragonBox scene built with lean=False, at M = 4
(the stage's shape), and at M = 1 and 8. Each configuration is timed as
`cluster_major.stage_run` on the binned pairs (the work list built from the
bin offsets, and the launch), the span of K7's wrapper `traverse.isect` on
its ray planes (its output fills, work list and launch), which is timed
beside it (`k7`), and with --parent ROOT (a checkout of the parent commit)
the parent's binned_isect.cu through its own C interface, over the same
span. `stage` is the whole stage (`test_candidates`: binning, work list,
launch), timed as whole calls. Every configuration is held bit-equal to
the plain version first, then timed in turns (forward, then backward; the
parent first and last) by `best_ms`, the card's work alone. Each line gives
S, the grid, the warps with work and the lane use, the ptxas registers and
spills and the resident blocks per SM beside the card's name and power
limit.
"""
from __future__ import annotations

import argparse
import ctypes
import json
import os
import warnings
from pathlib import Path

import torch

from .. import _build
from . import best_ms, card, need_cuda

SWEEP_DIR = _build.BUILD_DIR / "sweep"
THREADS = (64, 128, 256)  # kThreads of the builds
BUILD_THREADS = 128  # csrc/cluster_major.cu's own kThreads
SPLITS = (None, 1, 2, 4, 8)  # None: the wrapper's choice
STAGED = (False, True)
CAND_M = (4, 1, 8)
DRAGON_TRIS = 200000
REPS = 5


def host_syncs(fn):
    """The host reads fn() makes: the synchronising CUDA calls torch reports
    under torch.cuda.set_sync_debug_mode("warn")."""
    torch.cuda.synchronize()
    prev = torch.cuda.get_sync_debug_mode()
    torch.cuda.set_sync_debug_mode(1)
    try:
        with warnings.catch_warnings(record=True) as seen:
            warnings.simplefilter("always")
            fn()
    finally:
        torch.cuda.set_sync_debug_mode(prev)
    torch.cuda.synchronize()
    return sum("synchroniz" in str(w.message) for w in seen)


def whole_ms(fn, reps):
    """The mean milliseconds of `reps` whole calls of fn() by CUDA events,
    after one warm call (host time in: the wrapper's and any host read)."""
    fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / reps


def stage_figures(tt, blocks, ids, splits):
    """The launch's work on a query: binned pairs, 32-pair slots (a
    cluster's pairs fill ceil(n / 32)), warps with work (a slot's warps
    whose row range is not empty: min(S, groups) of them), lane use
    (pairs / (slots x 32)) and the longest range in 8-row groups."""
    c = blocks.shape[0]
    flat = ids.reshape(-1)
    counts = torch.bincount(flat[flat >= 0], minlength=c).long()
    groups = tt.last_filled_groups(blocks).long()
    slots = (counts + 31) // 32
    pairs = int(counts.sum())
    n_slots = int(slots.sum())
    return dict(pairs=pairs, slots=n_slots,
                warps_with_work=int((slots * groups.clamp_max(splits)).sum()),
                lane_use=pairs / (32 * n_slots) if n_slots else None,
                longest_range_groups=int(-(-groups[counts > 0].max() // splits))
                if pairs else 0)


def k7_inputs(cm, ids, o, d, n_clusters):
    """The binning and K7's ray planes [6, P] of the binned pairs, as the
    parent's stage gathered them: (order, offs, rays)."""
    r, m = ids.shape
    order, _, offs = cm.bin_offsets(ids, n_clusters)
    rays = torch.cat([o.t(), d.t()])[:, order // m].contiguous()
    return order, offs, rays


def planted_ties(device):
    """Blocks and a query with planted ties: (blocks [2, 32, 16], o, d [2,
    3], ids [2, 2], the prims the group rule gives). Cluster 0: the z = 1
    triangle at rows 9 and 17 (groups 1 and 2, prims 9 and 4: equal t on
    opposite sides of the range boundary at S = 2 and 4, the later group's
    prim smaller), farther ones at row 3 (z = 3) and row 26 (z = 2).
    Cluster 1: the same triangle at rows 10, 13 and 14 (prims 7, 5, 6):
    equal t inside group 1. Both rays start at the origin along +z."""
    from ..accel.traverse import BLK_COLS, C_PRIM

    blocks = torch.zeros((2, 32, BLK_COLS))
    blocks[..., C_PRIM] = -1.0
    tri = torch.tensor([-1.0, -1.0, 1.0, 2.0, 0.0, 0.0, 0.0, 2.0, 0.0])
    for c, row, prim, z in ((0, 3, 20.0, 3.0), (0, 9, 9.0, 1.0), (0, 17, 4.0, 1.0),
                            (0, 26, 1.0, 2.0), (1, 10, 7.0, 1.0), (1, 13, 5.0, 1.0),
                            (1, 14, 6.0, 1.0)):
        blocks[c, row, :9] = tri
        blocks[c, row, 2] = z
        blocks[c, row, C_PRIM] = prim
    o = torch.zeros((2, 3))
    d = torch.tensor([[0.0, 0.0, 1.0]] * 2)
    ids = torch.tensor([[0, 1], [1, -1]])
    return (*(x.to(device) for x in (blocks, o, d, ids)), [[9, 5], [5, -1]])


class ParentK7:
    """The parent's K7 through its C interface, on K7's ray planes."""

    def __init__(self, path):
        self.fn = ctypes.CDLL(str(path)).ptx_binned_isect_launch
        p, i = ctypes.c_void_p, ctypes.c_int
        self.fn.argtypes = [p, i, i, p, i, p, p, p, i, p, p, p]
        self.fn.restype = ctypes.c_int

    def __call__(self, tt, blocks, rays, offs):
        n = rays.shape[1]
        c, l = blocks.shape[0], blocks.shape[1]
        t = torch.full((n,), float("inf"), device="cuda")
        prim = torch.full((n,), -1, dtype=torch.int32, device="cuda")
        chunk_start, n_items = tt.work_items(offs, n)
        err = self.fn(blocks.data_ptr(), c, l, rays.data_ptr(), n, offs.data_ptr(),
                      chunk_start.data_ptr(), tt.filled_groups(blocks).data_ptr(), n_items,
                      t.data_ptr(), prim.data_ptr(), torch.cuda.current_stream().cuda_stream)
        if err:
            raise RuntimeError(f"parent K7: cudaError_t {err}")
        return t, prim


def builds():
    """{name: (threads, cap)} of every library swept: blocks of THREADS,
    registers capped at 64 or not; "" is the build's own."""
    out = {}
    for th in THREADS:
        for cap in (False, True):
            name = "" if (th, cap) == (BUILD_THREADS, False) else f" T{th}{' cap64' if cap else ''}"
            out[name] = (th, cap)
    return out


def configs(rows, threads):
    """(name, splits, staged) of every configuration a block of `threads`
    takes at cluster height `rows`."""
    from ..accel import cluster_major as cm

    out = []
    for staged in STAGED:
        for s in SPLITS:
            if s is not None and s > threads // 32:
                continue
            name = f"T{threads} {'auto' if s is None else f'S{s}'} {'bulk' if staged else 'L1'}"
            out.append((name, cm.stage_splits(rows, threads) if s is None else s, staged))
    return out


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--parent", help="a checkout of the parent commit: its K7 beside")
    ap.add_argument("--out", help="also write the figures there (cluster_major_sweep.json)")
    args = ap.parse_args()
    need_cuda()
    from ..accel import binned, cluster_major as cm, traverse as tt
    from ..models import scenes
    from .dense_sweep import compile_all
    from .query_sweep import bits_equal, query_rays, variant_csrc

    smi = card()
    _build.build_all(["cluster_major", "binned_isect"])
    SWEEP_DIR.mkdir(parents=True, exist_ok=True)
    variants = {name: shape for name, shape in builds().items() if name}
    jobs, paths = [], {}
    for name, (th, cap) in variants.items():
        tag = name.strip().replace(" ", "_")
        tree = variant_csrc(SWEEP_DIR / f"k8_{tag}", "cluster_major.cu",
                            dict(kThreads=th, kMinWarps=32 if cap else 0))
        paths[name] = SWEEP_DIR / f"libcluster_major_{tag}.so"
        jobs.append((tree / "cluster_major.cu", paths[name], list(_build.NVCC_FLAGS)))
    parent = None
    if args.parent:
        lib = SWEEP_DIR / "libbinned_isect_parent.so"
        src = Path(args.parent).resolve() / "cpupathtrace_tpu_torch" / "csrc" / "binned_isect.cu"
        jobs.append((src, lib, list(_build.NVCC_FLAGS)))
    reports = compile_all(jobs)
    if args.parent:
        parent = ParentK7(lib)
    libs = {"": _build.load("cluster_major"),
            **{name: ctypes.CDLL(str(path)) for name, path in paths.items()}}
    inst = {"": _build.ptxas_instances(_build.ptxas_report.get("cluster_major", "")),
            **{name: _build.ptxas_instances(reports[path]) for name, path in paths.items()}}
    dragon = scenes.bench_dragon_scene(dragon_tris=DRAGON_TRIS, device="cuda")
    blocks = cm.cluster_blocks(dragon)
    c, rows = blocks.shape[0], blocks.shape[1]
    o, d, _ = query_rays()
    cases = {}
    for m in CAND_M:
        ids, _ = binned.generate_candidates(dragon, o, d, m)
        order, offs, rays = k7_inputs(cm, ids, o, d, c)
        cases[m] = dict(ids=ids, order=order, offs=offs, rays=rays,
                        plain=cm._test_candidates(blocks, o, d, ids),
                        k7_plain=tt.isect_reference(blocks, rays, offs))
    torch.cuda.synchronize()

    def use(build):
        _build._LIBS["cluster_major"] = libs[build]

    # K8 on the binned pairs (work list and launch), K7 on its ray planes
    # (fills, work list and launch); the whole stage.
    runs, specs = {}, {}
    for build, (th, _) in builds().items():
        for name, s, staged in configs(rows, th):
            specs[name + build] = (build, th, s, staged)
            runs[name + build] = (lambda build, s, staged: lambda m: (
                use(build), cm.stage_run(blocks, o, d, cases[m]["order"], cases[m]["offs"], m,
                                         s, staged))[1])(build, s, staged)
    use("")
    runs["k7"] = lambda m: tt.isect(blocks, cases[m]["rays"], cases[m]["offs"])
    if parent:
        runs["parent"] = lambda m: parent(tt, blocks, cases[m]["rays"], cases[m]["offs"])
    runs["stage"] = lambda m: cm.test_candidates(blocks, o, d, cases[m]["ids"])
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    figures = {}
    for name, run in runs.items():
        fig = dict(config=name, card=smi, ms={})
        for m, case in cases.items():
            t, p = run(m)
            want = case["k7_plain"] if name in ("k7", "parent") else case["plain"]
            if not (bits_equal(t, want[0]) and torch.equal(p, want[1])):
                raise RuntimeError(f"K8 {name} differs from the plain version at M = {m}")
        if name in specs:
            build, th, s, staged = specs[name]
            use(build)
            work = {}
            for m, case in cases.items():
                shape = cm.stage_shape(blocks, case["ids"].numel(), s, staged)
                if shape["threads"] != th:
                    raise RuntimeError(f"K8 build{build}: {shape['threads']} threads, not {th}")
                work[m] = dict(grid=shape["grid"], **stage_figures(tt, blocks, case["ids"], s))
            use("")
            fig.update(threads=th, splits=s, staged=staged, blocks_per_sm=shape["blocks_per_sm"],
                       ptxas=inst[build].get(f"cluster_major_kernel<{int(staged)}>"), work=work)
        figures[name] = fig
    use("")
    names = [n for n in runs if n != "parent"]
    order = (["parent"] if parent else []) + names + names[::-1] + (["parent"] if parent else [])
    for name in order:
        for m in cases:
            timer = whole_ms if name == "stage" else best_ms
            figures[name]["ms"].setdefault(f"M{m}", []).append(
                timer(lambda: runs[name](m), REPS))
    stage = cases[CAND_M[0]]["ids"]
    summary = dict(card=smi, clusters=c, cluster_rows=rows, rays=int(o.shape[0]),
                   pairs={f"M{m}": int((case["ids"] >= 0).sum()) for m, case in cases.items()},
                   host_reads=dict(stage=host_syncs(lambda: cm.test_candidates(blocks, o, d,
                                                                               stage)),
                                   bincount=host_syncs(lambda: torch.bincount(
                                       stage.reshape(-1) + 1, minlength=c + 1))))
    for fig in figures.values():
        print(json.dumps(fig, default=float), flush=True)
    print(json.dumps(summary), flush=True)
    if args.out:
        os.makedirs(args.out, exist_ok=True)
        with open(os.path.join(args.out, "cluster_major_sweep.json"), "w") as f:
            json.dump(dict(configs=list(figures.values()), **summary), f, indent=1, default=float)


if __name__ == "__main__":
    main()
