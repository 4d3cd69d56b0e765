"""The block shape of the dense forms of K1 and K2, swept on the card.

    python -m cpupathtrace_tpu_torch.experiments.dense_sweep [--parent ROOT] [--out DIR]

Each configuration (threads a block, and the blocks each SM must hold,
`__launch_bounds__`'s minimum, which caps the registers) is built from a
copy of csrc/ with `kDenseThreads` / `kDenseMinBlocks` rewritten in
megakernel.cu and bounce.cu, into _build/sweep/ (git-ignored), and driven
through the port's own wrappers: K1's dense form on the renderSceneBox
frame's 4,194,304 camera paths (128x128 @ 256 spp, max_depth 40), and K2's
dense record form on one bounce (depth 1) of renderSceneBoxGrad's 262,144
rays. Every configuration is held to the twins first (K1's spectrum
bit-equal, K2's planes and records equal on every ray), then timed in
turns (forward, then backward) by `best_ms`, the card's work alone.
Each line gives its ptxas registers and spills, its occupancy and K1's
lane use beside the card's name and power limit.

The loads per pair-record row come from the SASS (cuobjdump) of a probe
that runs each row test of dense_intersect.cuh once (pair_anyhit on one
row; pair_nearest on one row, whose winner's prim, material and normals
are loaded after the test), and the loads of each dense instance of the
built kernels, by opcode.

With --parent ROOT (a checkout of the parent commit), its csrc/ is built
beside them: its K2 (the same C interface) is timed in the same turns,
first and last, on the live rays' columns (the parent kernel wrote only
those; its wrapper filled the rest before the launch), and its SASS is
counted the same way.
"""
from __future__ import annotations

import argparse
import collections
import ctypes
import json
import os
import re
import shutil
import subprocess
from pathlib import Path

import numpy as np
import torch

from .. import _build
from . import best_ms, card, need_cuda

# name -> (threads a block, blocks an SM at least); "w24": capped to 24
# resident warps an SM, "none": a minimum of one block (no cap below 255
# registers).
CONFIGS = {
    "256 w24": (256, 3),
    "256 none": (256, 1),
    "128 w24": (128, 6),
    "128 none": (128, 1),
}
LIBS = ("megakernel", "bounce")
CONSTANTS = ("kDenseThreads", "kDenseMinBlocks")
SWEEP_DIR = _build.BUILD_DIR / "sweep"
# nvcc's code flags without those of a shared library.
CODE_FLAGS = _build.NVCC_FLAGS[:_build.NVCC_FLAGS.index("-shared")]

BOX_W = BOX_H = 128
BOX_SPP = 256
GRAD_SPP = 16
MAX_DEPTH = 40
GRAD_DEPTH = 12
REPS = 5

PROBE = r"""
#include "dense_intersect.cuh"
using namespace ptx;

__device__ __forceinline__ Ray probe_ray(const float* r) {
  return Ray{r[0], r[1], r[2], r[3], r[4], r[5]};
}

// One pair-record row test each, the row staged in shared memory.
extern "C" __global__ void probe_anyhit(const float* rec, const float* ray, int* out) {
  extern __shared__ float s[];
  for (int j = threadIdx.x; j < kRecCols; j += blockDim.x) s[j] = rec[j];
  __syncthreads();
  out[threadIdx.x] = pair_anyhit<-1>(s, 1, probe_ray(ray), ray[6]);
}

extern "C" __global__ void probe_nearest(const float* rec, const float* ray, float* out) {
  extern __shared__ float s[];
  for (int j = threadIdx.x; j < kRecCols; j += blockDim.x) s[j] = rec[j];
  __syncthreads();
  Hit h = no_hit();
  pair_nearest<-1>(s, 1, probe_ray(ray), h);
  out[threadIdx.x] = h.t + h.nx + h.ny + h.nz + h.prim + h.mat;
}
"""
LDS = re.compile(r"\b(LDS(?:\.[A-Z0-9]+)*)\b")
SASS_FUNCTION = re.compile(r"Function : (\S+)")


def tag(name):
    """A file-name form of a configuration's name."""
    return re.sub(r"\W", "_", name)


def variant_csrc(dst: Path, threads: int, min_blocks: int) -> Path:
    """A copy of csrc/ at `dst` with the dense block constants rewritten."""
    shutil.rmtree(dst, ignore_errors=True)
    shutil.copytree(_build.CSRC, dst)
    for name in LIBS:
        path = dst / f"{name}.cu"
        text = path.read_text()
        for const, value in zip(CONSTANTS, (threads, min_blocks)):
            text, n = re.subn(rf"constexpr int {const} = \d+;",
                              f"constexpr int {const} = {value};", text)
            if n != 1:
                raise RuntimeError(f"{path}: {n} definitions of {const}, expected 1")
        path.write_text(text)
    return dst


def compile_all(jobs):
    """Runs nvcc for every (source, output, flags) at once; returns each
    output's ptxas report. Raises if any build fails."""
    running = [(out, subprocess.Popen([_build._nvcc(), *flags, str(src), "-o", str(out)],
                                      stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                                      text=True))
               for src, out, flags in jobs]
    reports, errors = {}, []
    for out, proc in running:
        stdout, stderr = proc.communicate()
        if proc.returncode:
            errors.append(f"{out}: {stdout}\n{stderr}")
        reports[out] = stderr
    if errors:
        raise RuntimeError("build failed:\n" + "\n".join(errors))
    return reports


def sass_loads(binary: Path, match=None):
    """Shared-memory loads by opcode (LDS, LDS.64, LDS.128, ...) in each
    function of a built library or cubin whose name contains `match`."""
    cuobjdump = Path(_build._nvcc()).parent / "cuobjdump"
    text = subprocess.run([str(cuobjdump), "-sass", str(binary)], capture_output=True,
                          text=True, check=True).stdout
    out, cur = {}, None
    for ln in text.splitlines():
        m = SASS_FUNCTION.search(ln)
        if m:
            name = m.group(1)
            if name.startswith("_Z"):
                name = _build.instance_name(re.sub(r"^_ZN?", "", name))
            cur = out.setdefault(name, collections.Counter()) if not match or match in name \
                else None
        elif cur is not None:
            cur.update(LDS.findall(ln))
    return {k: dict(v) for k, v in out.items()}


def box_frame_rays(scenes, opts, spp, seed):
    """The camera rays of a box frame of `spp` samples a pixel, sample-major,
    as render() shoots them."""
    from ..camera.camera import shoot_rays
    from ..integrator.film import pixel_camera_coords

    w, h = opts.image_width, opts.image_height
    xg, yg = np.meshgrid(np.arange(w, dtype=np.float32), np.arange(h, dtype=np.float32))
    x, y = pixel_camera_coords(opts, xg.ravel(), yg.ravel())
    gen = torch.Generator(device="cuda")
    gen.manual_seed(seed)
    return shoot_rays(scenes.bench_camera(), torch.tensor(x, device="cuda").repeat(spp),
                      torch.tensor(y, device="cuda").repeat(spp), 1.0 / w, 1.0 / h, gen)


def bits_equal(a, b):
    return bool(torch.equal(a.contiguous().view(torch.int32), b.contiguous().view(torch.int32)))


class Cases:
    """The two kernels' inputs and their twins' outputs, made once."""

    def __init__(self):
        import cpupathtrace_tpu_torch as pt
        from ..integrator import megakernel as mk
        from ..integrator import sorted_wavefront as sw
        from ..models import scenes

        self.mk, self.sw = mk, sw
        self.scene = scenes.bench_box_scene()
        self.kscene = mk.kernel_scene(self.scene)
        self.smem = self.kscene.smem_bytes()
        self.cull = int(self.scene.krn_big_cull_mode)
        self.k1_opts = pt.RenderOptions(BOX_W, BOX_H, BOX_SPP, BOX_SPP, epsilon=1e-3,
                                        max_depth=MAX_DEPTH)
        self.rays = box_frame_rays(scenes, self.k1_opts, BOX_SPP, 0)
        self.seed = torch.tensor([99], dtype=torch.int32, device="cuda")
        self.k1_twin, _ = mk.trace_megakernel_reference(self.scene, self.rays, self.k1_opts, 99,
                                                        self.kscene)
        self.k2_opts = pt.RenderOptions(BOX_W, BOX_H, GRAD_SPP, GRAD_SPP, epsilon=1e-3,
                                        max_depth=GRAD_DEPTH)
        grad_rays = box_frame_rays(scenes, self.k2_opts, GRAD_SPP, 5)
        st = sw.initial_state(grad_rays.origin, grad_rays.direction, 5)
        self.n_drec = sw.n_diff_records(self.scene.n_point_lights,
                                        self.scene.emissive_sample_count)
        sw.bounce_reference(self.scene, st, 0, self.k2_opts, self.kscene,
                            records=self.records(st.shape[1]))
        self.state = st
        self.live = st[17] > 0.5
        self.sd = torch.tensor([5, 1], dtype=torch.int32, device="cuda")
        self.k2_twin = st.clone()
        self.k2_twin_rec = self.records()
        sw.bounce_reference(self.scene, self.k2_twin, 1, self.k2_opts, self.kscene,
                            records=self.k2_twin_rec)
        torch.cuda.synchronize()

    def records(self, n=None):
        """NaN-filled record planes for `n` rays (default: the K2 state's)."""
        n = self.state.shape[1] if n is None else n
        return torch.full((self.n_drec, n), float("nan"), device="cuda")

    def k1(self, **kw):
        # The seed on the card: a host int would be copied from pageable
        # memory, which waits for the stream, and best_ms needs the host
        # ahead of the card.
        return self.mk.trace_megakernel(self.scene, self.rays, self.k1_opts, self.seed,
                                        self.kscene, **kw)[0]

    def k2(self, records):
        st = self.state.clone()
        self.sw.bounce(self.scene, st, self.sd, self.k2_opts, self.kscene, records=records)
        return st

    def check(self, parent):
        """K1 bit-equal with its lane use (none for the parent); K2's planes
        and records equal to the twin's, on the live rays' columns for the
        parent."""
        out = {}
        if not parent:
            steps = torch.zeros(self.mk.BOUNCE_STEP_COLS, dtype=torch.int64, device="cuda")
            plain, counted = self.k1(), self.k1(bounce_steps=steps)
            torch.cuda.synchronize()
            if not (bits_equal(plain, self.k1_twin) and bits_equal(counted, plain)):
                raise RuntimeError("K1 dense differs from its twin")
            out["k1_lane_use"] = self.mk.lane_use(steps.cpu())
        rec = self.records()
        st = self.k2(rec)
        torch.cuda.synchronize()
        cols = self.live if parent else slice(None)
        if not (bits_equal(st, self.k2_twin)
                and bits_equal(rec[:, cols], self.k2_twin_rec[:, cols])):
            raise RuntimeError("K2's record form differs from its twin")
        return out

    def time_k1(self):
        return best_ms(self.k1, REPS)

    def time_k2(self):
        rec = self.records()
        copies = iter([self.state.clone() for _ in range(REPS + 1)])
        return best_ms(lambda: self.sw.bounce(self.scene, next(copies), self.sd, self.k2_opts,
                                              self.kscene, records=rec), REPS)


def use(libs):
    """Point the port's wrappers at these built libraries."""
    for name, path in libs.items():
        _build._LIBS[name] = ctypes.CDLL(str(path))


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--parent", help="a checkout of the parent commit: its K2 and SASS beside")
    ap.add_argument("--out", help="also write the figures there (dense_sweep.json)")
    args = ap.parse_args()
    need_cuda()

    # Every build at once: each configuration's two libraries, the parent's,
    # and the row-test probe against each tree's dense_intersect.cuh.
    trees = {name: variant_csrc(SWEEP_DIR / f"c{i}", *cfg) for i, (name, cfg)
             in enumerate(CONFIGS.items())}
    if args.parent:
        trees["parent"] = Path(args.parent).resolve() / "cpupathtrace_tpu_torch" / "csrc"
    trees["current"] = _build.CSRC
    probe = SWEEP_DIR / "probe.cu"
    SWEEP_DIR.mkdir(parents=True, exist_ok=True)
    probe.write_text(PROBE)
    jobs, libs = [], {}
    for name, tree in trees.items():
        jobs.append((probe, SWEEP_DIR / f"probe_{tag(name)}.cubin",
                     ["-cubin", *CODE_FLAGS, "-I", str(tree)]))
        if name == "current":
            continue
        libs[name] = {lib: SWEEP_DIR / f"lib{lib}_{tag(name)}.so" for lib in LIBS}
        jobs += [(tree / f"{lib}.cu", out, list(_build.NVCC_FLAGS))
                 for lib, out in libs[name].items()]
    reports = compile_all(jobs)

    cases = Cases()
    smi = card()
    figures = {}
    for name, paths in libs.items():
        use(paths)
        parent = name == "parent"
        checked = cases.check(parent)
        regs = {lib: _build.ptxas_instances(reports[path]) for lib, path in paths.items()}
        k1_inst = f"megakernel<{cases.cull}, 0>"
        k2_inst = f"bounce_kernel<{cases.cull}, 1>"
        fig = dict(config=name, card=smi, k2_records_ms=[],
                   k2_instance=k2_inst, k2_ptxas=regs["bounce"].get(k2_inst),
                   k2_blocks_per_sm=cases.sw.bounce_occupancy(cases.smem, False, cases.cull,
                                                              True),
                   sass_loads={lib: sass_loads(path, "megakernel<" if lib == "megakernel"
                                               else "bounce_kernel<")
                               for lib, path in paths.items()})
        if not parent:
            fig.update(k1_ms=[], k1_instance=k1_inst, k1_ptxas=regs["megakernel"].get(k1_inst),
                       k1_blocks_per_sm=cases.mk.occupancy(cases.smem, False, False,
                                                           cases.cull),
                       **checked)
        figures[name] = fig
    # In turns: the parent first and last, the configurations forward then
    # backward.
    names = list(CONFIGS)
    order = (["parent"] if args.parent else []) + names + names[::-1] + (
        ["parent"] if args.parent else [])
    # The parent wrapper's fill of the record planes before each launch.
    planes = cases.records()
    fill_ms = best_ms(lambda: cases.sw.clear_records(planes), REPS)
    for name in order:
        use(libs[name])
        if name != "parent":
            figures[name]["k1_ms"].append(cases.time_k1())
        figures[name]["k2_records_ms"].append(cases.time_k2())
    probes = {name: sass_loads(SWEEP_DIR / f"probe_{tag(name)}.cubin") for name in trees}
    for name in libs:
        print(json.dumps(figures[name], default=float), flush=True)
    summary = dict(card=smi, fill_ms=fill_ms, row_test_probe_loads=probes,
                   k1_rays=int(cases.rays.origin.shape[0]), k2_rays=int(cases.state.shape[1]),
                   k2_alive_in=int(cases.live.sum()))
    print(json.dumps(summary, default=float), flush=True)
    if args.out:
        os.makedirs(args.out, exist_ok=True)
        with open(os.path.join(args.out, "dense_sweep.json"), "w") as f:
            json.dump(dict(configs=figures, **summary), f, indent=1, default=float)


if __name__ == "__main__":
    main()
