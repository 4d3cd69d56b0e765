"""Scaling harness of the sharded render (port of benchmarks/bench_scaling.py).

Two measurements and one model, over worlds of 1, 2, ... ranks started on
this host (`parallel.distributed.spawn_ranks`):

1. WEAK scaling: every dp shard renders its own tile x tile pixels at
   `spp` (the image grows with the mesh); per-rank Mrays/s against dp = 1,
   and the same image through a mesh of rank 0 alone against the sharded
   one (host-normalised: it divides out ranks that share a device).
2. STRONG scaling: the fixed tile x tile frame split over dp.
3. COMMUNICATION VOLUME: the calls and bytes of the collectives of one
   chunk, read from the tensors the code reduces (`collective_stats`), and
   the same shapes at 1920 x 1080 (bytes per chunk a rank, and a training
   step's gradient all_reduce of the material table).

Ranks on one card share it (gloo on CUDA tensors): such a row is labelled
"shared", not "scaling": its times say what sharing costs, not how the
render scales. With a card per rank the ranks run NCCL. On the CPU the
ranks are gloo processes sharing the host's cores.

    python -m cpupathtrace_tpu_torch.experiments.bench_scaling --out FILE
        [--device cuda|cpu] [--ranks 1,2] [--tile 64] [--spp 16]
        [--max-depth 12] [--iters 3]

Prints one JSON line and writes it to --out (nowhere else).
"""
from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time

import torch


def _sync(device):
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def _best(fn, device, iters):
    fn()
    _sync(device)
    best = float("inf")
    for _ in range(iters):
        t0 = time.perf_counter()
        fn()
        _sync(device)
        best = min(best, time.perf_counter() - t0)
    return best


def _rank(rank, world, device_type, tile, spp, max_depth, iters):
    """One rank's timings (seconds) and the collectives of one chunk."""
    from cpupathtrace_tpu_torch.core.config import RenderOptions
    from cpupathtrace_tpu_torch.models.scenes import bench_box_scene, bench_camera
    from cpupathtrace_tpu_torch.parallel import distributed as pd
    from cpupathtrace_tpu_torch.parallel.mesh import make_render_mesh, mesh_device
    from cpupathtrace_tpu_torch.parallel.render import pixel_coords, render_chunk_sharded

    mesh = make_render_mesh(sample_axis=1, device_type=device_type)
    alone = make_render_mesh([0], device_type=device_type)
    dev = mesh_device(mesh)
    scene, camera = bench_box_scene(device=dev), bench_camera(device=dev)

    def chunk(m, opts, x, y):
        return lambda: render_chunk_sharded(scene, camera, opts, m, x, y, 0, spp)

    out = {}
    weak = RenderOptions(tile, tile * world, spp, spp, epsilon=1e-3, max_depth=max_depth)
    x, y, _ = pixel_coords(weak, world, dev)
    out["weak_s"] = _best(chunk(mesh, weak, x, y), dev, iters)
    pd.collective_stats(reset=True)
    chunk(mesh, weak, x, y)()
    out["collectives_per_chunk"] = pd.collective_stats(reset=True)
    if rank == 0:
        out["weak_alone_s"] = _best(chunk(alone, weak, x, y), dev, iters)
    strong = RenderOptions(tile, tile, spp, spp, epsilon=1e-3, max_depth=max_depth)
    x, y, _ = pixel_coords(strong, world, dev)
    out["strong_s"] = _best(chunk(mesh, strong, x, y), dev, iters)
    out["n_materials"] = scene.num_materials
    return out


def comm_model(n_materials: int, width: int = 1920, height: int = 1080) -> dict:
    """Bytes a rank reduces per chunk at width x height (the [P/dp, 5]
    float32 sp all_reduce and the [P, 5] dp gather), and a training step's
    gradient all_reduce (diffuse, specular, emission: 12 float32 a
    material)."""
    pixels = width * height
    out = {}
    for dp, sp in ((8, 1), (4, 2), (2, 1), (1, 2)):
        shard = -(-pixels // dp)
        out[f"dp{dp}xsp{sp}"] = {
            "sp_all_reduce_bytes_per_chunk": shard * 5 * 4 if sp > 1 else 0,
            "dp_gather_bytes_per_chunk": (shard * dp) * 5 * 4 if dp > 1 else 0,
            "grad_all_reduce_bytes_per_step": n_materials * 12 * 4,
        }
    return out


def _smi():
    try:
        return subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                               "--format=csv,noheader"], capture_output=True, text=True,
                              timeout=30).stdout.strip()
    except (OSError, subprocess.SubprocessError):
        return "not measured"


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--out", required=True)
    ap.add_argument("--device", choices=("cuda", "cpu"), default="cuda")
    ap.add_argument("--ranks", default="1,2")
    ap.add_argument("--tile", type=int, default=64)
    ap.add_argument("--spp", type=int, default=16)
    ap.add_argument("--max-depth", type=int, default=12)
    ap.add_argument("--iters", type=int, default=3)
    args = ap.parse_args(argv)
    from cpupathtrace_tpu_torch.parallel.distributed import spawn_ranks

    cards = torch.cuda.device_count() if args.device == "cuda" else 0
    if args.device == "cuda":
        if not cards:
            print("bench_scaling: no CUDA device", file=sys.stderr)
            return 1
        # The ranks load K1; it is built here, once, before they start.
        from cpupathtrace_tpu_torch import _build

        _build.build_all(("megakernel",))
    rows = {}
    for n in (int(r) for r in args.ranks.split(",")):
        shared = args.device == "cuda" and n > cards
        backend = "nccl" if args.device == "cuda" and not shared else "gloo"
        res = spawn_ranks(_rank, n, backend, args=(args.device, args.tile, args.spp,
                                                   args.max_depth, args.iters),
                          deadline_s=900, threads=1 if args.device == "cuda" else 2)
        r0 = res[0]
        px = args.tile * args.tile
        rows[str(n)] = {
            "label": "shared" if n > 1 and (shared or args.device == "cpu") else "scaling",
            "backend": backend,
            "weak_ms": r0["weak_s"] * 1e3,
            "weak_mrays_per_rank": px * n * args.spp / r0["weak_s"] / 1e6 / n,
            "weak_host_normalized": r0["weak_alone_s"] / r0["weak_s"],
            "strong_ms": r0["strong_s"] * 1e3,
            "strong_mrays": px * args.spp / r0["strong_s"] / 1e6,
            "collectives_per_chunk": r0["collectives_per_chunk"],
        }
        print(f"# ranks {n} ({rows[str(n)]['label']}, {backend}): {rows[str(n)]}",
              file=sys.stderr, flush=True)
    base = rows[min(rows, key=int)]
    out = {
        "metric": "scaling",
        "device": torch.cuda.get_device_name(0) if args.device == "cuda" else "cpu",
        "nvidia_smi": _smi() if args.device == "cuda" else "not measured",
        "tile": args.tile, "spp": args.spp, "max_depth": args.max_depth,
        "host_cores": os.cpu_count(),
        "rows": rows,
        "weak_efficiency_vs_first": {k: r["weak_mrays_per_rank"] / base["weak_mrays_per_rank"]
                                     for k, r in rows.items()},
        "comm_model_1080p": comm_model(res[0]["n_materials"]),
        "note": ("rows labelled 'shared' ran several ranks on one device: they measure the "
                 "cost of sharing it, not scaling"),
    }
    line = json.dumps(out)
    os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
    with open(args.out, "w") as f:
        f.write(line + "\n")
    print(line)
    return 0


if __name__ == "__main__":
    sys.exit(main())
