"""PathTraceDemo on the torch port: the reference's demo/main.cpp.

Renders the Cornell-box demo scene (coloured walls, emissive ceiling panel,
glass dragon mesh, blue mirror sphere, rotated stretched white box; thin-lens
camera with circular aperture) with a console progress bar, post-processes,
and writes a PNG (ref: demo/main.cpp:22-241). Runs on the CUDA card; --cpu
runs the kernels' plain versions on the CPU.

Usage: python -m cpupathtrace_tpu_torch.demo [output.png] [--width N]
           [--height N] [--spp-min N] [--spp-max N]
           [--dragon path/to/xyzrgb_dragon.obj] [--no-dragon] [--cpu]
           [--sharded]

--sharded renders through parallel.render_sharded_adaptive over every rank
of the world: under `torchrun --nproc-per-node=N`, or alone as a world of
one. Rank 0 writes the PNG. The ranks run NCCL on the card (a rank per
card) and gloo with --cpu.
"""
from __future__ import annotations

import argparse
import sys
import time


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("output", nargs="?", default="render_box.png")
    p.add_argument("--width", type=int, default=256)
    p.add_argument("--height", type=int, default=256)
    p.add_argument("--spp-min", type=int, default=16)
    p.add_argument("--spp-max", type=int, default=64)
    p.add_argument("--max-depth", type=int, default=40)
    p.add_argument("--dragon", default=None, help="path to xyzrgb_dragon.obj")
    p.add_argument("--no-dragon", action="store_true")
    p.add_argument("--dragon-tris", type=int, default=20000,
                   help="triangle count of the procedural dragon stand-in")
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--sharded", action="store_true",
                   help="adaptive render sharded over every rank of the world")
    p.add_argument("--cpu", action="store_true",
                   help="render on the CPU with the kernels' plain versions")
    args = p.parse_args(argv)

    import torch

    import cpupathtrace_tpu_torch as pt
    from cpupathtrace_tpu_torch.models.scenes import (
        cornell_demo_camera,
        cornell_demo_options,
        cornell_demo_scene,
    )

    device = "cpu" if args.cpu else "cuda"
    name = "cpu" if args.cpu else (torch.cuda.get_device_name(0)
                                   if torch.cuda.is_available() else "no CUDA card")
    print(f"device: {device} ({name})", file=sys.stderr)
    t0 = time.time()
    scene = cornell_demo_scene(
        dragon_obj=args.dragon,
        dragon_tris=args.dragon_tris,
        include_dragon=not args.no_dragon,
        device=device,
    )
    print(
        f"scene: {scene.n_tri} triangles, {scene.n_sph} spheres, "
        f"{scene.n_emissive} emitters, accel={scene.accel} ({time.time()-t0:.1f}s)",
        file=sys.stderr,
    )
    camera = cornell_demo_camera(args.width, args.height, device=device)
    options = cornell_demo_options(
        args.width, args.height,
        min_sample_count=args.spp_min, max_sample_count=args.spp_max,
        max_depth=args.max_depth,
    )

    def progress(done, total):
        # Console progress bar (ref: demo/main.cpp:211-226).
        bar = "#" * int(done / total * 50)
        print(f"\r[{bar:<50}] {done}/{total}", end="", file=sys.stderr, flush=True)

    t0 = time.time()
    rank = 0
    if args.sharded:
        # The adaptive min / max-spp contract over the mesh: render()'s
        # stopping rule, chunks sharded (dp over pixels, sp over samples).
        import torch.distributed as dist

        from cpupathtrace_tpu_torch.parallel import (
            adaptive_sample_axis,
            make_render_mesh,
            render_sharded_adaptive,
        )
        from cpupathtrace_tpu_torch.parallel.distributed import initialize

        initialize(backend="gloo" if args.cpu else "nccl")
        world = dist.get_world_size() if dist.is_initialized() else 1
        mesh = make_render_mesh(sample_axis=adaptive_sample_axis(options, world),
                                device_type=device)
        rank = dist.get_rank()
        img = render_sharded_adaptive(scene, camera, options, mesh, seed=args.seed,
                                      progress_callback=progress if rank == 0 else None)
        if rank == 0:
            print(f"mesh (dp, sp) = {tuple(mesh.shape)} over {world} rank(s)", file=sys.stderr)
        dist.destroy_process_group()
    else:
        img = pt.render(scene, camera, options, seed=args.seed, progress_callback=progress,
                        device=device)
    print(file=sys.stderr)
    if rank != 0:
        return 0
    dt = time.time() - t0
    rays = args.width * args.height * args.spp_max
    print(f"rendered in {dt:.1f}s (<= {rays/dt/1e6:.2f} Mrays/s)", file=sys.stderr)

    out = pt.post_process(torch.from_numpy(img))
    try:
        pt.write_rgb_image(args.output, out)
    except (OSError, ValueError) as e:  # (ref: demo/main.cpp:230-238)
        print(f"failed to write image: {e}", file=sys.stderr)
        return 1
    print(f"wrote {args.output}", file=sys.stderr)
    return 0


if __name__ == "__main__":
    sys.exit(main())
