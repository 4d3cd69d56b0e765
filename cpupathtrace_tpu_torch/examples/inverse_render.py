"""Inverse rendering example on the torch port: recover wall albedo from a
target image by gradient descent.

Renders a ground-truth Cornell box, perturbs the red accent wall's
albedo, then recovers it with Adam on an unbiased image loss
(independent-sample pairing keeps E[loss grad] unbiased despite Monte
Carlo noise). Emitters stay pinned at truth: with both albedo and emission
free the problem is ambiguous (a dimmer light and brighter walls explain
the same image). Prints the loss curve and the recovered vs true albedo,
writes before/after/target PNGs, and exits 0 when the largest albedo error
is below 0.2. Runs on the CUDA card; --cpu runs on the CPU.

Usage: python -m cpupathtrace_tpu_torch.examples.inverse_render [outdir]
           [--steps N] [--size N] [--spp N] [--cpu]
"""
from __future__ import annotations

import argparse
import os
import sys
import tempfile
import time


def main(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument("outdir", nargs="?",
                   default=os.path.join(tempfile.gettempdir(), "inverse_render"))
    p.add_argument("--steps", type=int, default=60)
    p.add_argument("--size", type=int, default=32)
    p.add_argument("--spp", type=int, default=16)
    p.add_argument("--cpu", action="store_true", help="render on the CPU")
    args = p.parse_args(argv)

    import numpy as np
    import torch

    import cpupathtrace_tpu_torch as pt
    from cpupathtrace_tpu_torch.diff.render import (
        apply_material_params,
        get_material_params,
        inverse_render,
        render_image_diff,
    )
    from cpupathtrace_tpu_torch.scene.geometry import make_plane

    device = "cpu" if args.cpu else "cuda"
    os.makedirs(args.outdir, exist_ok=True)

    # Ground-truth scene: white box, red accent wall, emissive panel.
    b = pt.SceneBuilder()
    white = b.add_material(diffuse=(1, 1, 1, 1))
    red = b.add_material(diffuse=(0.9, 0.15, 0.15, 1))
    light = b.add_material(diffuse=(1, 1, 1, 1), emission=(1.0, 0.9, 0.7, 1))
    b.add_triangles(make_plane((1, -1, -1), (-1, -1, 1), True), white)
    b.add_triangles(make_plane((-1, 1, -1), (1, 1, 1), True), white)
    b.add_triangles(make_plane((-0.25, 0.99, -0.25), (0.25, 0.99, 0.25), True), light)
    b.add_triangles(make_plane((-1, -1, -1), (1, 1, -1), True), white)
    b.add_triangles(make_plane((-1, -1, -1), (-1, 1, 1), True), white)
    b.add_triangles(make_plane((1, -1, 1), (-1, 1, 1), True), red)
    b.add_triangles(make_plane((1, -1, 1), (1, 1, -1), True), white)
    scene = b.build(device=device)
    cam = pt.make_camera((0, 0, 0), (0, 0, 0.9), (0, 1, 0), 1.0, 1.0, 1.0, device=device)
    opts = pt.RenderOptions(args.size, args.size, args.spp, args.spp, epsilon=1e-3,
                            max_depth=4)

    key = 0  # the JAX example's PRNGKey(0)

    def render_with(params, spp):
        with torch.no_grad():
            return render_image_diff(apply_material_params(scene, params), cam, opts, key,
                                     spp=spp)

    target = render_with({}, 256)
    true_red = scene.mat_diffuse[red].cpu().numpy()

    # Perturbed start: grey accent wall. Only the diffuse table is
    # optimised; emission / specular stay at truth (see the docstring).
    diffuse = get_material_params(scene)["mat_diffuse"].clone()
    diffuse[red] = torch.tensor([0.5, 0.5, 0.5, 1.0], device=diffuse.device)
    init = {"mat_diffuse": diffuse}

    def save(params, name):
        img = render_with(params, 256).reshape(args.size, args.size, 4)
        pt.write_rgb_image(os.path.join(args.outdir, name), pt.post_process(img))

    save(init, "before.png")
    save({}, "target.png")

    t0 = time.time()
    recovered, losses = inverse_render(
        scene, cam, opts, target, init,
        steps=args.steps, learning_rate=0.05, spp=args.spp, seed=1,
        callback=lambda i, loss, _p: print(
            f"step {i:3d}  loss {loss:.5f}", file=sys.stderr, flush=True
        ) if i % 10 == 0 else None,
    )
    print(f"# {args.steps} Adam steps in {time.time()-t0:.1f}s", file=sys.stderr)
    save(recovered, "after.png")

    got_red = recovered["mat_diffuse"][red].cpu().numpy()
    print(f"red wall albedo: true {true_red[:3]}, recovered {got_red[:3]}")
    print(f"loss: {losses[0]:.5f} -> {losses[-1]:.5f}")
    err = float(np.abs(got_red[:3] - true_red[:3]).max())
    print(f"max albedo error: {err:.3f}")
    return 0 if err < 0.2 else 1


if __name__ == "__main__":
    raise SystemExit(main())
