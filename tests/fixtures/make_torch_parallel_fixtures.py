"""Regenerate tests/fixtures/torch_parallel.npz: the JAX package's sharded
renders of renderSceneBox (`bench_box_scene`, `bench_camera`) on the CPU's
8 virtual devices, which tests/test_torch_parallel.py holds the port's
sharded frames against statistically:

  * fixed [F, 13, 16, 4]: `render_sharded` on `make_render_mesh()`
    ((dp, sp) = (4, 2)) at FIXED_OPTIONS, seeds 0..F-1;
  * adaptive [F, 13, 16, 4]: `render_sharded_adaptive` on the mesh of
    `adaptive_sample_axis` at ADAPTIVE_OPTIONS, seeds 0..F-1.

    JAX_PLATFORMS=cpu python tests/fixtures/make_torch_parallel_fixtures.py
"""
import os
import sys

os.environ.setdefault("XLA_FLAGS", "--xla_force_host_platform_device_count=8")

import jax  # noqa: E402

jax.config.update("jax_platforms", "cpu")

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__)))))

import numpy as np  # noqa: E402

OUT = os.path.join(os.path.dirname(os.path.abspath(__file__)), "torch_parallel.npz")
FRAMES = 8
# (width, height, min spp, max spp, max_depth), shared with the test.
FIXED_OPTIONS = (16, 13, 8, 8, 6)
ADAPTIVE_OPTIONS = (16, 13, 8, 16, 6)


def main():
    from cpupathtrace_tpu import RenderOptions
    from cpupathtrace_tpu.models.scenes import bench_box_scene, bench_camera
    from cpupathtrace_tpu.parallel import (
        adaptive_sample_axis,
        make_render_mesh,
        render_sharded,
        render_sharded_adaptive,
    )

    assert len(jax.devices()) == 8, jax.devices()
    scene, camera = bench_box_scene(), bench_camera()
    w, h, lo, hi, depth = FIXED_OPTIONS
    fixed = RenderOptions(w, h, lo, hi, epsilon=1e-3, max_depth=depth)
    w, h, lo, hi, depth = ADAPTIVE_OPTIONS
    adaptive = RenderOptions(w, h, lo, hi, epsilon=1e-3, max_depth=depth)
    mesh = make_render_mesh()
    amesh = make_render_mesh(sample_axis=adaptive_sample_axis(adaptive, 8))
    out = {
        "fixed": np.stack([render_sharded(scene, camera, fixed, mesh, seed=s)
                           for s in range(FRAMES)]),
        "adaptive": np.stack([render_sharded_adaptive(scene, camera, adaptive, amesh, seed=s)
                              for s in range(FRAMES)]),
        "fixed_mesh": np.array(tuple(mesh.shape.values())),
        "adaptive_mesh": np.array(tuple(amesh.shape.values())),
    }
    for k, v in out.items():
        print(k, v.shape, float(v[..., :3].mean()) if v.ndim > 1 else v, flush=True)
    np.savez_compressed(OUT, **out)


if __name__ == "__main__":
    main()
