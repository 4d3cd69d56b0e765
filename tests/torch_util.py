"""Shared helpers of the tests/test_torch_*.py files, which hold the torch
port (cpupathtrace_tpu_torch) against the JAX package on the same inputs.

Inputs come from numpy with fixed seeds and are handed to both packages.
Torch runs with two threads per test worker.
"""
import contextlib
import dataclasses

import numpy as np
import torch

torch.set_num_threads(2)

RAY_BLOCK = 8192  # one TPU megakernel block (64 x 128 rays)

# Kernel-parity cases: name -> (scene name of build_scene, ray kind,
# max_depth, kernel seed). "box" is the pair-record form, "sphere" the
# table form; "specular_no_em" is "specular" without emitter NEE
# (emissive_sample_count 0), which isolates the glass / mirror / point
# light paths from the emitter shadow test's rounding race (see
# tests/test_torch_megakernel.py).
MEGAKERNEL_CASES = {
    "box": ("bench_box", "sphere_dirs", 3, 1234),
    "specular": ("specular_point_light", "sphere_dirs", 4, 77),
    "specular_no_em": ("specular_point_light_no_em", "sphere_dirs", 4, 77),
    "sphere": ("sphere_point_light", "forward_dirs", 3, 5),
}


def make_rays(kind: str, n: int = RAY_BLOCK, seed: int = 0):
    """(origin [n,3], direction [n,3]) float32 numpy rays from the origin:
    uniform directions ("sphere_dirs") or directions biased to +z
    ("forward_dirs", toward the sphere of the point-light scene)."""
    rng = np.random.default_rng(seed)
    d = rng.normal(size=(n, 3))
    if kind == "forward_dirs":
        d[:, 2] = np.abs(d[:, 2]) + 0.2
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    return np.zeros((n, 3), np.float32), d.astype(np.float32)


def build_scene(name: str, pkg: str):
    """Scene `name` built by the JAX package (pkg="jax") or the port."""
    if name.endswith("_no_em"):
        scene = build_scene(name[: -len("_no_em")], pkg)
        return dataclasses.replace(scene, emissive_sample_count=0)
    if pkg == "jax":
        from cpupathtrace_tpu.models import scenes
        from cpupathtrace_tpu.scene.scene import SceneBuilder
        from tests import scenes_util

        if name == "bench_box":
            return scenes.bench_box_scene()
        if name == "demo":
            return scenes.cornell_demo_scene(include_dragon=False)
        if name == "inward_box":
            return scenes_util.inward_box_scene()
        if name == "specular":
            return scenes_util.specular_box_scene()[0]
        if name == "specular_point_light":
            # specular_box_scene with the port's extra point light: rebuild
            # through the builder so both packages add the light alike.
            b = _jax_specular_builder()
            b.add_point_light((0.0, 0.5, 0.2), (0.6, 0.6, 0.6, 1.0))
            return b.build()
        if name == "sphere_point_light":
            b = SceneBuilder()
            b.add_point_light((0.0, 1.0, 0.0), (1.0, 1.0, 1.0, 1.0))
            b.add_sphere((0.0, 0.0, 0.6), 0.5)
            return b.build()
        raise KeyError(name)
    from cpupathtrace_tpu_torch.models import golden, scenes as tscenes

    return {
        "bench_box": tscenes.bench_box_scene,
        "demo": lambda: tscenes.cornell_demo_scene(include_dragon=False),
        "inward_box": golden.inward_box_scene,
        "specular": golden.specular_box_scene,
        "specular_point_light": lambda: golden.specular_box_scene(point_light=True),
        "sphere_point_light": golden.sphere_point_light_scene,
    }[name]()


def _jax_specular_builder():
    from cpupathtrace_tpu.scene.geometry import make_plane
    from cpupathtrace_tpu.scene.scene import BSDF_GLASS, BSDF_MIRROR, SceneBuilder

    b = SceneBuilder()
    white = b.add_material(diffuse=(1, 1, 1, 1))
    light = b.add_material(diffuse=(1, 1, 1, 1), emission=(1.0, 1.0, 1.0, 1.0))
    b.add_triangles(make_plane((1, -1, -1), (-1, -1, 1), True), white)
    b.add_triangles(make_plane((-1, 1, -1), (1, 1, 1), True), white)
    b.add_triangles(make_plane((-0.25, 0.99, -0.25), (0.25, 0.99, 0.25), True), light)
    b.add_triangles(make_plane((-1, -1, -1), (1, 1, -1), True), white)
    b.add_triangles(make_plane((-1, -1, -1), (-1, 1, 1), True), white)
    b.add_triangles(make_plane((1, -1, 1), (-1, 1, 1), True), white)
    b.add_triangles(make_plane((1, -1, 1), (1, 1, -1), True), white)
    mirror = b.add_material(
        diffuse=(0, 0, 1, 1), specular=(0.2, 0.4, 0.9, 1.0), bsdf=BSDF_MIRROR
    )
    glass = b.add_material(
        diffuse=(1, 1, 1, 1), specular=(0.9, 0.6, 0.3, 1.0), ior=1.5, bsdf=BSDF_GLASS
    )
    b.add_sphere((-0.4, -0.3, 0.5), 0.4, mirror)
    b.add_sphere((0.45, -0.35, 0.45), 0.35, glass)
    return b


def jax_scene_numpy(scene):
    """The JAX SceneData as (arrays, meta) numpy dicts for scene_from_numpy."""
    from cpupathtrace_tpu.scene.scene import STATIC_FIELDS

    arrays, meta = {}, {}
    for f in dataclasses.fields(scene):
        v = getattr(scene, f.name)
        if f.name in STATIC_FIELDS:
            meta[f.name] = v
        else:
            arrays[f.name] = np.asarray(v)
    return arrays, meta


@contextlib.contextmanager
def pallas_interpret():
    """Run every pallas_call in interpret mode, as tests/test_megakernel.py's
    fixture does, so the TPU kernel runs on the CPU."""
    from jax.experimental import pallas as pl
    from jax.experimental.pallas import tpu as pltpu

    orig = pl.pallas_call

    def patched(*args, **kwargs):
        kwargs["interpret"] = pltpu.InterpretParams()
        return orig(*args, **kwargs)

    pl.pallas_call = patched
    try:
        yield
    finally:
        pl.pallas_call = orig


def jax_megakernel(case: str):
    """Run the JAX megakernel (interpret mode) on a MEGAKERNEL_CASES case;
    returns spectrum [n, 4] float32."""
    import jax.numpy as jnp

    from cpupathtrace_tpu.core.config import RenderOptions
    from cpupathtrace_tpu.core.rays import Rays
    from cpupathtrace_tpu.integrator.pallas_megakernel import trace_megakernel

    scene_name, kind, depth, seed = MEGAKERNEL_CASES[case]
    o, d = make_rays(kind)
    with pallas_interpret():
        spec, _ = trace_megakernel(
            build_scene(scene_name, "jax"),
            Rays(jnp.asarray(o), jnp.asarray(d)),
            RenderOptions(8, 8, 1, 1, max_depth=depth),
            seed,
        )
    return np.asarray(spec)


def port_megakernel(case: str, device="cpu", kernel=False):
    """The port on a MEGAKERNEL_CASES case: the twin, or with `kernel` the
    wrapper (which launches the CUDA kernel for a CUDA device)."""
    from cpupathtrace_tpu_torch.core.config import RenderOptions
    from cpupathtrace_tpu_torch.core.rays import Rays
    from cpupathtrace_tpu_torch.integrator import megakernel

    scene_name, kind, depth, seed = MEGAKERNEL_CASES[case]
    o, d = make_rays(kind)
    fn = megakernel.trace_megakernel if kernel else megakernel.trace_megakernel_reference
    spec, _ = fn(
        build_scene(scene_name, "port").to(device),
        Rays(torch.tensor(o, device=device), torch.tensor(d, device=device)),
        RenderOptions(8, 8, 1, 1, max_depth=depth),
        seed,
    )
    return spec.cpu().numpy()
