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

# The port's entry points run on the CUDA card unless told otherwise; the
# CPU tests ask for the CPU by name.
CPU = "cpu"

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
        "bench_box": lambda: tscenes.bench_box_scene(device=CPU),
        "demo": lambda: tscenes.cornell_demo_scene(include_dragon=False, device=CPU),
        "inward_box": lambda: golden.inward_box_scene(device=CPU),
        "specular": lambda: golden.specular_box_scene(device=CPU),
        "specular_point_light": lambda: golden.specular_box_scene(point_light=True, device=CPU),
        "sphere_point_light": lambda: golden.sphere_point_light_scene(device=CPU),
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


# ---------------------------------------------------------------------------
# Binned scenes: the cluster traversal and the sorted driver.
# ---------------------------------------------------------------------------

SORTED_RAYS = 1024  # one TPU sorted-wavefront block (8 x 128 rays)
SORTED_SEED = 1234
SORTED_DEPTH = 4


def dragon_scene(pkg: str, tris: int = 1200):
    """bench_dragon_scene(dragon_tris=tris, accel="binned") of either package."""
    if pkg == "jax":
        from cpupathtrace_tpu.models.scenes import bench_dragon_scene

        return bench_dragon_scene(dragon_tris=tris, accel="binned")
    from cpupathtrace_tpu_torch.models.scenes import bench_dragon_scene

    return bench_dragon_scene(dragon_tris=tris, accel="binned", device=CPU)


def mixed_cull_scene(pkg: str):
    """tests/test_kernel_traverse.py's mixed-cull binned scene: a ground
    plane (the big partition) and 400 random triangles, every other one
    culling."""
    if pkg == "jax":
        from cpupathtrace_tpu.scene.geometry import HostTriangle, make_plane
        from cpupathtrace_tpu.scene.scene import SceneBuilder
    else:
        from cpupathtrace_tpu_torch.scene.geometry import HostTriangle, make_plane
        from cpupathtrace_tpu_torch.scene.scene import SceneBuilder
    rng = np.random.default_rng(7)
    b = SceneBuilder()
    white = b.add_material(diffuse=(1, 1, 1, 1))
    b.add_triangles(make_plane((30, -1.2, -30), (-30, -1.2, 30), True), white)
    tris = []
    for i in range(400):
        c = rng.uniform(-0.8, 0.8, 3)
        v = c + rng.normal(scale=0.15, size=(3, 3))
        tris.append(HostTriangle(v[0], v[1], v[2], cull_backface=bool(i % 2)))
    b.add_triangles(tris, white)
    return b.build(accel="binned") if pkg == "jax" else b.build(accel="binned", device=CPU)


def query_rays(n: int, seed: int):
    """Rays from origins uniform in [-0.9, 0.9]^3 with uniform directions
    (tests/test_kernel_traverse.py's inputs)."""
    rng = np.random.default_rng(seed)
    o = rng.uniform(-0.9, 0.9, (n, 3)).astype(np.float32)
    d = rng.normal(size=(n, 3)).astype(np.float32)
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    return o, d


# Cluster-query cases: name -> (scene, rays seed, n, limit, any_hit).
# limit: None (no bound), "uniform" (t_max ~ U(0.05, 1.5)) or "zero".
QUERY_CASES = {
    "nearest": ("dragon2000", 1, 2048, None, False),
    "anyhit": ("dragon2000", 2, 2048, "uniform", True),
    "inactive": ("dragon2000", 3, 1024, "zero", True),
    "mixed_cull": ("mixed_cull", 7, 1024, None, False),
}


def query_inputs(case: str):
    scene_name, seed, n, limit, any_hit = QUERY_CASES[case]
    o, d = query_rays(n, seed)
    lim = None
    if limit == "uniform":
        lim = np.random.default_rng(seed + 100).uniform(0.05, 1.5, n).astype(np.float32)
    elif limit == "zero":
        lim = np.zeros(n, np.float32)
    return scene_name, o, d, lim, any_hit


def query_scene(name: str, pkg: str):
    return mixed_cull_scene(pkg) if name == "mixed_cull" else dragon_scene(pkg, 2000)


def jax_cluster_query(case: str):
    """JAX cluster_intersect_kernel (interpret mode) on a QUERY_CASES case:
    (t [n] f32, prim [n] i32)."""
    from cpupathtrace_tpu.accel.kernel_traverse import cluster_intersect_kernel

    name, o, d, lim, any_hit = query_inputs(case)
    t, p = cluster_intersect_kernel(query_scene(name, "jax"), o, d, t_max=lim,
                                    any_hit=any_hit, interpret=True)
    return np.asarray(t), np.asarray(p)


def sorted_rays(n: int = SORTED_RAYS, seed: int = 0):
    """Rays into the dragon from just inside the box's front wall."""
    rng = np.random.default_rng(seed)
    o = np.zeros((n, 3), np.float32)
    o[:, 2] = -0.9
    o[:, :2] = rng.uniform(-0.3, 0.3, (n, 2))
    d = rng.normal(size=(n, 3))
    d[:, 2] = np.abs(d[:, 2]) + 1.0
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    return o, d.astype(np.float32)


def jax_bounce_states(depth: int = SORTED_DEPTH, depths=None):
    """The JAX single-bounce kernel `_bounce_call` (interpret mode) run
    `depth` times (at depths 0, 1, ...; or once at each of `depths` in
    turn) from the fresh state of `sorted_rays` on the 1200-triangle
    dragon, no sorting: [bounces + 1, 18, n] f32 states in the port's
    layout (plane 0 = the rng bits)."""
    import jax
    import jax.numpy as jnp

    from cpupathtrace_tpu.integrator.pallas_megakernel import _pack_tables
    from cpupathtrace_tpu.integrator.sorted_wavefront import _bounce_call, _seed_rng_flat

    scene = dragon_scene("jax")
    o, d = sorted_rays()
    n = o.shape[0]
    tables = _pack_tables(scene) + (
        scene.krn_sup_bounds, scene.krn_hyp_bounds, scene.krn_cl_bounds,
        scene.krn_records, scene.krn_big_pair,
    )
    statics = dict(
        n_tri=int(scene.big_v0.shape[0]), n_sph=int(scene.sph_center.shape[0]),
        n_mat=int(scene.num_materials), n_lights=int(scene.n_point_lights),
        n_em=int(scene.n_emissive), em_k=int(scene.emissive_sample_count),
        epsilon=1e-3, n_super=int(scene.krn_cl_bounds.shape[0]), block_rows=8,
        cull_mode=int(scene.krn_cull_mode), big_cull_mode=int(scene.krn_big_cull_mode),
    )
    ones = jnp.ones(n, jnp.float32)
    zeros = jnp.zeros(n, jnp.float32)
    st = (_seed_rng_flat(jnp.int32(SORTED_SEED), jnp.arange(n, dtype=jnp.int32)),
          *(jnp.asarray(o[:, j]) for j in range(3)), *(jnp.asarray(d[:, j]) for j in range(3)),
          ones, ones, ones, zeros, zeros, zeros, ones, ones, ones, zeros, ones)

    def port_layout(st):
        planes = [np.asarray(a).reshape(-1) for a in st]
        planes[0] = planes[0].astype(np.uint32).view(np.float32)
        return np.stack(planes)

    states = [port_layout(st)]
    with pallas_interpret():
        for k in range(depth) if depths is None else depths:
            st2d = tuple(a.reshape(n // 128, 128) for a in st)
            out = _bounce_call(tables, jnp.stack([jnp.int32(SORTED_SEED), jnp.int32(k)]),
                               st2d, **statics)
            st = tuple(a.reshape(-1) for a in out)
            states.append(port_layout(st))
    jax.block_until_ready(st)
    return np.stack(states)


def jax_sorted_trace(depth: int = SORTED_DEPTH):
    """JAX trace_megakernel_sorted(sort=False), interpret mode, on
    `sorted_rays` and the 1200-triangle dragon: spectrum [n, 4]."""
    import jax.numpy as jnp

    from cpupathtrace_tpu.core.config import RenderOptions
    from cpupathtrace_tpu.core.rays import Rays
    from cpupathtrace_tpu.integrator.sorted_wavefront import trace_megakernel_sorted

    o, d = sorted_rays()
    with pallas_interpret():
        spec, _ = trace_megakernel_sorted(
            dragon_scene("jax"), Rays(jnp.asarray(o), jnp.asarray(d)),
            RenderOptions(8, 8, 1, 1, max_depth=depth), SORTED_SEED, sort=False,
        )
    return np.asarray(spec)


# K1's binned while-loop form (tests/test_megakernel.py:143's scene): rays
# into the 1200-triangle dragon, half a JAX ray block of 8 x 128 lanes.
MEGA_BINNED_RAYS = 512
MEGA_BINNED_SEED = 4321
MEGA_BINNED_DEPTH = 4
# The box through the sorted driver (its dense form).
SORTED_BOX_SEED = 99


def mega_binned_rays():
    return sorted_rays(MEGA_BINNED_RAYS, seed=5)


def jax_megakernel_binned(tris: int = 1200):
    """JAX trace_megakernel (interpret mode) in its binned while-loop form
    (n_super > 0, 8-row blocks) on `mega_binned_rays` and the
    `tris`-triangle dragon: spectrum [n, 4]."""
    import jax.numpy as jnp

    from cpupathtrace_tpu.core.config import RenderOptions
    from cpupathtrace_tpu.core.rays import Rays
    from cpupathtrace_tpu.integrator.pallas_megakernel import trace_megakernel

    o, d = mega_binned_rays()
    with pallas_interpret():
        spec, _ = trace_megakernel(
            dragon_scene("jax", tris), Rays(jnp.asarray(o), jnp.asarray(d)),
            RenderOptions(8, 8, 1, 1, max_depth=MEGA_BINNED_DEPTH), MEGA_BINNED_SEED,
        )
    return np.asarray(spec)


def jax_sorted_box_trace():
    """JAX trace_megakernel_sorted (interpret mode, the sort on) on the box,
    a dense scene (n_super = 0), with make_rays("sphere_dirs", 1024) and
    max_depth SORTED_DEPTH: spectrum [n, 4]."""
    import jax.numpy as jnp

    from cpupathtrace_tpu.core.config import RenderOptions
    from cpupathtrace_tpu.core.rays import Rays
    from cpupathtrace_tpu.integrator.sorted_wavefront import trace_megakernel_sorted

    o, d = make_rays("sphere_dirs", SORTED_RAYS)
    with pallas_interpret():
        spec, _ = trace_megakernel_sorted(
            build_scene("bench_box", "jax"), Rays(jnp.asarray(o), jnp.asarray(d)),
            RenderOptions(8, 8, 1, 1, max_depth=SORTED_DEPTH), SORTED_BOX_SEED,
        )
    return np.asarray(spec)


def f64_oracle(records, o, d, t_lim):
    """float64 nearest hit over every live row of the port's records
    [C, L, 32] (tests/test_kernel_traverse.py's oracle): (t, prim), -1 on
    a miss; hits count only below t_lim."""
    rec = np.asarray(records, np.float64)
    prim = rec[..., 17].reshape(-1)
    live = prim >= 0
    f = rec.reshape(-1, rec.shape[-1])[live]
    prim = prim[live]
    o = o.astype(np.float64)
    d = d.astype(np.float64)
    m = np.cross(o, d)
    det = d @ f[:, 0:3].T
    un = m @ f[:, 3:6].T + d @ f[:, 6:9].T
    vn = m @ f[:, 9:12].T + d @ f[:, 12:15].T
    tn = -(o @ f[:, 0:3].T) - f[None, :, 15]
    sgn = np.where(det >= 0, 1.0, -1.0)
    sd, su, sv, st = det * sgn, un * sgn, vn * sgn, tn * sgn
    ok = ((np.minimum(np.minimum(su, sv), sd - su - sv) >= 0) & (st >= 0) & (sd > 1e-6)
          & ((f[None, :, 16] < 0.5) | (det > 0)))
    tv = np.where(ok, st / np.where(ok, sd, 1.0), np.inf)
    tv = np.where(tv < t_lim[:, None], tv, np.inf)
    best = tv.min(axis=1)
    hit = np.isfinite(best)
    return np.where(hit, best, -1.0), np.where(hit, prim[tv.argmin(axis=1)], -1).astype(np.int32)


# ---------------------------------------------------------------------------
# Gradients: the record-and-replay forward (K2's record form).
# ---------------------------------------------------------------------------

DIFF_RAYS = 1024  # one block of the JAX single-bounce kernel (8 x 128 rays)
DIFF_SEED = 1234
DIFF_DEPTH = 4
# Record cases: name -> scene of build_scene. "box" is the pair-record
# form with two emitters; "specular_point_light" adds a point light and
# the mirror / glass chain codes.
DIFF_CASES = ("bench_box", "specular_point_light")


def jax_diff_records(scene_name: str):
    """JAX trace_megakernel_diff (interpret mode) on `DIFF_RAYS` rays of
    make_rays("sphere_dirs"), max_depth DIFF_DEPTH: (spectrum [n, 4],
    records [D, n, n_drec], replay_spectrum [n, 3], replay_fast [n, 3])."""
    import jax.numpy as jnp

    from cpupathtrace_tpu.core.config import RenderOptions
    from cpupathtrace_tpu.core.rays import Rays
    from cpupathtrace_tpu.integrator.diff_megakernel import (
        DIFF_FIELDS,
        em_material_ids,
        preprocess_records,
        replay_fast,
        replay_spectrum,
        trace_megakernel_diff,
    )

    scene = build_scene(scene_name, "jax")
    o, d = make_rays("sphere_dirs", DIFF_RAYS)
    with pallas_interpret():
        spec, _, recs = trace_megakernel_diff(
            scene, Rays(jnp.asarray(o), jnp.asarray(d)),
            RenderOptions(8, 8, 1, 1, max_depth=DIFF_DEPTH), DIFF_SEED,
        )
    mats = {f: getattr(scene, f) for f in DIFF_FIELDS}
    args = (em_material_ids(scene), scene.light_spectrum[:, :3])
    nl, k = int(scene.n_point_lights), int(scene.emissive_sample_count)
    ref = replay_spectrum(mats, recs, *args, nl, k)
    fast = replay_fast(mats, preprocess_records(recs, *args, int(scene.num_materials), nl, k))
    return tuple(np.asarray(x) for x in (spec, recs, ref, fast))


def jax_trace_draws(key, n: int, em_k: int, depth: int) -> list:
    """The uniforms JAX `trace` draws from `key` over `depth` bounces
    (wavefront.py:90, lights.py:55), in the order the port's trace asks
    for them: per bounce u_rt [n], u_nee [n, K, 3] (K > 0), u_prop [n, 3]."""
    import jax

    out = []
    for _ in range(depth):
        key, k_rt, k_nee, k_prop = jax.random.split(key, 4)
        out.append(np.asarray(jax.random.uniform(k_rt, (n,))))
        if em_k > 0:
            out.append(np.asarray(jax.random.uniform(k_nee, (n, em_k, 3))))
        out.append(np.asarray(jax.random.uniform(k_prop, (n, 3))))
    return out


def jax_render_draws(key, n: int, em_k: int, depth: int) -> list:
    """The uniforms of one JAX render_chunk(differentiable=True) of n rays
    from `key` (film.py:161, camera.py's jitter, then the trace), in the
    port's order. The jitter is handed over as U[0, 1) draws: the port
    subtracts 0.5, which is JAX's uniform(minval=-0.5, maxval=0.5)
    (floats * 1.0 - 0.5) bit for bit."""
    import jax

    k_cam, k_trace = jax.random.split(key)
    k_jit, _ = jax.random.split(k_cam)
    return ([np.asarray(jax.random.uniform(k_jit, (n, 2)))]
            + jax_trace_draws(k_trace, n, em_k, depth))


# ---------------------------------------------------------------------------
# The binned wavefront (K6, K7) and the other intersectors of the wavefront.
# ---------------------------------------------------------------------------

BINNED_TRIS = 1500  # tests/test_traverse.py:28's dragon, clusters of 64
BINNED_CLUSTER = 64
CAND_BLOCK = 1024  # one TPU candidate-kernel block (8 x 128 rays)
# Pipeline cases: name -> (rays, seed, inside, m, batch, limit, live,
# any_hit), tests/test_traverse.py's inputs.
BINNED_CASES = {
    "nearest_m4": (768, 1, False, 4, 1024, False, False, False),
    "nearest_m1_inside": (768, 1, True, 1, 1024, False, False, False),
    "anyhit_tmax": (768, 2, True, 4, 1024, True, False, True),
    "live": (768, 4, True, 4, 1024, False, True, False),
    "batches": (3072, 6, False, 4, 1024, False, False, False),
}
# Wavefront trace cases: name -> (scene, emitter NEE).
TRACE_CASES = {
    "binned": ("binned", True),
    "binned_no_em": ("binned", False),
    "sweep": ("sweep", True),
    "sweep_no_em": ("sweep", False),
}
TRACE_RAYS = 1024
TRACE_DEPTH = 4


def binned_dragon(pkg: str, accel: str = "binned"):
    """The 1500-triangle dragon with clusters of 64, built binned (or with
    another accelerator) by either package."""
    if pkg == "jax":
        from cpupathtrace_tpu.models.scenes import bench_dragon_scene

        return bench_dragon_scene(dragon_tris=BINNED_TRIS, accel=accel,
                                  cluster_size=BINNED_CLUSTER)
    from cpupathtrace_tpu_torch.models.scenes import bench_dragon_scene

    return bench_dragon_scene(dragon_tris=BINNED_TRIS, accel=accel, cluster_size=BINNED_CLUSTER,
                              device=CPU)


def binned_rays(n: int, seed: int, inside: bool = False):
    """tests/test_traverse.py's rays: half from the front aimed at the
    dragon and half uniform, or (inside) from inside the dragon's region,
    where entries tie at 0."""
    rng = np.random.default_rng(seed)
    if inside:
        o = rng.uniform(-0.3, 0.3, (n, 3)).astype(np.float32)
        o[:, 1] -= 0.5
        d = rng.normal(size=(n, 3))
    else:
        o = rng.uniform(-0.9, 0.9, (n, 3)).astype(np.float32)
        o[: n // 2, 2] = -2.8
        tgt = rng.uniform(-0.4, 0.4, (n, 3)).astype(np.float32)
        tgt[:, 1] -= 0.5
        d = tgt - o
        d[n // 2:] = rng.normal(size=(n - n // 2, 3))
    d = (d / np.linalg.norm(d, axis=1, keepdims=True)).astype(np.float32)
    return o, d


def binned_case_inputs(case: str):
    """(o, d, t_max or None, live or None, m, batch, any_hit) of a case."""
    n, seed, inside, m, batch, limit, live, any_hit = BINNED_CASES[case]
    o, d = binned_rays(n, seed, inside)
    tm = np.random.default_rng(seed + 1).uniform(0.05, 1.5, n).astype(np.float32) if limit else None
    lv = np.random.default_rng(seed + 1).random(n) < 0.5 if live else None
    return o, d, tm, lv, m, batch, any_hit


def jax_cand_inputs(scene, inside: bool, m: int):
    """K6's inputs for the JAX kernel and the port: round 1 of CAND_BLOCK
    rays (bound = the dense part's hit, no lower bound), and round 2 (the
    lower bound advanced past round 1's last valid slot at m slots), as
    [9, n] f32 planes; with JAX's outputs of both rounds."""
    import jax.numpy as jnp

    from cpupathtrace_tpu.accel import pallas_traverse as jpt

    o, d = binned_rays(CAND_BLOCK, 9, inside)
    t0, _ = jpt._dense_part(scene, jnp.asarray(o), jnp.asarray(d))
    n = o.shape[0]
    c = scene.trv_bounds.shape[0]
    out = {}
    lo_t = np.full(n, -np.inf, np.float32)
    lo_i = np.full(n, -np.inf, np.float32)
    for rnd in (1, 2):
        rows = np.stack([o[:, 0], o[:, 1], o[:, 2], d[:, 0], d[:, 1], d[:, 2],
                         np.asarray(t0), lo_t, lo_i]).astype(np.float32)
        rays4 = jpt._pack_rays4(jnp.asarray(o), jnp.asarray(d), jnp.asarray(rows[6]),
                                jnp.asarray(lo_t), jnp.asarray(lo_i))
        ids4, ent4 = jpt._cand_call(scene.trv_bounds, rays4, n_clusters=c, m=m, interpret=True)
        ids = np.asarray(ids4).transpose(1, 0, 2, 3).reshape(jpt._M_ROWS, n)
        ent = np.asarray(ent4).transpose(1, 0, 2, 3).reshape(jpt._M_ROWS, n)
        out[f"round{rnd}"] = (rows, ids, ent)
        valid = ids[:m] >= 0
        last = np.maximum(valid.sum(0) - 1, 0)
        lo_t = np.where(valid[0], ent[last, np.arange(n)], np.inf).astype(np.float32)
        lo_i = np.where(valid[0], ids[last, np.arange(n)].astype(np.float32),
                        np.inf).astype(np.float32)
    return out


def jax_isect_pairs(scene, ids, rows, m: int):
    """K7 on the pairs of K6's first m slots: the compact binned layout the
    port takes (pair rays [6, P] ordered by cluster, offs [C+1]) and JAX
    `_isect_call`'s per-pair (t, prim) in that order, from its 128-aligned
    layout."""
    import jax.numpy as jnp

    from cpupathtrace_tpu.accel import pallas_traverse as jpt

    n = rows.shape[1]
    c = scene.trv_bounds.shape[0]
    flat = ids[:m].reshape(-1)
    key = np.where(flat >= 0, flat, c)
    order = np.argsort(key, kind="stable")
    counts = np.bincount(key, minlength=c + 1)[:c]
    offs = np.concatenate([[0], np.cumsum(counts)]).astype(np.int32)
    pairs = rows[:6, order % n][:, : offs[-1]]
    aligned = -(-counts // 128) * 128
    offs_al = np.concatenate([[0], np.cumsum(aligned)[:-1]]).astype(np.int32)
    total = int(aligned.sum()) + jpt._GROUP
    rays_t = np.zeros((8, total), np.float32)
    rays_t[5] = 1.0
    pos = np.concatenate([offs_al[k] + np.arange(counts[k]) for k in range(c)]).astype(np.int64)
    rays_t[:6, pos] = pairs
    t, p = jpt._isect_call(jnp.asarray(offs_al), jnp.asarray(counts.astype(np.int32)),
                           scene.trv_blocks, jnp.asarray(rays_t),
                           n_tiles=scene.trv_blocks.shape[1], interpret=True)
    return pairs, offs, np.asarray(t)[0, pos], np.asarray(p)[0, pos]


def trace_scene(case: str, pkg: str):
    """The scene of a TRACE_CASES case (emissive_sample_count 0 without
    emitter NEE)."""
    accel, em = TRACE_CASES[case]
    scene = binned_dragon(pkg, accel)
    return scene if em else dataclasses.replace(scene, emissive_sample_count=0)


def jax_wavefront_trace(case: str, grads: bool = False):
    """JAX `trace` (the jnp wavefront; off the TPU its binned intersector is
    binned_intersect_ref) on sorted_rays(TRACE_RAYS), max_depth
    TRACE_DEPTH, key PRNGKey(5): (spectrum [n, 4], collected [n]), and with
    `grads` the gradients of the mean radiance with respect to mat_diffuse
    and mat_emission through its differentiable form."""
    import jax
    import jax.numpy as jnp

    from cpupathtrace_tpu.core.config import RenderOptions
    from cpupathtrace_tpu.core.rays import Rays
    from cpupathtrace_tpu.integrator.wavefront import trace

    scene = trace_scene(case, "jax")
    o, d = sorted_rays(TRACE_RAYS)
    rays = Rays(jnp.asarray(o), jnp.asarray(d))
    opts = RenderOptions(8, 8, 1, 1, max_depth=TRACE_DEPTH)
    key = jax.random.PRNGKey(5)
    if not grads:
        spec, coll = trace(scene, rays, opts, key, False)
        return np.asarray(spec), np.asarray(coll)

    def mean_radiance(mats):
        spec, _ = trace(dataclasses.replace(scene, **mats), rays, opts, key, True)
        return spec[:, :3].mean()

    mats = {f: scene.__getattribute__(f) for f in ("mat_diffuse", "mat_emission")}
    g = jax.grad(mean_radiance)(mats)
    return {f: np.asarray(v) for f, v in g.items()}


# ---------------------------------------------------------------------------
# The TPU microbenchmarks (benchmarks/experiments/), for their CUDA ports.
# ---------------------------------------------------------------------------


def load_experiment(name: str) -> dict:
    """The namespace of benchmarks/experiments/<name>.py with only its
    imports, constant assignments and function definitions executed: the
    scripts run their sweeps (top-level loops and calls) when imported, so
    the tests never import them."""
    import ast
    import os

    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    path = os.path.join(root, "benchmarks", "experiments", f"{name}.py")
    with open(path) as f:
        tree = ast.parse(f.read(), path)
    keep, defined = [], set()
    for node in tree.body:
        if isinstance(node, (ast.Import, ast.ImportFrom)):
            defined |= {(a.asname or a.name).split(".")[0] for a in node.names}
        elif isinstance(node, ast.FunctionDef):
            defined.add(node.name)
        elif isinstance(node, ast.Assign) and all(
                not isinstance(n, (ast.Call, ast.ListComp))
                and not (isinstance(n, ast.Name) and n.id not in defined)
                for n in ast.walk(node.value)):
            # A constant, or names of what is already defined (no call).
            defined |= {n.id for t in node.targets for n in ast.walk(t) if isinstance(n, ast.Name)}
        else:
            continue
        keep.append(node)
    ns = {"__name__": f"experiment_{name}"}
    exec(compile(ast.Module(body=keep, type_ignores=[]), path, "exec"), ns)  # noqa: S102
    return ns


# ---------------------------------------------------------------------------
# The ablation switches (PTX_ABLATE, PTX_SKIP_TRAVERSE).
# ---------------------------------------------------------------------------

# Setting -> (PTX_ABLATE, PTX_SKIP_TRAVERSE): the JAX package reads both at
# import, so each setting's JAX outputs come from a process of its own
# (tests/fixtures/make_torch_ablate_fixtures.py).
ABLATE_SETTINGS = {
    "nee": ("nee", ""),
    "bigpair": ("bigpair", ""),
    "prop": ("prop", ""),
    "mat": ("mat", ""),
    "skip": ("", "1"),
    "nee_skip": ("nee", "1"),
}
# Which outputs each setting is held on: the box through K1 dense, the
# ABLATE_TRIS-triangle dragon through K1's binned form, single bounces of
# K2 on the 1200-triangle dragon at ABLATE_BOUNCE_DEPTHS.
ABLATE_CASES = {
    "box": ("nee", "bigpair", "prop", "mat"),
    "dragon": ("nee", "skip", "nee_skip"),
    "bounce": ("nee", "prop"),
}
ABLATE_TRIS = 3000
ABLATE_BOUNCE_DEPTHS = (0, 5)


def ablation_values(setting):
    """(_ABLATE, _SKIP_TRAVERSE) of `setting` as the modules read them at
    import; None: no switch."""
    ablate, skip = ABLATE_SETTINGS[setting] if setting else ("", "")
    return frozenset(x for x in ablate.split(",") if x), skip == "1"


# ---------------------------------------------------------------------------
# The sharded paths (cpupathtrace_tpu_torch/parallel/): the bodies of the
# gloo ranks that tests/test_torch_parallel.py, test_torch_geometry_parallel.py
# and test_torch_failover.py spawn (parallel.distributed.spawn_ranks). They
# import the port only, so a rank starts without JAX.
# ---------------------------------------------------------------------------

# (width, height, min spp, max spp, max_depth)
PAR_FIXED = (16, 13, 4, 4, 6)  # the sharded renders against the serial oracle
PAR_ADAPTIVE = (16, 13, 8, 16, 6)
PAR_SEED = 5
PAR_SHAPES = ((2, 1), (1, 2), (2, 2), (1, 4))
GATHER_H = 13  # an odd height, gathered over 2 and 3 ranks
TRAIN_OPTS = (8, 8, 4, 4, 4)
TRAIN_KEY, TRAIN_SPP, TRAIN_LR = 7, 4, 0.5
GP_RAYS = 512
GP_OPTS = (12, 12, 4, 4, 6)
GP_SEED = 3


def par_options(t):
    from cpupathtrace_tpu_torch import RenderOptions

    w, h, lo, hi, depth = t
    return RenderOptions(w, h, lo, hi, epsilon=1e-3, max_depth=depth)


def par_box():
    from cpupathtrace_tpu_torch.models.scenes import bench_box_scene, bench_camera

    return bench_box_scene(device=CPU), bench_camera(device=CPU)


def inverse_setup():
    """The inverse-rendering example's scene (white box, red wall,
    emissive panel) at TRAIN_OPTS, its target image [P, 4] (a 32-spp
    render of the true materials, the same in every process) and the
    perturbed start (the red wall's diffuse grey)."""
    import cpupathtrace_tpu_torch as pt
    from cpupathtrace_tpu_torch.diff.render import get_material_params
    from cpupathtrace_tpu_torch.parallel.render import render_chunk_serial
    from cpupathtrace_tpu_torch.parallel.train import pixel_grid
    from cpupathtrace_tpu_torch.scene.geometry import make_plane

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
    scene = b.build(device=CPU)
    cam = pt.make_camera((0, 0, 0), (0, 0, 0.9), (0, 1, 0), 1.0, 1.0, 1.0, device=CPU)
    opts = par_options(TRAIN_OPTS)
    x, y = pixel_grid(opts, 1, device=CPU)
    s, c = render_chunk_serial(scene, cam, opts, (1, 1), x, y, 99, 32)
    target = s / c.clamp_min(1)[:, None]
    init = {k: v.clone() for k, v in get_material_params(scene).items()}
    init["mat_diffuse"][red] = torch.tensor([0.5, 0.5, 0.5, 1.0])
    return scene, cam, opts, target, init


def _errors(calls):
    out = {}
    for name, fn in calls.items():
        try:
            fn()
            out[name] = None
        except ValueError as e:
            out[name] = str(e)
    return out


def parallel_ranks(rank, world, fixed_opts, adaptive_opts, frames):
    """One rank of a world of 4: the box at every shape of PAR_SHAPES and
    adaptive at (2, 1), `frames` frames at `fixed_opts` and
    `adaptive_opts` for the statistics, the divisibility errors,
    gather_image over 2 and 3 ranks, and the training step at (1, 2) and
    (2, 1)."""
    import torch.distributed as dist

    from cpupathtrace_tpu_torch.parallel import distributed as pd
    from cpupathtrace_tpu_torch.parallel import render as pr
    from cpupathtrace_tpu_torch.parallel import train as ptr
    from cpupathtrace_tpu_torch.parallel.mesh import make_render_mesh

    from cpupathtrace_tpu_torch.integrator.megakernel import trace_megakernel_reference

    box, cam = par_box()
    out = {"fixed": {}, "k1_twin_calls": {}}
    meshes = {s: make_render_mesh(None if s[0] * s[1] == world else [0, 1], s[1], CPU)
              for s in PAR_SHAPES}
    for shape, m in meshes.items():
        if m.get_coordinate() is not None:
            trace_megakernel_reference.calls = 0
            out["fixed"][shape] = pr.render_sharded(box, cam, par_options(PAR_FIXED), m,
                                                    seed=PAR_SEED)
            out["k1_twin_calls"][shape] = trace_megakernel_reference.calls
    if rank < 2:
        out["adaptive"] = pr.render_sharded_adaptive(box, cam, par_options(PAR_ADAPTIVE),
                                                     meshes[(2, 1)], seed=3)
    fo, ao = par_options(fixed_opts), par_options(adaptive_opts)
    am = make_render_mesh(None, pr.adaptive_sample_axis(ao, world), CPU)
    out["stat_mesh"] = (tuple(meshes[(2, 2)].shape), tuple(am.shape))
    out["stat_fixed"] = np.stack([pr.render_sharded(box, cam, fo, meshes[(2, 2)], seed=s)
                                  for s in range(frames)])
    out["stat_adaptive"] = np.stack([pr.render_sharded_adaptive(box, cam, ao, am, seed=s)
                                     for s in range(frames)])

    m22 = meshes[(2, 2)]
    x, y = ptr.pixel_grid(fo, 2, device=CPU)
    out["errors"] = _errors({
        "pixels": lambda: pr.render_chunk_sharded(box, cam, fo, m22, x[:-1], y[:-1], 0, 4),
        "spp": lambda: pr.render_chunk_sharded(box, cam, fo, m22, x, y, 0, 3),
        "stats": lambda: pr.render_chunk_batched_sharded(box, cam, fo, m22, x, y, 0, 3, 2),
        "adaptive": lambda: pr.render_sharded_adaptive(box, cam, par_options((16, 13, 4, 8, 6)),
                                                       m22),
    })

    rows = np.arange(GATHER_H * 5 * 4, dtype=np.float32).reshape(GATHER_H, 5, 4) + 0.5
    out["gather"] = {}
    for p in (2, 3):
        group = dist.new_group(list(range(p)))
        if rank < p:
            lo, hi = pd.host_local_rows(GATHER_H, rank, p)
            out["gather"][p] = (
                (lo, hi), pd.gather_image(torch.from_numpy(rows[lo:hi]), GATHER_H, group).numpy(),
                pd.gather_image(rows[lo:hi], GATHER_H, group))

    if rank < 2:
        scene, icam, opts, target, init = inverse_setup()
        out["train"] = {}
        for shape in ((1, 2), (2, 1)):
            xs, ys = ptr.pixel_grid(opts, shape[0], device=CPU)
            loss, grads = ptr.sharded_loss_and_grad(init, scene, icam, opts, meshes[shape],
                                                    target, xs, ys, TRAIN_KEY, TRAIN_SPP)
            out["train"][shape] = (float(loss), {k: v.numpy() for k, v in grads.items()})
        m12 = meshes[(1, 2)]
        xs, ys = ptr.pixel_grid(opts, 1, device=CPU)
        params, losses = init, []
        for _ in range(3):
            params, loss = ptr.train_step_sharded(params, scene, icam, opts, m12, target, xs,
                                                  ys, TRAIN_KEY, TRAIN_SPP, lr=TRAIN_LR)
            losses.append(float(loss))
        losses.append(float(ptr.sharded_image_loss(params, scene, icam, opts, m12, target, xs,
                                                   ys, TRAIN_KEY, TRAIN_SPP).detach()))
        out["steps"] = (losses, min(float(v.min()) for v in params.values()))
    return out


def gp_rays(n=GP_RAYS, seed=0):
    """JAX's tests/test_geometry_parallel.py rays: origins inside the box,
    uniform directions."""
    rng = np.random.default_rng(seed)
    o = rng.uniform(-0.9, 0.9, (n, 3)).astype(np.float32)
    d = rng.normal(size=(n, 3)).astype(np.float32)
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    return o, d


def gp_combine_inputs(shards=4, n=96, seed=11):
    """Per-shard (t [shards, n] f32, prim [shards, n] i32): hits, misses
    (-1, -1), rays every shard misses, and rays whose least t two shards
    share with different prims."""
    rng = np.random.default_rng(seed)
    t = rng.uniform(0.1, 4.0, (shards, n)).astype(np.float32)
    p = rng.integers(0, 5000, (shards, n)).astype(np.int32)
    miss = rng.random((shards, n)) < 0.3
    miss[:, :8] = True  # every shard misses
    t[:, 8:24] = 0.05  # a tie on the least t ...
    p[:, 8:24] = rng.integers(0, 5000, (shards, 16))  # ... with different prims
    miss[:, 8:24] = False
    miss[0, 8:16] = True  # ties among the other shards only
    t = np.where(miss, -1.0, t).astype(np.float32)
    p = np.where(miss, -1, p).astype(np.int32)
    return t, p


def gp_ranks(rank, world):
    """One rank of a world of 4: the gp query (nearest, any-hit with
    t_max) of both paths at 4 and 2 shards, the gp renders at 2 shards and
    (rank 0) at 1, and gp_combine on gp_combine_inputs."""
    from cpupathtrace_tpu_torch.models.scenes import bench_camera, bench_dragon_scene
    from cpupathtrace_tpu_torch.ops.intersect import gp_combine, scene_intersect
    from cpupathtrace_tpu_torch.parallel import geometry as pg

    o, d = (torch.from_numpy(a) for a in gp_rays())
    lim = torch.full((GP_RAYS,), 1.2)
    meshes = {n: pg.make_gp_mesh(list(range(n)), device_type=CPU) for n in (4, 2, 1)}
    cam = bench_camera(device=CPU)
    out = {}
    for path, accel, prep in (("sweep", "sweep", pg.shard_scene_geometry),
                              ("krn", "binned", pg.shard_scene_kernel_geometry)):
        scene = bench_dragon_scene(dragon_tris=2000, accel=accel, device=CPU)
        for n in (4, 2):
            if rank < n:
                sh = pg.local_shard(prep(scene, n), meshes[n])
                near = scene_intersect(sh, o, d)
                occ = scene_intersect(sh, o, d, t_max=lim, any_hit=True)
                out[path, n] = [a.numpy() for a in near + occ]
        for n in (2, 1):
            if rank < n:
                out[path, "img", n] = pg.render_gp(prep(scene, n), cam, par_options(GP_OPTS),
                                                   meshes[n], seed=GP_SEED)
    t, p = gp_combine_inputs()
    ct, cp = gp_combine(torch.from_numpy(t[rank]), torch.from_numpy(p[rank]).long(),
                        meshes[4].get_group("gp"))
    out["combine"] = (ct.numpy(), cp.numpy())
    return out


def failover_ranks(rank, world, tmp):
    """One rank of a world of 2 (tests/test_checkpoint.py:80-162 with ranks
    for meshes): a sharded resume, the divisibility error, a healthy ping,
    then the elastic failover in which rank 1 loses its device after chunk
    2 (last: rank 1 then leaves)."""
    import os

    from cpupathtrace_tpu_torch.integrator.checkpoint import render_resumable
    from cpupathtrace_tpu_torch.models import golden
    from cpupathtrace_tpu_torch.parallel import failover as pf
    from cpupathtrace_tpu_torch.parallel import render as pr
    from cpupathtrace_tpu_torch.parallel.mesh import make_render_mesh
    import cpupathtrace_tpu_torch as pt

    scene = golden.inward_box_scene(device=CPU)
    cam = pt.make_camera(origin=(0, 0, 0), look_at=(0, 0, 0.9), up=(0, 1, 0), device=CPU)
    opts = pt.RenderOptions(8, 8, 16, 16, max_depth=6)
    mesh = make_render_mesh([0, 1], sample_axis=2, device_type=CPU)
    out = {}
    full = render_resumable(scene, cam, opts, spp=12, seed=3, spp_chunk=4, mesh=mesh)
    ck = os.path.join(tmp, "sharded.ckpt")

    class Interrupt(Exception):
        pass

    def bomb(done, total):
        if done == 1:
            raise Interrupt

    try:
        render_resumable(scene, cam, opts, spp=12, seed=3, spp_chunk=4, checkpoint_path=ck,
                         progress_callback=bomb, mesh=mesh)
        out["interrupted"] = False
    except Interrupt:
        out["interrupted"] = True
    resumed = render_resumable(scene, cam, opts, spp=12, seed=3, spp_chunk=4,
                               checkpoint_path=ck, mesh=mesh)
    out["resume"] = (full.pixel_sum, full.sample_count, resumed.pixel_sum,
                     resumed.sample_count, resumed.chunks_done)
    out["bad_chunk"] = _errors({"chunk": lambda: render_resumable(
        scene, cam, opts, spp=9, seed=0, spp_chunk=3, mesh=mesh)})["chunk"]
    out["ping"] = pf.ping_mesh(mesh)

    meshes = [make_render_mesh([0, 1], sample_axis=1, device_type=CPU),
              make_render_mesh([0], device_type=CPU)]
    calls = {"n": 0}
    render_chunk = pr.render_chunk

    def counting(*args, **kw):
        calls["n"] += 1
        return render_chunk(*args, **kw)

    pr.render_chunk = counting
    failovers = []

    def flaky(done, total):
        if rank == 1 and done == 2:
            raise RuntimeError("simulated device loss")

    try:
        st = pf.render_resumable_elastic(
            scene, cam, opts, spp=16, checkpoint_path=os.path.join(tmp, "elastic.ckpt"),
            meshes=meshes, seed=4, spp_chunk=4, progress_callback=flaky,
            on_failover=lambda mi, e: failovers.append((mi, repr(e)[:300])))
        out["elastic"] = ("done", st.chunks_done, st.sample_count, st.image())
    except RuntimeError as e:
        out["elastic"] = ("exhausted", str(e)[:300])
    out["elastic_calls"] = calls["n"]
    out["failovers"] = failovers
    return out


def ping_ranks(rank, world, tmp, timeout_s):
    """A world of 2 in which rank 0 pings a mesh of both and rank 1 never
    joins (it waits for rank 0's flag file)."""
    import os
    import time

    from cpupathtrace_tpu_torch.parallel.failover import ping_mesh
    from cpupathtrace_tpu_torch.parallel.mesh import make_render_mesh

    mesh = make_render_mesh([0, 1], device_type=CPU)
    flag = os.path.join(tmp, "pinged")
    if rank == 0:
        out = ping_mesh(mesh, timeout_s=timeout_s)
        with open(flag, "w") as f:
            f.write("done")
        return out
    end = time.monotonic() + timeout_s + 60
    while not os.path.exists(flag) and time.monotonic() < end:
        time.sleep(0.05)
    return None
