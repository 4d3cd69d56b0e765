"""Geometry-parallel (primitive-sharded) rendering over a 1-D mesh of ranks.

Port of `cpupathtrace_tpu/parallel/geometry.py`. The scene's triangle
clusters are split over the ranks of a mesh named "gp"; every rank traces
the whole wavefront against its own slice, and the per-shard nearest hits
are combined by two all_reduce MINs per query (ops/intersect.py:
`gp_combine`: t the MIN over shards, ties to the smallest prim). Shading
tables, spheres, materials, lights and the estimator's state stay
replicated; the combined (t, prim) is the same on every rank, so the
wavefront stays replicated bounce by bounce.

Two paths, as JAX's:
  * the sweep path (`shard_scene_geometry`): the sweep's cluster tables
    (blk_*) padded to a multiple of the shard count (padding clusters
    carry inverted bounds and prim -1) and cut in contiguous slices; the
    per-shard intersector is the dense-top sweep, exact over any subset;
  * the fast path (`shard_scene_kernel_geometry`): the in-kernel
    traversal tables cut into contiguous supercluster slices, each with its
    own upper tiers rebuilt over the slice (`tiers_from_cluster_bounds`),
    stacked on a leading shard axis; each rank's query is `krn_intersect`,
    K5 on the replicated dense part and K4 on its slice. Padding records
    carry the port's no-prim value (prim -1, N = 0), padding clusters a
    zero bound with valid 0.

`local_shard` gives a rank its slice (only that slice goes to its
device) and the group to combine over. Every gp rank draws the same
sample stream (the seed is not folded by the shard, JAX's :209-212): a
draw that depended on the rank would desync the wavefront silently.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from ..camera.camera import Camera, shoot_rays
from ..core.config import RenderOptions
from ..integrator.wavefront import trace
from ..scene.scene import KRN_FIELDS, SceneData
from .distributed import ensure_world
from .mesh import device_mesh, mesh_device, mesh_ranks
from .render import _image, pixel_coords

# The sweep's cluster tables, cut on their leading (cluster) axis.
SWEEP_SHARD_FIELDS = ("blk_v0", "blk_v1", "blk_v2", "blk_cull", "blk_prim", "blk_lo", "blk_hi")


def make_gp_mesh(ranks=None, axis: str = "gp", device_type: str = "cuda"):
    """A 1-D geometry-parallel mesh named `axis` over `ranks` (None: every
    rank of the world)."""
    ensure_world(device_type)
    ranks = mesh_ranks(ranks)
    return device_mesh(ranks, (len(ranks),), (axis,), device_type)


def shard_scene_geometry(scene: SceneData, n_shards: int) -> SceneData:
    """Host-side prep of the sweep path (JAX's :70-127): pad the cluster
    axis to a multiple of `n_shards` (padding clusters: zero vertices, no
    cull, prim -1, bounds lo +inf / hi -inf, so the slab test misses), drop
    the accelerator tables the sweep never reads (one-node stubs), and set
    accel "sweep" and `gp_shards`."""
    if scene.accel not in ("sweep", "cluster"):
        raise ValueError(
            "geometry-parallel rendering needs every triangle in the cluster tables; build "
            f"the scene with accel='sweep' (got accel={scene.accel!r}, whose big-triangle "
            "partition would be lost)")
    c = scene.blk_lo.shape[0]
    pad = (-c) % n_shards
    dev = scene.device

    def pad0(a, fill):
        if pad == 0:
            return a
        return torch.cat([a, torch.full((pad,) + tuple(a.shape[1:]), fill, dtype=a.dtype,
                                        device=dev)])

    def zeros(*shape, fill=0, dtype=torch.float32):
        return torch.full(shape, fill, dtype=dtype, device=dev)

    i32 = torch.int32
    return dataclasses.replace(
        scene, accel="sweep", gp_shards=n_shards,
        blk_v0=pad0(scene.blk_v0, 0.0), blk_v1=pad0(scene.blk_v1, 0.0),
        blk_v2=pad0(scene.blk_v2, 0.0), blk_cull=pad0(scene.blk_cull, False),
        blk_prim=pad0(scene.blk_prim, -1),
        blk_lo=pad0(scene.blk_lo, float("inf")), blk_hi=pad0(scene.blk_hi, float("-inf")),
        bvh_lo=zeros(1, 3), bvh_hi=zeros(1, 3), bvh_left=zeros(1, fill=-1, dtype=i32),
        bvh_right=zeros(1, fill=-1, dtype=i32), bvh_prim=zeros(1, fill=-1, dtype=i32),
        cl_lo=zeros(1, 3), cl_hi=zeros(1, 3), cl_left=zeros(1, fill=-1, dtype=i32),
        cl_right=zeros(1, fill=-1, dtype=i32), cl_leaf=zeros(1, fill=-1, dtype=i32),
        trv_blocks=zeros(1, *scene.trv_blocks.shape[1:]),
        trv_bounds=zeros(1, *scene.trv_bounds.shape[1:]),
        krn_records=zeros(1, 8, scene.krn_records.shape[-1]),
        krn_cl_bounds=zeros(1, *scene.krn_cl_bounds.shape[1:]),
        krn_sup_bounds=zeros(1, *scene.krn_sup_bounds.shape[1:]),
        krn_hyp_bounds=zeros(8, scene.krn_hyp_bounds.shape[-1]),
        krn_big_pair=zeros(1, 1), krn_cluster_size=0,
    )


def shard_scene_kernel_geometry(scene: SceneData, n_shards: int) -> SceneData:
    """Host-side prep of the fast path (JAX's :143-194): the in-kernel
    tables cut into `n_shards` contiguous slices of S_l = ceil(S / n)
    superclusters, each slice's supercluster pages and hyper bounds
    rebuilt over it, stacked on a leading shard axis (records [n, S_l *
    GROUP, L, REC_COLS], cluster bounds [n, S_l, GROUP, BND_COLS], pages
    [n, Hp, GROUP2, BND_COLS], hyper bounds [n, Hp8, BND_COLS]) on the
    scene's device, `gp_shards` set. Each shard holds 1 / n of the records
    and cluster bounds; the dense part and the shading tables stay
    whole."""
    from ..accel.kernel_traverse import GROUP, tiers_from_cluster_bounds
    from ..accel.pair_record import C_PRIM

    if not scene.has_kernel_records:
        raise ValueError("kernel-geometry sharding needs the in-kernel tables; build the "
                         "scene with accel='binned'")
    if scene.krn_records.ndim == 4:
        raise ValueError("scene is already kernel-geometry sharded")
    clb = scene.krn_cl_bounds.detach().cpu().numpy()
    rec = scene.krn_records.detach().cpu().numpy()
    s = clb.shape[0]
    s_l = -(-s // n_shards)
    pad = s_l * n_shards - s
    if pad:
        clb = np.concatenate([clb, np.zeros((pad,) + clb.shape[1:], clb.dtype)])
        rec_pad = np.zeros((pad * GROUP,) + rec.shape[1:], rec.dtype)
        rec_pad[:, :, C_PRIM] = -1.0  # padding records never hit
        rec = np.concatenate([rec, rec_pad])
    clb_s = clb.reshape(n_shards, s_l, *clb.shape[1:])
    rec_s = rec.reshape(n_shards, s_l * GROUP, *rec.shape[1:])
    sups, hyps = zip(*(tiers_from_cluster_bounds(c) for c in clb_s))
    tables = (rec_s, clb_s, np.stack(sups), np.stack(hyps))
    return dataclasses.replace(
        scene, gp_shards=n_shards,
        **{f: torch.from_numpy(t).to(scene.device) for f, t in zip(KRN_FIELDS, tables)})


def scene_shard(scene: SceneData, index: int, group=None) -> SceneData:
    """Shard `index` of a scene prepared by `shard_scene_geometry` or
    `shard_scene_kernel_geometry` (views, on the prepared scene's device),
    carrying `group` to combine over (None: the shard's local query)."""
    n = scene.gp_shards
    if not n:
        raise ValueError("the scene is not prepared for geometry parallelism; run "
                         "shard_scene_geometry (sweep path) or shard_scene_kernel_geometry "
                         "(fast path) first")
    if not 0 <= index < n:
        raise ValueError(f"shard {index} of {n}")
    if scene.krn_records.ndim == 4:
        cut = {f: getattr(scene, f)[index] for f in KRN_FIELDS}
    else:
        c_l = scene.blk_lo.shape[0] // n
        cut = {f: getattr(scene, f)[index * c_l:(index + 1) * c_l] for f in SWEEP_SHARD_FIELDS}
    return dataclasses.replace(scene, gp_group=group, **cut)


def local_shard(scene: SceneData, mesh, axis: str = "gp") -> SceneData:
    """This rank's shard of a prepared scene on its device, combining over
    the mesh's group."""
    n = mesh.size()
    if scene.gp_shards != n:
        raise ValueError(f"{scene.gp_shards} geometry shards vs mesh axis {n}")
    return scene_shard(scene, mesh.get_local_rank(axis),
                       mesh.get_group(axis)).to(mesh_device(mesh))


def render_chunk_gp(scene: SceneData, camera: Camera, options: RenderOptions, mesh,
                    x_cam: torch.Tensor, y_cam: torch.Tensor, key: int, spp: int,
                    axis: str = "gp"):
    """Geometry-parallel render of P pixels at `spp` samples through the
    wavefront (JAX's :231-266): returns (sum [P, 4], collected [P] int32),
    the same on every rank. `scene` is a prepared scene (this rank's
    slice is taken) or this rank's shard (`local_shard`). Every rank seeds
    its generator with `key` itself."""
    if scene.gp_group is None:
        scene = local_shard(scene, mesh, axis)
    dev = mesh_device(mesh)
    p = x_cam.shape[0]
    gen = torch.Generator(device=dev)
    gen.manual_seed(int(key))
    rays = shoot_rays(camera.to(dev), x_cam.repeat(spp), y_cam.repeat(spp),
                      1.0 / options.image_width, 1.0 / options.image_height, gen)
    spectrum, collected = trace(scene, rays, options, gen)
    spectrum = spectrum.reshape(spp, p, 4)
    collected = collected.reshape(spp, p)
    return (torch.where(collected[..., None], spectrum, 0.0).sum(0),
            collected.sum(0, dtype=torch.int32))


def render_gp(scene: SceneData, camera: Camera, options: RenderOptions, mesh,
              seed: int = 0, spp: int | None = None, axis: str = "gp") -> np.ndarray:
    """Full-frame fixed-spp geometry-parallel render; returns [H, W, 4] on
    every rank. An unprepared scene is prepared for the sweep path first."""
    if not scene.gp_shards and scene.gp_group is None:
        scene = shard_scene_geometry(scene, mesh.size())
    w, h = options.image_width, options.image_height
    spp = spp if spp is not None else options.max_sample_count
    x, y, n = pixel_coords(options, 1, mesh_device(mesh))
    s, c = render_chunk_gp(scene, camera, options, mesh, x, y, seed, spp, axis)
    return _image(s, c, n, h, w)
