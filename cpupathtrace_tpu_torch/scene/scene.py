"""Scene container (torch tensors on one device) and the host-side builder.

Port of `cpupathtrace_tpu/scene/scene.py`: primitive arrays (triangles
0..n_tri-1, spheres n_tri..), the material table, point lights, the
emissive registry + CDF (ref: src/scene/scene.cpp:165-226), the dense pair
record, the two-level cluster structure of the sweep, cluster and binned
intersectors, the per-primitive BVH of the bvh walker, and for binned
scenes the big/small partition, the binned-wavefront tables (K6/K7) and
the in-kernel cluster traversal tiers. Arrays are padded so no shape is
zero-length; padding rows are masked by `tri_valid` / `sph_valid`.

The build is the numpy arithmetic of the JAX builder (scene.py:342-820),
so both packages give equal arrays (tests/test_torch_scene.py,
tests/test_torch_binned_scene.py, tests/test_torch_walkers.py). Two
departures: the per-primitive BVH (`bvh_*`) is built only for
accel="bvh", the one intersector that reads it (the JAX builder builds it
for every scene that is not lean: 396,075 nodes on the 200k dragon), with
a one-node placeholder elsewhere; and the binned-wavefront tables
(`trv_blocks`, `trv_bounds`) are in the port's row-major layout
(accel/traverse.py), not the TPU's tile layout. `lean=True` packs only
the megakernel tables of a binned scene, as the JAX builder does.
"""
from __future__ import annotations

import dataclasses
import os
import time

import numpy as np
import torch

from ..accel.build import build_bvh
from ..accel.cluster import build_cluster_bvh
from ..accel.kernel_traverse import (
    BND_COLS,
    GROUP,
    GROUP2,
    REC_COLS,
    compact_kernel_tables,
    pack_kernel_tables_np,
)
from ..accel.pair_record import cull_uniformity, pack_pair_record_np
from ..core.config import resolve_device
from ..utils.math import PI
from .geometry import HostTriangle, TriangleBatch

# BSDF type codes (ref: include/PathTrace/scene/propagation.h:57-108).
BSDF_LAMBERTIAN = 0
BSDF_GLASS = 1
BSDF_MIRROR = 2

# The defaults of two knobs the build reads as the JAX builder does, per
# build: triangles per in-kernel cluster record (PTX_KRN_CLUSTER, a multiple
# of 8) and the small-partition size above which the in-kernel tables are
# not packed (PTX_KRN_MAX_TRIS).
KRN_CLUSTER = 56
KRN_MAX_TRIS = 2 ** 21

# Seconds of the last build, by stage: "wavefront" (the cluster cut, its
# top tree and the K6/K7 tables), "prim_bvh" (the per-primitive BVH of
# accel="bvh"), "bvh" (the in-kernel cluster cut), "pack" (records and
# tiers), "upload" (tensors to the device). The scene helpers of
# models/scenes.py add "mesh".
BUILD_SECONDS: dict[str, float] = {}

# Fields equal to the JAX SceneData's arrays, byte for byte.
ARRAY_FIELDS = (
    "tri_v0", "tri_v1", "tri_v2", "tri_n0", "tri_n1", "tri_n2",
    "tri_cull", "tri_material", "tri_valid",
    "sph_center", "sph_radius", "sph_material", "sph_valid",
    "mat_diffuse", "mat_specular", "mat_ior", "mat_emission",
    "mat_bsdf", "mat_one_way",
    "light_pos", "light_spectrum",
    "emissive_prim", "emissive_cdf",
    "big_v0", "big_v1", "big_v2", "big_cull", "big_prim",
    "root_lo", "root_hi",
    "krn_big_pair",
)
# The traversal tiers in the port's compact layout (accel/kernel_traverse.py):
# the JAX tables' used columns, byte for byte.
KRN_FIELDS = ("krn_records", "krn_cl_bounds", "krn_sup_bounds", "krn_hyp_bounds")
# The two-level cluster structure (sweep, cluster and binned scenes;
# placeholders otherwise): equal to the JAX SceneData's, byte for byte.
CLUSTER_FIELDS = (
    "cl_lo", "cl_hi", "cl_left", "cl_right", "cl_leaf",
    "blk_v0", "blk_v1", "blk_v2", "blk_cull", "blk_prim", "blk_lo", "blk_hi",
)
# The per-primitive BVH: equal to JAX's for accel="bvh", a one-node
# placeholder for every other accelerator.
BVH_FIELDS = ("bvh_lo", "bvh_hi", "bvh_left", "bvh_right", "bvh_prim")
# The binned-wavefront tables of K6 / K7 in the port's layout
# (accel/traverse.py: pack_blocks, pack_bounds).
TRV_FIELDS = ("trv_blocks", "trv_bounds")
STATIC_FIELDS = (
    "n_tri", "n_sph", "n_point_lights", "n_emissive",
    "emissive_sample_count", "accel", "emissive_all_tri",
    "krn_big_cull_mode", "n_big", "krn_cluster_size", "krn_cull_mode",
    "emissive_in_dense", "cl_depth", "cluster_size", "lean",
)


@dataclasses.dataclass(frozen=True)
class SceneData:
    tri_v0: torch.Tensor  # [T,3] f32
    tri_v1: torch.Tensor
    tri_v2: torch.Tensor
    tri_n0: torch.Tensor  # [T,3] per-vertex shading normals
    tri_n1: torch.Tensor
    tri_n2: torch.Tensor
    tri_cull: torch.Tensor  # [T] bool
    tri_material: torch.Tensor  # [T] i32
    tri_valid: torch.Tensor  # [T] bool
    sph_center: torch.Tensor  # [S,3]
    sph_radius: torch.Tensor  # [S]
    sph_material: torch.Tensor  # [S] i32
    sph_valid: torch.Tensor  # [S] bool
    mat_diffuse: torch.Tensor  # [M,4]
    mat_specular: torch.Tensor  # [M,4]
    mat_ior: torch.Tensor  # [M]
    mat_emission: torch.Tensor  # [M,4]
    mat_bsdf: torch.Tensor  # [M] i32
    mat_one_way: torch.Tensor  # [M] bool
    light_pos: torch.Tensor  # [L,3]
    light_spectrum: torch.Tensor  # [L,4]
    emissive_prim: torch.Tensor  # [E] i32 global prim index
    emissive_cdf: torch.Tensor  # [E] f32 inclusive prefix sums, last == 1
    # Binned partition: "big" triangles (walls, emitters) are tested for
    # every ray through krn_big_pair; the small ones live in the clusters.
    big_v0: torch.Tensor  # [B,3]
    big_v1: torch.Tensor
    big_v2: torch.Tensor
    big_cull: torch.Tensor  # [B] bool
    big_prim: torch.Tensor  # [B] i32 global triangle index, -1 padding
    root_lo: torch.Tensor  # [3] bounds of the small partition
    root_hi: torch.Tensor
    # Pair record [rows <= 128, 128] f32 of the dense triangle set (dense
    # scenes with 1..128 triangles) or of the big partition (binned
    # scenes); [1, 1] when absent.
    krn_big_pair: torch.Tensor
    # Traversal tiers (binned scenes; placeholders otherwise): records
    # [Cp, L, 32], cluster bounds [S, 32, 8], supercluster pages
    # [Hp, 16, 8], hyper bounds [Hp8, 8].
    krn_records: torch.Tensor
    krn_cl_bounds: torch.Tensor
    krn_sup_bounds: torch.Tensor
    krn_hyp_bounds: torch.Tensor
    # Two-level cluster structure (accel/cluster.py; sweep, cluster and
    # binned scenes): the top tree over clusters and the triangle blocks.
    cl_lo: torch.Tensor  # [Nc,3]
    cl_hi: torch.Tensor
    cl_left: torch.Tensor  # [Nc] i32
    cl_right: torch.Tensor
    cl_leaf: torch.Tensor  # [Nc] i32 cluster id on leaves, -1 internal
    blk_v0: torch.Tensor  # [C,L,3]
    blk_v1: torch.Tensor
    blk_v2: torch.Tensor
    blk_cull: torch.Tensor  # [C,L] bool
    blk_prim: torch.Tensor  # [C,L] i32 global prim index, -1 padding
    blk_lo: torch.Tensor  # [C,3] cluster bounds
    blk_hi: torch.Tensor
    # Per-primitive flat BVH (accel="bvh" only; one node elsewhere).
    bvh_lo: torch.Tensor  # [N,3]
    bvh_hi: torch.Tensor
    bvh_left: torch.Tensor  # [N] i32
    bvh_right: torch.Tensor
    bvh_prim: torch.Tensor  # [N] i32 primitive on leaves, -1 internal
    # Binned-wavefront tables (accel/traverse.py; binned scenes that are
    # not lean): blocks [C, L, 16] and bounds [C, 8].
    trv_blocks: torch.Tensor
    trv_bounds: torch.Tensor

    n_tri: int
    n_sph: int
    n_point_lights: int
    n_emissive: int
    emissive_sample_count: int
    accel: str
    emissive_all_tri: bool
    # Cull class of the pair record (accel/pair_record.cull_uniformity).
    krn_big_cull_mode: int = -1
    n_big: int = 0
    krn_cluster_size: int = 0  # 0 = no traversal tiers
    krn_cull_mode: int = -1  # cull class of the cluster records
    # Every emissive primitive lives in the dense tables (binned scenes:
    # the big partition).
    emissive_in_dense: bool = True
    cl_depth: int = 1  # depth of the top tree over clusters
    cluster_size: int = 1  # L, triangles per cluster block
    bvh_depth: int = 1  # depth of the per-primitive BVH
    # Only the megakernel tables were packed (binned scenes, build(lean=True)).
    lean: bool = False

    @property
    def n_prims(self) -> int:
        return self.n_tri + self.n_sph

    @property
    def num_materials(self) -> int:
        return self.mat_diffuse.shape[0]

    @property
    def device(self) -> torch.device:
        return self.tri_v0.device

    @property
    def dense_pair(self) -> bool:
        """True when the dense triangles (all of them, or the big partition
        of a binned scene) ride the pair record (else the triangle table;
        n_tri = 0 scenes)."""
        return self.krn_big_pair.shape[0] > 1

    @property
    def has_kernel_records(self) -> bool:
        """True when the in-kernel cluster traversal tiers are packed
        (binned scenes)."""
        return self.krn_cluster_size > 0

    def to(self, device) -> "SceneData":
        device = torch.device(device)
        if device == self.device:
            return self
        return dataclasses.replace(self, **{f: getattr(self, f).to(device) for f in TENSOR_FIELDS})


TENSOR_FIELDS = ARRAY_FIELDS + KRN_FIELDS + CLUSTER_FIELDS + BVH_FIELDS + TRV_FIELDS


def _placeholder_tiers():
    """Traversal tables of a scene without clusters (compact layout)."""
    return (np.zeros((1, 8, REC_COLS), np.float32), np.zeros((1, GROUP, BND_COLS), np.float32),
            np.zeros((1, GROUP2, BND_COLS), np.float32), np.zeros((8, BND_COLS), np.float32))


def _placeholder_clusters():
    """The cluster fields of a scene without clusters (the JAX builder's)."""
    f32 = np.float32
    z3 = np.zeros((1, 3), f32)
    neg = np.full(1, -1, np.int32)
    return dict(cl_lo=z3, cl_hi=z3, cl_left=neg, cl_right=neg, cl_leaf=neg,
                blk_v0=np.zeros((1, 1, 3), f32), blk_v1=np.zeros((1, 1, 3), f32),
                blk_v2=np.zeros((1, 1, 3), f32), blk_cull=np.zeros((1, 1), bool),
                blk_prim=np.full((1, 1), -1, np.int32), blk_lo=z3, blk_hi=z3)


def _trv_tables(arrays, meta):
    """The K6/K7 tables of a binned scene that is not lean, in the port's
    layout (untiled when they come in the JAX package's tile layout);
    placeholders for any other scene."""
    from ..accel import traverse

    if meta["accel"] != "binned" or meta["lean"]:
        return traverse.placeholder_tables()
    blocks = np.asarray(arrays["trv_blocks"], np.float32)
    if blocks.ndim == 4:
        blocks = traverse.untile_blocks(blocks)
    return blocks, np.asarray(arrays["trv_bounds"], np.float32)


def scene_from_numpy(arrays: dict, meta: dict, device=None) -> SceneData:
    """Carry a scene across from its numpy form: `arrays` maps field names
    to arrays (e.g. the JAX SceneData's fields through np.asarray; extra
    fields are ignored), `meta` its static fields, onto `device` (default:
    the CUDA card). Traversal tables in the JAX package's 128-lane layout
    are compacted, its K6/K7 tile layout untiled."""
    device = resolve_device(device)
    if meta.get("accel") not in ("dense", "bvh", "cluster", "sweep", "binned"):
        raise ValueError(f"unknown accel {meta.get('accel')!r}")
    fields = ARRAY_FIELDS + KRN_FIELDS + CLUSTER_FIELDS + BVH_FIELDS
    missing = [f for f in fields if f not in arrays]
    if missing:
        raise KeyError(f"scene arrays missing {missing}")
    krn = [np.asarray(arrays[f]) for f in KRN_FIELDS]
    if not meta.get("krn_cluster_size", 0):
        krn = _placeholder_tiers()
    elif krn[0].shape[-1] != REC_COLS or krn[1].shape[-1] != BND_COLS:
        krn = compact_kernel_tables(*krn)
    host = {f: np.asarray(arrays[f]) for f in fields}
    host.update(zip(KRN_FIELDS, krn))
    host.update(zip(TRV_FIELDS, _trv_tables(arrays, meta)))
    tensors = {f: torch.from_numpy(np.array(a)).to(device) for f, a in host.items()}
    static = {f: meta[f] for f in STATIC_FIELDS + ("bvh_depth",)}
    return SceneData(**tensors, **static)


@dataclasses.dataclass
class HostSphere:
    center: np.ndarray
    radius: float
    material: int = -1


@dataclasses.dataclass
class Material:
    """Host-side material (ref ConstantMaterial defaults:
    src/scene/material.cpp:3-36)."""

    diffuse: tuple = (1.0, 1.0, 1.0, 1.0)
    specular: tuple = (1.0, 1.0, 1.0, 1.0)
    ior: float = 1.0
    emission: tuple = (0.0, 0.0, 0.0, 0.0)
    bsdf: int = BSDF_LAMBERTIAN
    one_way: bool = False


class SceneBuilder:
    """Assembles primitives, materials and lights on the host, then packs
    them into a SceneData (ref: src/scene/scene.cpp:153-181)."""

    def __init__(self):
        self._batches: list[TriangleBatch] = []
        self._spheres: list[HostSphere] = []
        self._materials: list[Material] = [Material()]  # id 0 = default white
        self._point_lights: list[tuple[np.ndarray, np.ndarray]] = []

    def add_material(self, material: Material | None = None, **kwargs) -> int:
        if material is None:
            material = Material(**kwargs)
        self._materials.append(material)
        return len(self._materials) - 1

    def add_triangles(
        self,
        triangles: list[HostTriangle] | TriangleBatch,
        material: int | None = None,
    ):
        """Append triangles; `material` overrides their material ids, and
        unset ids (-1) fall back to the default white material 0."""
        if isinstance(triangles, TriangleBatch):
            batch = triangles
        else:
            if material is not None:
                for t in triangles:
                    t.material = material
            batch = TriangleBatch.from_triangles(triangles)
        if material is not None:
            batch = dataclasses.replace(
                batch, material=np.full(len(batch), material, np.int32)
            )
        else:
            batch = dataclasses.replace(
                batch, material=np.maximum(batch.material, 0).astype(np.int32)
            )
        self._batches.append(batch)
        return self

    def add_sphere(self, center, radius: float, material: int = 0):
        self._spheres.append(
            HostSphere(np.asarray(center, dtype=np.float64), float(radius), material)
        )
        return self

    def add_point_light(self, pos, spectrum):
        self._point_lights.append(
            (np.asarray(pos, dtype=np.float32), np.asarray(spectrum, dtype=np.float32))
        )
        return self

    def build(
        self,
        dense_threshold: int = 128,
        accel: str | None = None,
        device=None,
        binned_threshold: int = 4096,
        big_diag_frac: float = 0.05,
        lean: bool = False,
        cluster_size: int | None = None,
    ) -> SceneData:
        """Pack the scene onto `device` (default: the CUDA card).

        `accel` selects the intersector of the wavefront: "dense" (every
        ray against every primitive, K5 on the card), "bvh" (the
        per-primitive BVH walk), "cluster" (the walk of the top tree over
        clusters), "sweep" (every cluster box, then the nearest clusters'
        blocks), "binned" (the binned wavefront K6 + K7 and the in-kernel
        cluster traversal of the megakernels). None picks as the JAX
        builder does: dense up to `dense_threshold` primitives, binned from
        `binned_threshold` small triangles, sweep in between.

        `cluster_size`: triangles per cluster block (sweep / cluster: 128 by
        default; binned: sized from the small partition, a multiple of 64,
        grown until the clusters fit MAX_CLUSTERS of accel/traverse.py).
        The per-primitive BVH is built only for accel="bvh".

        `lean=True` (binned scenes only) packs only the megakernel tables:
        the cluster blocks and the K6/K7 tables are placeholders, and the
        build raises when the megakernel cannot serve the scene, as the
        JAX builder's lean checks do. PTX_KRN_MAX_TRIS (default 2^21) is
        the small-partition size from which the in-kernel tables are not
        packed, as in the JAX builder."""
        from ..accel import traverse
        device = resolve_device(device)
        f32 = np.float32
        n_tri = sum(len(b) for b in self._batches)
        n_sph = len(self._spheres)
        tpad = max(n_tri, 1)
        spad = max(n_sph, 1)
        tri_v = np.zeros((3, tpad, 3), f32)
        tri_n = np.zeros((3, tpad, 3), f32)
        tri_n[:, :, 1] = 1.0  # harmless unit normal on padding lanes
        tri_cull = np.zeros(tpad, bool)
        tri_mat = np.zeros(tpad, np.int32)
        off = 0
        for bt in self._batches:
            sl = slice(off, off + len(bt))
            tri_v[0, sl] = bt.v0
            tri_v[1, sl] = bt.v1
            tri_v[2, sl] = bt.v2
            tri_n[0, sl] = bt.n0
            tri_n[1, sl] = bt.n1
            tri_n[2, sl] = bt.n2
            tri_cull[sl] = bt.cull
            tri_mat[sl] = bt.material
            off += len(bt)

        sph_c = np.full((spad, 3), 1e30, f32)
        sph_r = np.zeros(spad, f32)
        sph_mat = np.zeros(spad, np.int32)
        for i, s in enumerate(self._spheres):
            sph_c[i] = s.center
            sph_r[i] = s.radius
            sph_mat[i] = s.material

        n_mat = len(self._materials)
        mat_diffuse = np.zeros((n_mat, 4), f32)
        mat_specular = np.zeros((n_mat, 4), f32)
        mat_ior = np.zeros(n_mat, f32)
        mat_emission = np.zeros((n_mat, 4), f32)
        mat_bsdf = np.zeros(n_mat, np.int32)
        mat_one_way = np.zeros(n_mat, bool)
        for i, m in enumerate(self._materials):
            mat_diffuse[i] = m.diffuse
            mat_specular[i] = m.specular
            mat_ior[i] = m.ior
            mat_emission[i] = m.emission
            mat_bsdf[i] = m.bsdf
            mat_one_way[i] = m.one_way

        lpad = max(len(self._point_lights), 1)
        light_pos = np.zeros((lpad, 3), f32)
        light_spec = np.zeros((lpad, 4), f32)
        for i, (p, s) in enumerate(self._point_lights):
            light_pos[i] = p
            light_spec[i] = s

        # Emissive registry: power = (r+g+b)*a * surface area
        # (ref: src/scene/scene.cpp:183-208), f64 math over f32 vertices.
        mat_em64 = np.array(
            [np.asarray(m.emission, np.float64) for m in self._materials]
        )
        mat_p = (mat_em64[:, 0] + mat_em64[:, 1] + mat_em64[:, 2]) * mat_em64[:, 3]
        tri_p = mat_p[tri_mat[:n_tri]]
        cand = np.flatnonzero(tri_p > 0)
        e1 = (tri_v[1, cand] - tri_v[0, cand]).astype(np.float64)
        e2 = (tri_v[2, cand] - tri_v[0, cand]).astype(np.float64)
        cand_area = 0.5 * np.linalg.norm(np.cross(e1, e2), axis=1)
        cand_power = tri_p[cand] * cand_area
        keep = cand_power > 0
        em_prims: list[int] = [int(i) for i in cand[keep]]
        em_power: list[float] = [float(p) for p in cand_power[keep]]
        for i, s in enumerate(self._spheres):
            p = float(mat_p[s.material])
            if p > 0:
                area = 4.0 * PI * s.radius * s.radius
                if p * area > 0:
                    em_prims.append(n_tri + i)
                    em_power.append(p * area)

        n_emissive = len(em_prims)
        epad = max(n_emissive, 1)
        emissive_prim = np.zeros(epad, np.int32)
        emissive_cdf = np.ones(epad, f32)  # 1 on padding keeps lookups in range
        if n_emissive > 0:
            emissive_prim[:n_emissive] = em_prims
            cdf = np.cumsum(np.asarray(em_power, np.float64))
            cdf /= cdf[-1]
            emissive_cdf[:n_emissive] = cdf.astype(f32)
        # Per-vertex NEE sample count (ref: src/scene/scene.cpp:226).
        emissive_sample_count = min(2 + int(np.log10(n_emissive + 1)), n_emissive)

        # Big/small partition (scene.py:452-481): a triangle whose box
        # diagonal exceeds big_diag_frac of the scene's is tested for every
        # ray; emissive triangles (when few) are forced into that dense
        # part, where the NEE tables resolve them.
        lo_tri = np.minimum(np.minimum(tri_v[0], tri_v[1]), tri_v[2])
        hi_tri = np.maximum(np.maximum(tri_v[0], tri_v[1]), tri_v[2])
        lo_sph = sph_c - sph_r[:, None]
        hi_sph = sph_c + sph_r[:, None]
        n_prims = n_tri + n_sph
        if n_tri > 0:
            tri_diag = np.linalg.norm(hi_tri[:n_tri] - lo_tri[:n_tri], axis=1)
            scene_lo = np.minimum(
                lo_tri[:n_tri].min(axis=0),
                lo_sph[:n_sph].min(axis=0) if n_sph else np.full(3, np.inf),
            )
            scene_hi = np.maximum(
                hi_tri[:n_tri].max(axis=0),
                hi_sph[:n_sph].max(axis=0) if n_sph else np.full(3, -np.inf),
            )
            scene_diag = float(np.linalg.norm(scene_hi - scene_lo))
            big_mask = tri_diag > big_diag_frac * max(scene_diag, 1e-30)
            em_tri = np.asarray([p for p in em_prims if p < n_tri], np.int64)
            if em_tri.size and em_tri.size <= 256:
                big_mask[em_tri] = True
        else:
            big_mask = np.zeros(0, bool)
        n_small = int(n_tri - big_mask.sum())

        # The accelerator rule (scene.py:483-514).
        if accel is None:
            if n_prims <= dense_threshold:
                accel = "dense"
            elif n_small >= binned_threshold:
                accel = "binned"
            else:
                accel = "sweep"
        if accel not in ("dense", "bvh", "cluster", "sweep", "binned"):
            raise ValueError(f"unknown accel {accel!r}")
        if accel == "binned" and n_small < 64:
            accel = "sweep"  # degenerate partition
        if accel in ("cluster", "sweep", "binned") and n_tri == 0:
            accel = "dense" if n_prims <= dense_threshold else "bvh"
        if lean and accel != "binned":
            raise ValueError(
                f"lean build requires the binned accel (got {accel!r}); "
                "small scenes build their full tables in milliseconds"
            )
        # The per-primitive BVH serves only the bvh walker (the JAX builder
        # builds it for every scene that is not lean, scene.py:521-527).
        t0 = time.perf_counter()
        if accel == "bvh" and n_prims > 0:
            prim_lo = np.concatenate([lo_tri[:n_tri], lo_sph[:n_sph]], axis=0)
            prim_hi = np.concatenate([hi_tri[:n_tri], hi_sph[:n_sph]], axis=0)
            bvh = build_bvh(prim_lo, prim_hi)
        else:
            bvh = build_bvh(np.zeros((1, 3), f32), np.zeros((1, 3), f32))
        BUILD_SECONDS["prim_bvh"] = time.perf_counter() - t0

        # The two-level cluster structure (scene.py:533-629): the small
        # partition of a binned scene, every triangle of a sweep or cluster
        # scene.
        t0 = time.perf_counter()
        n_big = 0
        big_idx = np.zeros(0, np.int64)
        small_idx = np.zeros(0, np.int64)
        if accel == "binned":
            small_idx = np.flatnonzero(~big_mask)
            big_idx = np.flatnonzero(big_mask)
            n_big = int(big_idx.shape[0])
            if lean:
                cluster_size = 1  # the cluster cut is skipped below
            elif cluster_size is None:
                # Keep the cluster count in the hundreds (the candidate
                # scan costs ~ clusters, the intersect ~ cluster size), and
                # grow clusters on giant meshes until the cut fits half
                # the bounds budget.
                target = max(small_idx.shape[0] // 700, 128)
                cluster_size = int(min(512, max(128, 1 << int(np.ceil(np.log2(target))))))
                floor = -(-int(small_idx.shape[0]) // (traverse.MAX_CLUSTERS // 2))
                cluster_size = max(cluster_size, floor)
            cluster_size = max(64, (cluster_size + 63) // 64 * 64)
        elif accel in ("cluster", "sweep"):
            small_idx = np.arange(n_tri)
            if cluster_size is None:
                cluster_size = 128
        clusters = _placeholder_clusters()
        cl_depth = 1
        root_lo = np.full(3, np.inf, f32)
        root_hi = np.full(3, -np.inf, f32)
        if accel in ("cluster", "sweep", "binned") and small_idx.size:
            root_lo = lo_tri[small_idx].min(axis=0).astype(f32)
            root_hi = hi_tri[small_idx].max(axis=0).astype(f32)
        if accel in ("cluster", "sweep", "binned") and not lean:
            cl = build_cluster_bvh(lo_tri[small_idx], hi_tri[small_idx],
                                   cluster_size=cluster_size)
            while accel == "binned" and cl.members.shape[0] > traverse.MAX_CLUSTERS:
                # More clusters than K6's bounds table holds: coarsen.
                cluster_size *= 2
                cl = build_cluster_bvh(lo_tri[small_idx], hi_tri[small_idx],
                                       cluster_size=cluster_size)
            members = np.where(
                cl.members >= 0, small_idx[np.maximum(cl.members, 0)], -1
            ).astype(np.int32)
            blk_idx = np.maximum(members, 0)
            clusters = dict(
                cl_lo=cl.lo, cl_hi=cl.hi, cl_left=cl.left, cl_right=cl.right,
                cl_leaf=cl.cluster, blk_v0=tri_v[0][blk_idx], blk_v1=tri_v[1][blk_idx],
                blk_v2=tri_v[2][blk_idx], blk_cull=tri_cull[blk_idx], blk_prim=members,
                blk_lo=cl.c_lo, blk_hi=cl.c_hi,
            )
            cl_depth = cl.depth
        elif accel not in ("cluster", "sweep", "binned"):
            cluster_size = 1
        trv = traverse.placeholder_tables()
        if accel == "binned" and not lean:
            trv = (traverse.pack_blocks(clusters["blk_v0"], clusters["blk_v1"], clusters["blk_v2"],
                                        clusters["blk_cull"], clusters["blk_prim"]),
                   traverse.pack_bounds(clusters["blk_lo"], clusters["blk_hi"]))
        BUILD_SECONDS["wavefront"] = time.perf_counter() - t0

        # Big-triangle dense set (binned only; empty rows otherwise).
        bpad = max(n_big, 1)
        big_v0 = np.zeros((bpad, 3), f32)
        big_v1 = np.zeros((bpad, 3), f32)
        big_v2 = np.zeros((bpad, 3), f32)
        big_cull = np.zeros(bpad, bool)
        big_prim = np.full(bpad, -1, np.int32)
        if n_big:
            big_v0[:n_big] = tri_v[0][big_idx]
            big_v1[:n_big] = tri_v[1][big_idx]
            big_v2[:n_big] = tri_v[2][big_idx]
            big_cull[:n_big] = tri_cull[big_idx]
            big_prim[:n_big] = big_idx

        # In-kernel traversal tiers: a PTX_KRN_CLUSTER-triangle clustering
        # of the small partition (scene.py:653-713; the JAX package's
        # rejected PTX_KRN_SAH clustering is refused in build_cluster_bvh).
        # Other scenes with 1..128 triangles run them all as one pair record
        # (:719-734).
        krn_cluster_size = 0
        krn_cull_mode = -1
        krn_big_cull_mode = -1
        krn_big_pair = np.zeros((1, 1), f32)
        krn = _placeholder_tiers()
        krn_max = int(os.environ.get("PTX_KRN_MAX_TRIS", str(KRN_MAX_TRIS)))
        if accel == "binned" and n_small < min(krn_max, 2 ** 24):
            t0 = time.perf_counter()
            krn_cluster = int(os.environ.get("PTX_KRN_CLUSTER", str(KRN_CLUSTER)))
            kcl = build_cluster_bvh(lo_tri[small_idx], hi_tri[small_idx],
                                    cluster_size=krn_cluster)
            t1 = time.perf_counter()
            kmembers = np.where(
                kcl.members >= 0, small_idx[np.maximum(kcl.members, 0)], -1
            ).astype(np.int32)
            kidx = np.maximum(kmembers, 0)
            krn = pack_kernel_tables_np(
                tri_v[0][kidx], tri_v[1][kidx], tri_v[2][kidx],
                tri_cull[kidx] & (kmembers >= 0), kmembers,
                tri_n[0][kidx], tri_n[1][kidx], tri_n[2][kidx],
                tri_mat[kidx], kcl.c_lo, kcl.c_hi,
            )
            krn_cluster_size = krn_cluster
            krn_cull_mode = cull_uniformity(tri_cull[kidx][kmembers >= 0])
            if n_big <= 128:
                bidx = np.maximum(big_prim, 0)
                krn_big_pair = pack_pair_record_np(
                    big_v0, big_v1, big_v2, big_cull, big_prim,
                    tri_n[0][bidx], tri_n[1][bidx], tri_n[2][bidx], tri_mat[bidx],
                )
                krn_big_cull_mode = cull_uniformity(big_cull[big_prim >= 0])
            BUILD_SECONDS["bvh"] = t1 - t0
            BUILD_SECONDS["pack"] = time.perf_counter() - t1
        elif 1 <= n_tri <= 128:
            prim = np.arange(tpad, dtype=np.int32)
            prim[n_tri:] = -1
            krn_big_pair = pack_pair_record_np(
                tri_v[0], tri_v[1], tri_v[2],
                tri_cull & (prim >= 0), prim,
                tri_n[0], tri_n[1], tri_n[2], tri_mat,
            )
            krn_big_cull_mode = cull_uniformity(tri_cull[:n_tri])

        emissive_in_dense = True
        if accel == "binned":
            emissive_in_dense = all(bool(big_mask[p]) for p in em_prims if p < n_tri)
        if lean:
            # A lean scene has no fallback intersector (scene.py:743-769).
            problems = []
            if krn_cluster_size == 0:
                problems.append(f"small partition ({n_small} tris) exceeds PTX_KRN_MAX_TRIS")
            if n_big > 128:
                problems.append(f"big partition ({n_big} tris) exceeds the 128-row pair record")
            if not emissive_in_dense:
                problems.append("emissive prims outside the dense partition")
            if problems:
                raise ValueError("lean build cannot serve the megakernel: " + "; ".join(problems))

        arrays = dict(
            tri_v0=tri_v[0], tri_v1=tri_v[1], tri_v2=tri_v[2],
            tri_n0=tri_n[0], tri_n1=tri_n[1], tri_n2=tri_n[2],
            tri_cull=tri_cull, tri_material=tri_mat,
            tri_valid=np.arange(tpad) < n_tri,
            sph_center=sph_c, sph_radius=sph_r, sph_material=sph_mat,
            sph_valid=np.arange(spad) < n_sph,
            mat_diffuse=mat_diffuse, mat_specular=mat_specular,
            mat_ior=mat_ior, mat_emission=mat_emission,
            mat_bsdf=mat_bsdf, mat_one_way=mat_one_way,
            light_pos=light_pos, light_spectrum=light_spec,
            emissive_prim=emissive_prim, emissive_cdf=emissive_cdf,
            big_v0=big_v0, big_v1=big_v1, big_v2=big_v2, big_cull=big_cull,
            big_prim=big_prim, root_lo=root_lo, root_hi=root_hi,
            krn_big_pair=krn_big_pair,
            **dict(zip(KRN_FIELDS, krn)), **clusters, **dict(zip(TRV_FIELDS, trv)),
            **{f: getattr(bvh, f[4:]) for f in BVH_FIELDS},
        )
        meta = dict(
            n_tri=n_tri, n_sph=n_sph,
            n_point_lights=len(self._point_lights),
            n_emissive=n_emissive,
            emissive_sample_count=emissive_sample_count,
            accel=accel,
            emissive_all_tri=bool(all(int(x) < n_tri for x in em_prims)),
            krn_big_cull_mode=int(krn_big_cull_mode),
            n_big=n_big,
            krn_cluster_size=int(krn_cluster_size),
            krn_cull_mode=int(krn_cull_mode),
            emissive_in_dense=bool(emissive_in_dense),
            cl_depth=int(cl_depth), cluster_size=int(cluster_size), lean=bool(lean),
            bvh_depth=int(bvh.depth),
        )
        t0 = time.perf_counter()
        scene = scene_from_numpy(arrays, meta, device)
        if device.type == "cuda":
            torch.cuda.synchronize(device)
        BUILD_SECONDS["upload"] = time.perf_counter() - t0
        return scene
