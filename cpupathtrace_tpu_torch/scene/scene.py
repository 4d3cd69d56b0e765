"""Scene container (torch tensors on one device) and the host-side builder.

Port of `cpupathtrace_tpu/scene/scene.py`, dense scenes only: primitive
arrays (triangles 0..n_tri-1, spheres n_tri..), the material table, point
lights, the emissive registry + CDF (ref: src/scene/scene.cpp:165-226), and
the dense pair record that carries every triangle through the megakernel's
pair test. Arrays are padded so no shape is zero-length; padding rows are
masked by `tri_valid` / `sph_valid`.

The build is the numpy arithmetic of the JAX builder's dense branch
(scene.py:342-440 and :719-734), so both packages give equal arrays
(tests/test_torch_scene.py). Scenes that need another accelerator
(more than `dense_threshold` primitives) are ROADMAP slice 2 and raise.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from ..accel.pair_record import cull_uniformity, pack_pair_record_np
from ..utils.math import PI
from .geometry import HostTriangle, TriangleBatch

# BSDF type codes (ref: include/PathTrace/scene/propagation.h:57-108).
BSDF_LAMBERTIAN = 0
BSDF_GLASS = 1
BSDF_MIRROR = 2

_NOT_DENSE = (
    "only dense scenes (<= dense_threshold primitives) build in the torch "
    "port; binned/sweep/bvh scenes are ROADMAP.md Queue 1 slice 2 "
    "(items 9-10, and the binned builder of item 22)"
)

ARRAY_FIELDS = (
    "tri_v0", "tri_v1", "tri_v2", "tri_n0", "tri_n1", "tri_n2",
    "tri_cull", "tri_material", "tri_valid",
    "sph_center", "sph_radius", "sph_material", "sph_valid",
    "mat_diffuse", "mat_specular", "mat_ior", "mat_emission",
    "mat_bsdf", "mat_one_way",
    "light_pos", "light_spectrum",
    "emissive_prim", "emissive_cdf",
    "krn_big_pair",
)
STATIC_FIELDS = (
    "n_tri", "n_sph", "n_point_lights", "n_emissive",
    "emissive_sample_count", "accel", "emissive_all_tri",
    "krn_big_cull_mode",
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
    # Dense pair record [rows <= 128, 128] f32 (1 <= n_tri <= 128), or
    # [1, 1] when the scene has no triangles.
    krn_big_pair: torch.Tensor

    n_tri: int
    n_sph: int
    n_point_lights: int
    n_emissive: int
    emissive_sample_count: int
    accel: str
    emissive_all_tri: bool
    # Cull class of the pair record (accel/pair_record.cull_uniformity).
    krn_big_cull_mode: int = -1

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
        """True when the triangles ride the pair record (else the
        triangle table; n_tri = 0 scenes)."""
        return self.krn_big_pair.shape[0] > 1

    def to(self, device) -> "SceneData":
        device = torch.device(device)
        if device == self.device:
            return self
        return dataclasses.replace(
            self, **{f: getattr(self, f).to(device) for f in ARRAY_FIELDS}
        )


def scene_from_numpy(arrays: dict, meta: dict, device="cpu") -> SceneData:
    """Carry a scene across from its numpy form: `arrays` maps field names
    to arrays (e.g. the JAX SceneData's fields through np.asarray; extra
    fields are ignored), `meta` its static fields. Raises
    NotImplementedError for scenes that are not dense."""
    if meta.get("accel") != "dense" or meta.get("krn_cluster_size", 0):
        raise NotImplementedError(_NOT_DENSE)
    missing = [f for f in ARRAY_FIELDS if f not in arrays]
    if missing:
        raise KeyError(f"scene arrays missing {missing}")
    tensors = {
        f: torch.from_numpy(np.array(arrays[f])).to(device)
        for f in ARRAY_FIELDS
    }
    static = {f: meta[f] for f in STATIC_FIELDS}
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
        device="cpu",
    ) -> SceneData:
        """Pack the scene onto `device`. Only the dense accelerator exists
        in the port: `accel` may be None (auto) or "dense"."""
        f32 = np.float32
        n_tri = sum(len(b) for b in self._batches)
        n_sph = len(self._spheres)
        if accel is None and n_tri + n_sph > dense_threshold:
            accel = "binned/sweep"
        if accel not in (None, "dense"):
            raise NotImplementedError(f"accel {accel!r}: {_NOT_DENSE}")

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

        # Dense pair record: the whole triangle set as ONE record
        # (scene.py:719-734 of the JAX builder).
        krn_big_pair = np.zeros((1, 1), f32)
        krn_big_cull_mode = -1
        if 1 <= n_tri <= 128:
            prim = np.arange(tpad, dtype=np.int32)
            prim[n_tri:] = -1
            krn_big_pair = pack_pair_record_np(
                tri_v[0], tri_v[1], tri_v[2],
                tri_cull & (prim >= 0), prim,
                tri_n[0], tri_n[1], tri_n[2], tri_mat,
            )
            krn_big_cull_mode = cull_uniformity(tri_cull[:n_tri])

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
            krn_big_pair=krn_big_pair,
        )
        meta = dict(
            n_tri=n_tri, n_sph=n_sph,
            n_point_lights=len(self._point_lights),
            n_emissive=n_emissive,
            emissive_sample_count=emissive_sample_count,
            accel="dense",
            emissive_all_tri=bool(all(int(x) < n_tri for x in em_prims)),
            krn_big_cull_mode=int(krn_big_cull_mode),
        )
        return scene_from_numpy(arrays, meta, device)
