"""The plain reference's scenes, built from a configuration's description.

Everything here works from the upstream definitions (CPUPathTrace
src/scene/mesh.cpp makePlane / makeBox / loadMesh, src/scene/scene.cpp's
emitter registry) and takes nothing from the program: the triangles,
shading normals, material table and emitter table are derived anew. The
arithmetic follows the upstream order in float64 on the host, then float32,
as the program packs its tables, so both sides start from the same float32
vertices. Frozen copies, with the file each was copied from:
  * `make_plane`, `make_box`: cpupathtrace_tpu_torch/scene/geometry.py;
  * `standin_dragon`: cpupathtrace_tpu_torch/models/scenes.py
    (`_standin_dragon_geometry`, `standin_dragon_arrays`);
  * `mesh_triangles`: cpupathtrace_tpu_torch/scene/mesh.py
    (`mesh_from_arrays`, `_mesh_pipeline_numpy`; vertex normals summed by
    bincount, the same sums in another order);
  * `emitter_table`: cpupathtrace_tpu_torch/scene/scene.py (the registry)
    and integrator/megakernel.py (`pack_tables`' emissive rows).
"""
from __future__ import annotations

import dataclasses
import math

import numpy as np
import torch

PLANE_EPS = 1e-4
BSDF = {"lambertian": 0, "glass": 1, "mirror": 2}


def make_plane(a, b, cull=False):
    """Two triangles (a, v2, b), (b, v4, a) of the axis-aligned rectangle
    with diagonal corners a, b, or none when it is not a valid plane."""
    a = np.array(a, np.float64)
    b = np.array(b, np.float64)
    plane_dim = -1
    for i in range(3):
        if abs(a[i] - b[i]) < PLANE_EPS:
            plane_dim = i
    if plane_dim < 0 or any(abs(a[i] - b[i]) < PLANE_EPS for i in range(3) if i != plane_dim):
        return []
    dim1 = 1 if plane_dim == 0 else 0
    v2, v4 = a.copy(), b.copy()
    v2[dim1] = b[dim1]
    v4[dim1] = a[dim1]
    return [(a, v2, b, cull), (b, v4, a, cull)]


def make_box(a, b, cull=False):
    """The 12 triangles of the box with opposite corners a, b."""
    a = np.asarray(a, np.float64)
    b = np.asarray(b, np.float64)
    if any(abs(a[i] - b[i]) < PLANE_EPS for i in range(3)):
        return []
    tris = []
    for i in range(3):
        pa, pb = a.copy(), a.copy()
        for d in range(3):
            if d != i:
                pa[d], pb[d] = a[d], b[d]
        tris += make_plane(pa, pb, cull)
        pa[i] = pb[i] = b[i]
        tris += make_plane(pa, pb, cull)
    return tris


def flat_triangles(tris):
    """[(a, b, c, cull)] -> arrays (v0, v1, v2, n0, n1, n2, cull), the
    shading normals the unit face normal."""
    v = [np.array([t[k] for t in tris], np.float64).reshape(-1, 3) for k in range(3)]
    fn = np.cross(v[1] - v[0], v[2] - v[0])
    norm = np.linalg.norm(fn, axis=1, keepdims=True)
    fn = np.where(norm > 0, fn / np.where(norm > 0, norm, 1.0), fn)
    return (*v, fn, fn, fn, np.array([t[3] for t in tris], bool))


def standin_dragon(target_tris: int, seed: int):
    """The procedural stand-in for xyzrgb_dragon.obj: a UV sphere displaced
    by three octaves of sinusoids. (verts [V,3] f64 rounded to 6 decimals,
    faces [F,3] 0-based)."""
    rows = max(int(math.sqrt(target_tris / 4)), 3)
    cols = 2 * rows
    phases = np.random.default_rng(seed).uniform(0, 2 * np.pi, size=(3, 3))
    theta = np.linspace(0, np.pi, rows + 1)
    phi = np.linspace(0, 2 * np.pi, cols, endpoint=False)
    t, p = np.meshgrid(theta, phi, indexing="ij")
    x = np.sin(t) * np.cos(p)
    y = np.cos(t)
    z = np.sin(t) * np.sin(p)
    disp = np.zeros_like(x)
    for o in range(3):
        f = 2.0 ** (o + 1)
        disp += np.sin(f * t + phases[o, 0]) * np.cos(f * p + phases[o, 1]) * (0.25 / f)
    r = 1.0 + disp
    verts = np.stack([x * r * 1.6, y * r * 0.9, z * r * 0.7], axis=-1) * 40.0
    vid = np.arange((rows + 1) * cols).reshape(rows + 1, cols)
    a, bb = vid[:-1], vid[1:]
    a_n, b_n = np.roll(a, -1, axis=1), np.roll(bb, -1, axis=1)
    upper = np.stack([a, bb, a_n], -1)  # skipped at the north pole row
    lower = np.stack([a_n, bb, b_n], -1)  # skipped at the south pole row
    faces = []
    for i in range(rows):
        if i > 0:
            faces.append(upper[i])
        if i < rows - 1:
            faces.append(lower[i])
    return np.round(verts.reshape(-1, 3), 6), np.concatenate(faces)


def mesh_triangles(verts, faces, transform, cull=False, smooth=True):
    """loadMesh's pipeline on arrays: transform with the perspective
    divide, drop invalid faces, unit face normals, smooth vertex normals
    (the normalised sum of the unit normals of the faces at a vertex)."""
    mat = np.asarray(transform, np.float64)
    h = np.concatenate([verts, np.ones((verts.shape[0], 1))], axis=1) @ mat.T
    verts = h[:, :3] / h[:, 3:4]
    a, b, c = verts[faces[:, 0]], verts[faces[:, 1]], verts[faces[:, 2]]
    fn = np.cross(b - a, c - a)
    keep = ((np.sum((b - a) ** 2, 1) > 0) & (np.sum((c - a) ** 2, 1) > 0)
            & (np.sum((c - b) ** 2, 1) > 0) & (np.sum(fn * fn, 1) > 0))
    faces, a, b, c, fn = faces[keep], a[keep], b[keep], c[keep], fn[keep]
    fn = fn / np.maximum(np.linalg.norm(fn, axis=1, keepdims=True), 1e-300)
    if not smooth:
        return a, b, c, fn, fn, fn, np.full(len(a), cull)
    n_v = verts.shape[0]
    vn = np.stack([sum(np.bincount(faces[:, k], fn[:, j], n_v) for k in range(3))
                   for j in range(3)], -1)
    len2 = np.sum(vn * vn, 1)
    ok = len2 > 0
    vn = np.where(ok[:, None], vn / np.sqrt(np.maximum(len2, 1e-300))[:, None], 0.0)
    ns = [np.where(ok[faces[:, k], None], vn[faces[:, k]], fn) for k in range(3)]
    return a, b, c, *ns, np.full(len(a), cull)


def plucker_features(v0, v1, v2) -> np.ndarray:
    """[T, 16] float32 features of the triangles (float32 arrays)."""
    e1 = v1 - v0
    e2 = v2 - v0
    n = np.cross(e1, e2)
    return np.concatenate([-n, e2, np.cross(v0, e2), -e1, -np.cross(v0, e1),
                           (v0 * n).sum(-1, keepdims=True)], 1).astype(np.float32)


@dataclasses.dataclass
class RefScene:
    """float32 triangle arrays on a device, the material table and the
    emitter table. Material columns: diffuse [M,3], specular [M,3], ior
    [M], emission [M,3], bsdf [M] (0 / 1 / 2), one_way [M]."""

    v0: torch.Tensor
    e1: torch.Tensor
    e2: torch.Tensor
    n0: torch.Tensor
    n1: torch.Tensor
    n2: torch.Tensor
    cull: torch.Tensor
    mat: torch.Tensor
    diffuse: torch.Tensor
    specular: torch.Tensor
    ior: torch.Tensor
    emission: torch.Tensor
    bsdf: torch.Tensor
    one_way: torch.Tensor
    em: dict
    em_k: int
    plucker: torch.Tensor  # [T, 16] features of the ray-triangle test

    @property
    def n_tri(self) -> int:
        return self.v0.shape[0]


def material_rows(materials):
    """The config's materials -> float64 arrays (diffuse, specular, ior,
    emission RGBA, bsdf, one_way), with the upstream ConstantMaterial
    defaults for what a row leaves out."""
    def col(key, default):
        return np.array([m.get(key, default) for m in materials], np.float64)
    return dict(diffuse=col("diffuse", [1.0] * 4), specular=col("specular", [1.0] * 4),
                ior=col("ior", 1.0), emission=col("emission", [0.0] * 4),
                bsdf=np.array([BSDF[m.get("bsdf", "lambertian")] for m in materials]),
                one_way=col("one_way", 0.0) > 0)


def emitter_table(v0, v1, v2, mat, rows):
    """Emitting triangles with their CDF by power ((r+g+b)*a*area, upstream
    scene.cpp), float32 CDF, selection probability times the draws a vertex
    makes, area pdf, unit face normal and edges; and em_k, the draws a
    vertex makes (2 + log10(n + 1), at most n)."""
    em64 = rows["emission"]
    mat_p = (em64[:, 0] + em64[:, 1] + em64[:, 2]) * em64[:, 3]
    tri_p = mat_p[mat]
    cand = np.flatnonzero(tri_p > 0)
    area = 0.5 * np.linalg.norm(np.cross((v1[cand] - v0[cand]).astype(np.float64),
                                         (v2[cand] - v0[cand]).astype(np.float64)), axis=1)
    power = tri_p[cand] * area
    prim = cand[power > 0]
    power = power[power > 0]
    n = len(prim)
    if n == 0:
        raise ValueError("the reference needs an emitting triangle")
    em_k = min(2 + int(np.log10(n + 1)), n)
    cdf = np.cumsum(power)
    cdf = (cdf / cdf[-1]).astype(np.float32)
    prob = np.diff(np.concatenate([np.zeros(1, np.float32), cdf])).astype(np.float32)
    e1 = (v1[prim] - v0[prim]).astype(np.float32)
    e2 = (v2[prim] - v0[prim]).astype(np.float32)
    fn = np.cross(e1, e2).astype(np.float32)
    area2 = np.sqrt(np.sum(fn * fn, 1, dtype=np.float32)).astype(np.float32)
    fn = fn / np.maximum(area2, np.float32(1e-30))[:, None]
    pd_area = np.float32(1.0) / np.maximum(area2 * np.float32(0.5), np.float32(1e-30))
    return dict(prim=prim, cdf=cdf, sel_p=prob * np.float32(em_k), v0=v0[prim], e1=e1, e2=e2,
                normal=fn, pd_area=pd_area, mat=mat[prim]), em_k


def build(parts, materials, device) -> RefScene:
    """`parts`: [(arrays of flat_triangles / mesh_triangles, material id)]."""
    cols = [np.concatenate([p[0][k] for p in parts]) for k in range(7)]
    mat = np.concatenate([np.full(len(p[0][0]), p[1], np.int64) for p in parts])
    v0, v1, v2 = (c.astype(np.float32) for c in cols[:3])
    rows = material_rows(materials)
    em, em_k = emitter_table(v0, v1, v2, mat, rows)

    def t(x, dtype=torch.float32):
        return torch.as_tensor(np.ascontiguousarray(x)).to(device=device, dtype=dtype)

    return RefScene(
        v0=t(v0), e1=t(v1 - v0), e2=t(v2 - v0),
        n0=t(cols[3].astype(np.float32)), n1=t(cols[4].astype(np.float32)),
        n2=t(cols[5].astype(np.float32)), cull=t(cols[6], torch.bool), mat=t(mat, torch.int64),
        diffuse=t(rows["diffuse"][:, :3]), specular=t(rows["specular"][:, :3]),
        ior=t(rows["ior"]), emission=t(rows["emission"][:, :3]),
        bsdf=t(rows["bsdf"], torch.int64), one_way=t(rows["one_way"], torch.bool),
        em={k: t(v, torch.int64 if k in ("prim", "mat") else torch.float32)
            for k, v in em.items()},
        em_k=em_k, plucker=t(plucker_features(v0, v1, v2)),
    )


def from_config(cfg: dict, device) -> RefScene:
    """The scene a configuration describes: "box" (makeBox), "light"
    (makePlane) and an optional "dragon" (the stand-in mesh), each with its
    material id into "materials"."""
    sc = cfg["scene"]
    parts = [(flat_triangles(make_box(sc["box"]["lo"], sc["box"]["hi"], sc["box"]["cull"])),
              sc["box"]["material"]),
             (flat_triangles(make_plane(sc["light"]["a"], sc["light"]["b"], sc["light"]["cull"])),
              sc["light"]["material"])]
    if "dragon" in sc:
        dr = sc["dragon"]
        if dr["mesh"] != "standin":
            raise ValueError(f"unknown dragon mesh {dr['mesh']!r}")
        verts, faces = standin_dragon(dr["tris"], dr["seed"])
        parts.append((mesh_triangles(verts, faces, dr["transform"], dr["cull"], dr["smooth"]),
                      dr["material"]))
    return build(parts, cfg["materials"], device)
