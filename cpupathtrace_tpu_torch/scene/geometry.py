"""Host-side procedural geometry builders (NumPy, run once at scene build).

The port's own copy of `cpupathtrace_tpu/scene/geometry.py`: the same
arithmetic, so scenes built by either package hold the same vertices
(tests/test_torch_scene.py holds them equal). Behavioral parity with the
reference's mesh helpers:
  * make_plane  (ref: src/scene/mesh.cpp:294-336 makePlane)
  * make_box    (ref: src/scene/mesh.cpp:338-375 makeBox)

Triangles are plain host-side records here; `SceneBuilder` packs them into SoA
device arrays.
"""
from __future__ import annotations

import dataclasses

import numpy as np

_PLANE_EPS = 1e-4


@dataclasses.dataclass
class HostTriangle:
    """One triangle being assembled on the host before SoA packing."""

    a: np.ndarray
    b: np.ndarray
    c: np.ndarray
    cull_backface: bool = False
    # Per-vertex shading normals; default face normal (ref: object.cpp:118-124).
    na: np.ndarray | None = None
    nb: np.ndarray | None = None
    nc: np.ndarray | None = None
    material: int = -1

    def __post_init__(self):
        # np.array (not asarray): always copy, so callers mutating their
        # vertex buffers afterwards cannot alias into stored triangles.
        self.a = np.array(self.a, dtype=np.float64)
        self.b = np.array(self.b, dtype=np.float64)
        self.c = np.array(self.c, dtype=np.float64)
        if self.na is None:
            n = np.cross(self.b - self.a, self.c - self.a)
            norm = np.linalg.norm(n)
            n = n / norm if norm > 0 else n
            self.na = n.copy()
            self.nb = n.copy()
            self.nc = n.copy()

    def face_normal(self) -> np.ndarray:
        return np.cross(self.b - self.a, self.c - self.a)

    def surface_area(self) -> float:
        return float(np.linalg.norm(self.face_normal()) / 2.0)


@dataclasses.dataclass
class TriangleBatch:
    """Columnar batch of host triangles — the array-native fast path for
    large meshes (a million `HostTriangle` objects cost ~20s of pure Python;
    the batch is a handful of array ops). `SceneBuilder.add_triangles` and
    `transform_triangles` accept either form."""

    v0: np.ndarray  # [N,3] f64 vertices
    v1: np.ndarray
    v2: np.ndarray
    n0: np.ndarray  # [N,3] per-vertex shading normals
    n1: np.ndarray
    n2: np.ndarray
    cull: np.ndarray  # [N] bool backface-culling flags
    material: np.ndarray  # [N] i32 material ids (-1 = unset)

    def __len__(self) -> int:
        return self.v0.shape[0]

    @staticmethod
    def from_triangles(triangles: "list[HostTriangle]") -> "TriangleBatch":
        n = len(triangles)
        if n == 0:
            return TriangleBatch.empty()
        f64 = np.float64
        return TriangleBatch(
            v0=np.array([t.a for t in triangles], f64),
            v1=np.array([t.b for t in triangles], f64),
            v2=np.array([t.c for t in triangles], f64),
            n0=np.array([t.na for t in triangles], f64),
            n1=np.array([t.nb for t in triangles], f64),
            n2=np.array([t.nc for t in triangles], f64),
            cull=np.array([t.cull_backface for t in triangles], bool),
            material=np.array([t.material for t in triangles], np.int32),
        )

    @staticmethod
    def empty() -> "TriangleBatch":
        z3 = np.zeros((0, 3), np.float64)
        return TriangleBatch(
            v0=z3, v1=z3, v2=z3, n0=z3, n1=z3, n2=z3,
            cull=np.zeros(0, bool), material=np.zeros(0, np.int32),
        )

    @staticmethod
    def concatenate(batches: "list[TriangleBatch]") -> "TriangleBatch":
        if not batches:
            return TriangleBatch.empty()
        cat = np.concatenate
        return TriangleBatch(
            v0=cat([b.v0 for b in batches]), v1=cat([b.v1 for b in batches]),
            v2=cat([b.v2 for b in batches]), n0=cat([b.n0 for b in batches]),
            n1=cat([b.n1 for b in batches]), n2=cat([b.n2 for b in batches]),
            cull=cat([b.cull for b in batches]),
            material=cat([b.material for b in batches]).astype(np.int32),
        )

    def surface_areas(self) -> np.ndarray:
        """Per-triangle areas, same math as HostTriangle.surface_area."""
        fn = np.cross(self.v1 - self.v0, self.v2 - self.v0)
        return np.linalg.norm(fn, axis=1) / 2.0


def make_plane(a, b, cull_backface: bool = False) -> list[HostTriangle]:
    """Axis-aligned rectangle from two diagonal corners, as two triangles.

    Reproduces the reference's validity rules: exactly one shared coordinate
    (the *last* matching axis wins) and the other two must differ
    (ref: src/scene/mesh.cpp:294-336).
    """
    a = np.asarray(a, dtype=np.float64)
    b = np.asarray(b, dtype=np.float64)

    plane_dim = -1
    for i in range(3):
        if abs(a[i] - b[i]) < _PLANE_EPS:
            plane_dim = i
    others_separate = True
    for i in range(3):
        if i == plane_dim:
            continue
        if abs(a[i] - b[i]) < _PLANE_EPS:
            others_separate = False
    if plane_dim < 0 or not others_separate:
        return []

    dim1 = 1 if plane_dim == 0 else 0

    v2 = a.copy()
    v4 = b.copy()
    v2[dim1] = b[dim1]
    v4[dim1] = a[dim1]

    return [
        HostTriangle(a, v2, b, cull_backface),
        HostTriangle(b, v4, a, cull_backface),
    ]


def make_box(a, b, cull_backface: bool = False) -> list[HostTriangle]:
    """Axis-aligned box from two opposite corners, 12 triangles
    (ref: src/scene/mesh.cpp:338-375)."""
    a = np.asarray(a, dtype=np.float64)
    b = np.asarray(b, dtype=np.float64)

    for i in range(3):
        if abs(a[i] - b[i]) < _PLANE_EPS:
            return []

    triangles: list[HostTriangle] = []
    for i in range(3):
        plane_a = a.copy()
        plane_b = a.copy()
        for dim in range(3):
            if dim == i:
                continue
            plane_a[dim] = a[dim]
            plane_b[dim] = b[dim]

        triangles.extend(make_plane(plane_a, plane_b, cull_backface))

        plane_a[i] = b[i]
        plane_b[i] = b[i]
        triangles.extend(make_plane(plane_a, plane_b, cull_backface))

    return triangles


def _transform_batch(
    batch: TriangleBatch, mat4: np.ndarray, nmat: np.ndarray | None
) -> TriangleBatch:
    def tp(p):
        h = np.concatenate([p, np.ones((p.shape[0], 1))], axis=1) @ mat4.T
        return h[:, :3] / h[:, 3:4]

    v0, v1, v2 = tp(batch.v0), tp(batch.v1), tp(batch.v2)
    if nmat is not None:
        def tn(nv):
            n = nv @ nmat.T
            norm = np.linalg.norm(n, axis=1, keepdims=True)
            return np.where(norm > 0, n / np.maximum(norm, 1e-300), n)

        n0, n1, n2 = tn(batch.n0), tn(batch.n1), tn(batch.n2)
    else:
        fn = np.cross(v1 - v0, v2 - v0)
        norm = np.linalg.norm(fn, axis=1, keepdims=True)
        n0 = n1 = n2 = np.where(norm > 0, fn / np.maximum(norm, 1e-300), fn)
    return TriangleBatch(
        v0=v0, v1=v1, v2=v2, n0=n0, n1=n1, n2=n2,
        cull=batch.cull.copy(), material=batch.material.copy(),
    )


def transform_triangles(
    triangles: list[HostTriangle] | TriangleBatch,
    mat4: np.ndarray,
    preserve_normals: bool = True,
) -> list[HostTriangle] | TriangleBatch:
    """Apply a row-major 4x4 affine transform (with perspective divide, ref:
    util/matrix.h:50-55) to triangle vertices — the `moveObjects`-with-a-
    transform workflow (ref: scene/mesh.h:74-81 + demo/main.cpp:190-194).

    With `preserve_normals` (default) per-vertex shading normals are carried
    through via the inverse-transpose of the linear part and renormalized,
    so smooth meshes stay smooth; face-normal triangles still end up with
    the new face normals (the inverse-transpose maps face normals to face
    normals for affine maps). `preserve_normals=False` resets to face
    normals, matching the demo's manual re-construction of transformed
    box triangles."""
    mat4 = np.asarray(mat4, dtype=np.float64)

    nmat = None
    if preserve_normals:
        lin = mat4[:3, :3]
        try:
            nmat = np.linalg.inv(lin).T
        except np.linalg.LinAlgError:
            nmat = None  # singular: fall back to face normals

    if isinstance(triangles, TriangleBatch):
        return _transform_batch(triangles, mat4, nmat)

    def tp(p):
        h = mat4 @ np.array([p[0], p[1], p[2], 1.0])
        return h[:3] / h[3]

    def tn(nv):
        n = nmat @ np.asarray(nv, dtype=np.float64)
        norm = np.linalg.norm(n)
        return n / norm if norm > 0 else n

    out = []
    for t in triangles:
        nt = HostTriangle(
            tp(t.a), tp(t.b), tp(t.c), t.cull_backface, material=t.material
        )
        if nmat is not None:
            nt.na, nt.nb, nt.nc = tn(t.na), tn(t.nb), tn(t.nc)
        out.append(nt)
    return out
