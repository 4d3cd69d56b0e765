"""Triangle meshes from raw vertex and face arrays.

Port of `cpupathtrace_tpu/scene/mesh.py:mesh_from_arrays`, numpy path: the
post-parse pipeline of the reference's OBJ loader (transform at load, face
validation, smooth vertex normals; ref: src/scene/mesh.cpp:127-267). The
same arithmetic as the JAX package, so both give the same triangles. The
OBJ parser (`load_mesh`) and the threaded native pipeline (same bits, used
by the JAX package from 65,536 faces) are still to be ported.
"""
from __future__ import annotations

import numpy as np

from .geometry import HostTriangle, TriangleBatch

_IDENTITY = np.eye(4, dtype=np.float64)


def mesh_from_arrays(
    verts: np.ndarray,
    face_idx: np.ndarray,
    transformation: np.ndarray | None = None,
    cull_backface: bool = True,
    smooth: bool = True,
    as_batch: bool = False,
) -> list[HostTriangle] | TriangleBatch:
    """Triangles from vertices [V,3] and 0-based faces [F,3]."""
    verts = np.asarray(verts, np.float64).reshape(-1, 3)
    face_idx = np.asarray(face_idx, np.int64).reshape(-1, 3)
    mat = _IDENTITY if transformation is None else np.asarray(transformation, np.float64)
    if verts.shape[0]:
        h = np.concatenate([verts, np.ones((verts.shape[0], 1))], axis=1) @ mat.T
        verts = h[:, :3] / h[:, 3:4]

    n_v = verts.shape[0]
    if face_idx.shape[0] == 0 or n_v == 0:
        # Faces without vertices are all out of range (ref: mesh.cpp:149-158).
        return TriangleBatch.empty() if as_batch else []

    # Face validation (ref: mesh.cpp:149-174).
    in_range = np.all((face_idx >= 0) & (face_idx < n_v), axis=1)
    face_idx_c = np.clip(face_idx, 0, max(n_v - 1, 0))
    a = verts[face_idx_c[:, 0]]
    b = verts[face_idx_c[:, 1]]
    c = verts[face_idx_c[:, 2]]
    ab2 = np.sum((b - a) ** 2, axis=1)
    ac2 = np.sum((c - a) ** 2, axis=1)
    bc2 = np.sum((c - b) ** 2, axis=1)
    distinct = (ab2 > 0) & (ac2 > 0) & (bc2 > 0)  # NaN-rejecting comparisons
    fn = np.cross(b - a, c - a)
    non_collinear = np.sum(fn * fn, axis=1) > 0
    keep = in_range & distinct & non_collinear
    face_idx = face_idx_c[keep]
    a, b, c, fn = a[keep], b[keep], c[keep], fn[keep]

    fn_len = np.linalg.norm(fn, axis=1, keepdims=True)
    fn_unit = fn / np.maximum(fn_len, 1e-300)
    if smooth and face_idx.shape[0]:
        # Per-vertex average of the unit incident face normals
        # (ref: mesh.cpp:228-267).
        v_norm = np.zeros((n_v, 3))
        for k in range(3):
            np.add.at(v_norm, face_idx[:, k], fn_unit)
        v_len2 = np.sum(v_norm * v_norm, axis=1)
        ok = v_len2 > 0
        v_unit = np.where(
            ok[:, None], v_norm / np.sqrt(np.maximum(v_len2, 1e-300))[:, None], 0.0
        )
        na = np.where(ok[face_idx[:, 0], None], v_unit[face_idx[:, 0]], fn_unit)
        nb = np.where(ok[face_idx[:, 1], None], v_unit[face_idx[:, 1]], fn_unit)
        nc = np.where(ok[face_idx[:, 2], None], v_unit[face_idx[:, 2]], fn_unit)
    else:
        na = nb = nc = fn_unit

    if as_batch:
        n = face_idx.shape[0]
        return TriangleBatch(
            v0=a, v1=b, v2=c,
            n0=np.ascontiguousarray(na), n1=np.ascontiguousarray(nb),
            n2=np.ascontiguousarray(nc),
            cull=np.full(n, cull_backface, bool),
            material=np.full(n, -1, np.int32),
        )
    return [
        HostTriangle(a[i], b[i], c[i], cull_backface,
                     na=na[i].copy(), nb=nb[i].copy(), nc=nc[i].copy())
        for i in range(face_idx.shape[0])
    ]
