"""Wavefront OBJ mesh loading and triangle meshes from arrays (host-side).

Port of `cpupathtrace_tpu/scene/mesh.py`. Behavioural parity with the
reference's hand-rolled parser (ref: src/scene/mesh.cpp:11-271
impl::ObjParser):
  * only `v` and `f` records are honoured; everything else is skipped
  * face vertex references keep only the position index (`a/b/c` -> `a`,
    ref: mesh.cpp:133-146)
  * unparseable floats become NaN and unparseable ints -1, which then reject
    the affected face (ref: mesh.cpp:96-121)
  * face validation: index bounds, pairwise-distinct vertices,
    non-collinearity via squared face-normal length (ref: mesh.cpp:149-174)
  * the load-time 4x4 transform applies to vertices as they are read
    (ref: mesh.cpp:127)
  * optional smoothing: per-vertex average of *normalised* face normals,
    written back to each incident triangle's vertex normal
    (ref: mesh.cpp:228-267)

Three parsers, as in the JAX package: a vectorised numpy parse of
well-formed text, a tolerant per-line parse for the rest, and, for texts
over NATIVE_PARSE_MIN_BYTES, the C++ parser (native/, csrc/mesh_native.cpp),
which reads floats as float32 (`strtof`) where the Python parsers keep
float64. So the same text can give other bits on the two routes; each
route gives the bits of the JAX package's same route. The mesh pipeline
after the parse runs in C++ for batches of MESH_NATIVE_MIN_FACES faces or
more, bit-equal to its numpy body (`_mesh_pipeline_numpy`). Neither C++
route falls back to Python: a failed build raises.
"""
from __future__ import annotations

import warnings

import numpy as np

from ..native import mesh_pipeline_native, parse_obj_native
from .geometry import HostTriangle, TriangleBatch

_IDENTITY = np.eye(4, dtype=np.float64)

#: OBJ text size above which load_mesh uses the native C++ parser.
NATIVE_PARSE_MIN_BYTES = 1 << 20
#: Face count from which mesh_from_arrays(as_batch=True) runs the C++ pipeline.
MESH_NATIVE_MIN_FACES = 65536


def _parse_float(tok: str) -> float:
    # The reference's tolerant char filter + stof (ref: mesh.cpp:96-121):
    # keep leading [0-9.eE+-] chars, NaN when nothing parses.
    buf = []
    for ch in tok:
        if ch.isdigit() or ch in ".-+eE":
            buf.append(ch)
        else:
            break
    try:
        v = float("".join(buf))
    except ValueError:
        return float("nan")
    # std::stof throws out_of_range on huge literals (e.g. 1e999), which the
    # reference's tolerant parse turns into NaN.
    if v in (float("inf"), float("-inf")):
        return float("nan")
    return v


def _parse_int(tok: str) -> int:
    tok = tok.split("/", 1)[0]
    buf = []
    for ch in tok:
        if ch.isdigit() or ch in "-+eE":
            buf.append(ch)
        else:
            break
    try:
        v = int("".join(buf))
    except ValueError:
        return -1
    # std::stoi throws out_of_range beyond int range, which the reference's
    # tolerant parse turns into -1 (Python ints would overflow the int64
    # face array instead).
    if not -(2 ** 31) <= v < 2 ** 31:
        return -1
    return v


def _parse_tolerant(lines):
    vertices: list[tuple[float, float, float]] = []
    faces: list[tuple[int, int, int]] = []
    for line in lines:
        stripped = line.lstrip(" ")
        if stripped.startswith("v "):
            vals = [_parse_float(t) for t in stripped[2:].split()[:3]]
            vals += [float("nan")] * (3 - len(vals))
            vertices.append((vals[0], vals[1], vals[2]))
        elif stripped.startswith("f "):
            idx = [_parse_int(t) - 1 for t in stripped[2:].split()[:3]]
            idx += [-1] * (3 - len(idx))
            faces.append((idx[0], idx[1], idx[2]))
    return (
        np.asarray(vertices, np.float64).reshape(-1, 3),
        np.asarray(faces, np.int64).reshape(-1, 3),
    )


def _parse_fast(lines):
    """Vectorised parse of well-formed text; None if anything looks
    irregular (the caller then takes the tolerant parse)."""
    v_lines = [ln for ln in lines if ln.startswith("v ")]
    f_lines = [ln for ln in lines if ln.startswith("f ")]
    try:
        v = np.array(" ".join(ln[2:] for ln in v_lines).split(), dtype=np.float64)
        if v.size != 3 * len(v_lines):
            return None
        f = np.array([t.split("/", 1)[0] for ln in f_lines for t in ln[2:].split()],
                     dtype=np.int64)
        if f.size != 3 * len(f_lines):
            return None
        return v.reshape(-1, 3), (f.reshape(-1, 3) - 1)
    except (ValueError, OverflowError):
        return None


def _obj_text(source) -> str:
    """The OBJ text of `source`: a file object's content, a string that
    looks like OBJ text, or the content of the path it names. A string
    that is neither a readable path nor OBJ-like is parsed as text (the
    reference reads a failed ifstream as empty, ref: mesh.cpp:286), with a
    warning so a mistyped path does not pass unnoticed."""
    if hasattr(source, "read"):
        text = source.read()
    else:
        source = str(source)
        if "\n" in source or source.strip() == "" or source.lstrip().startswith(("v ", "f ", "#")):
            text = source
        else:
            try:
                with open(source, "r", errors="replace") as fh:
                    text = fh.read()
            except OSError:
                warnings.warn(f"load_mesh: {source!r} is not a readable path; "
                              "parsing it as OBJ text", stacklevel=3)
                text = source
    if isinstance(text, bytes):
        text = text.decode("utf-8", errors="replace")
    return text


def load_mesh(
    source,
    transformation: np.ndarray | None = None,
    cull_backface: bool = True,
    smooth: bool = True,
    as_batch: bool = False,
) -> list[HostTriangle] | TriangleBatch:
    """Load triangles from a path, file object, or OBJ text
    (ref API: io::loadMesh, include/PathTrace/scene/mesh.h:23-51).

    `as_batch=True` returns a columnar `TriangleBatch` instead of a list of
    `HostTriangle`s: the same triangles, without the per-object Python cost.
    Host-only: returns numpy."""
    text = _obj_text(source)
    if len(text) > NATIVE_PARSE_MIN_BYTES:
        verts, face_idx = parse_obj_native(text)
        verts = np.asarray(verts, np.float64)
    else:
        # The reference eats leading spaces before the record tag
        # (mesh.cpp:186).
        lines = [ln.lstrip(" ") for ln in text.splitlines()]
        parsed = _parse_fast(lines)
        verts, face_idx = parsed if parsed is not None else _parse_tolerant(lines)
    # Out-of-range float literals are NaN on every route (the reference's
    # stof out_of_range contract); the vectorised and native parses would
    # otherwise give inf, which face validation cannot reject.
    verts = np.where(np.isfinite(verts), verts, np.nan)
    return mesh_from_arrays(verts, face_idx, transformation,
                            cull_backface=cull_backface, smooth=smooth, as_batch=as_batch)


def mesh_from_arrays(
    verts: np.ndarray,
    face_idx: np.ndarray,
    transformation: np.ndarray | None = None,
    cull_backface: bool = True,
    smooth: bool = True,
    as_batch: bool = False,
) -> list[HostTriangle] | TriangleBatch:
    """Triangles from vertices [V,3] and 0-based faces [F,3]: the
    post-parse pipeline of `load_mesh` (transform at load, face validation,
    smooth vertex normals; ref: mesh.cpp:127-267) without the OBJ text."""
    verts = np.asarray(verts, np.float64).reshape(-1, 3)
    face_idx = np.asarray(face_idx, np.int64).reshape(-1, 3)
    mat = _IDENTITY if transformation is None else np.asarray(transformation, np.float64)
    if verts.shape[0]:
        h = np.concatenate([verts, np.ones((verts.shape[0], 1))], axis=1) @ mat.T
        verts = h[:, :3] / h[:, 3:4]
    if face_idx.shape[0] == 0 or verts.shape[0] == 0:
        # Faces without vertices are all out of range (ref: mesh.cpp:149-158).
        return TriangleBatch.empty() if as_batch else []

    if as_batch and face_idx.shape[0] >= MESH_NATIVE_MIN_FACES:
        a, b, c, na, nb, nc = mesh_pipeline_native(verts, face_idx, smooth)
    else:
        a, b, c, na, nb, nc = _mesh_pipeline_numpy(verts, face_idx, smooth)

    if as_batch:
        n = a.shape[0]
        return TriangleBatch(v0=a, v1=b, v2=c, n0=na, n1=nb, n2=nc,
                             cull=np.full(n, cull_backface, bool),
                             material=np.full(n, -1, np.int32))
    return [
        HostTriangle(a[i], b[i], c[i], cull_backface,
                     na=na[i].copy(), nb=nb[i].copy(), nc=nc[i].copy())
        for i in range(a.shape[0])
    ]


def _mesh_pipeline_numpy(verts, face_idx, smooth):
    """Face validation and (smooth) vertex normals of transformed vertices
    [V,3] f64 and faces [F,3] i64 (V, F > 0): (a, b, c, na, nb, nc), each
    [kept faces, 3] f64 and C-contiguous. `native.mesh_pipeline_native`
    does the same operations in the same order."""
    n_v = verts.shape[0]
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
    return (a, b, c, np.ascontiguousarray(na), np.ascontiguousarray(nb),
            np.ascontiguousarray(nc))
