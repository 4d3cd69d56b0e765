"""The host pipeline in C++ (csrc/mesh_native.cpp), loaded with ctypes.

Port of `cpupathtrace_tpu/native/__init__.py`, with its names and
signatures: the OBJ parser (`parse_obj_native`), the mesh pipeline
(`mesh_pipeline_native`) and the pair-record packer
(`pack_pair_records_native`, here for the port's 32-column records). The
flat BVH builder lives in `accel/build.py` (csrc/bvh_build.cpp).

The library is compiled with g++ on first use (`_build.load_host`). There
is no Python fallback: a missing g++ or a failed build raises, as the BVH
builder's does. `runs` counts the calls of each entry point, so a caller
can see which route ran.
"""
from __future__ import annotations

import ctypes

import numpy as np

from .. import _build

runs = {"parse_obj": 0, "mesh_pipeline": 0, "pack_pair_records": 0}

_F32 = ctypes.POINTER(ctypes.c_float)
_F64 = ctypes.POINTER(ctypes.c_double)
_I64 = ctypes.POINTER(ctypes.c_int64)


def _lib() -> ctypes.CDLL:
    """The built library with its C signatures declared (once)."""
    lib = _build.load_host("mesh_native")
    if lib.ptx_parse_obj.argtypes is None:
        lib.ptx_record_cols.restype = ctypes.c_int
        lib.ptx_record_cols.argtypes = []
        lib.ptx_record_used_cols.restype = ctypes.c_int
        lib.ptx_record_used_cols.argtypes = []
        lib.ptx_pack_pair_records.restype = None
        lib.ptx_pack_pair_records.argtypes = [_F32] * 9 + [ctypes.c_int64, ctypes.c_int, _F32]
        lib.ptx_mesh_pipeline.restype = ctypes.c_int64
        lib.ptx_mesh_pipeline.argtypes = [_F64, ctypes.c_int64, _I64, ctypes.c_int64,
                                          ctypes.c_int] + [_F64] * 6
        lib.ptx_count_obj.restype = None
        lib.ptx_count_obj.argtypes = [ctypes.c_char_p, ctypes.c_int64, _I64, _I64]
        lib.ptx_parse_obj.restype = None
        lib.ptx_parse_obj.argtypes = [ctypes.c_char_p, ctypes.c_int64, _F32, ctypes.c_int64,
                                      _I64, ctypes.c_int64]
    return lib


def _ptr(a, kind):
    return a.ctypes.data_as(kind)


def pack_pair_records_native(v0, v1, v2, cull, prim, mat, n0, n1, n2,
                             out: np.ndarray) -> bool:
    """Pack the pair records of [C, L, ...] cluster arrays straight into
    `out` ([C, L, 32] f32, C-contiguous and ZEROED; columns 28-31 stay
    zero), bit-equal to `accel/kernel_traverse._pack_pair_records_batch`.
    Threaded over clusters. Returns True, as the JAX package's does."""
    from ..accel.kernel_traverse import REC_COLS
    from ..accel.pair_record import REC_USED_COLS

    lib = _lib()
    if (lib.ptx_record_cols(), lib.ptx_record_used_cols()) != (REC_COLS, REC_USED_COLS):
        raise RuntimeError("csrc/mesh_native.cpp packs another record layout")
    c, l = out.shape[0], out.shape[1]
    if out.shape != (c, l, REC_COLS) or out.dtype != np.float32 or not out.flags.c_contiguous:
        raise ValueError(f"out must be a C-contiguous [C, L, {REC_COLS}] float32 array, "
                         f"not {out.shape} {out.dtype}")
    args = [np.ascontiguousarray(a, np.float32) for a in (v0, v1, v2, cull, prim, mat, n0, n1, n2)]
    for a, tail in zip(args, [(3,)] * 3 + [()] * 3 + [(3,)] * 3):
        if a.shape != (c, l) + tail:
            raise ValueError(f"input of shape {a.shape}, expected {(c, l) + tail}")
    runs["pack_pair_records"] += 1
    lib.ptx_pack_pair_records(*[_ptr(a, _F32) for a in args], c, l, _ptr(out, _F32))
    return True


def mesh_pipeline_native(verts: np.ndarray, faces: np.ndarray, smooth: bool):
    """Threaded face validation and smooth normals, bit-equal to the numpy
    pipeline of `scene/mesh.py:mesh_from_arrays`: (a, b, c, na, nb, nc),
    each [kept faces, 3] f64."""
    lib = _lib()
    verts = np.ascontiguousarray(verts, np.float64).reshape(-1, 3)
    faces = np.ascontiguousarray(faces, np.int64).reshape(-1, 3)
    n_f = faces.shape[0]
    outs = [np.empty((n_f, 3), np.float64) for _ in range(6)]
    runs["mesh_pipeline"] += 1
    n_k = lib.ptx_mesh_pipeline(_ptr(verts, _F64), verts.shape[0], _ptr(faces, _I64), n_f,
                                1 if smooth else 0, *[_ptr(o, _F64) for o in outs])
    return tuple(np.ascontiguousarray(o[:n_k]) for o in outs)


def parse_obj_native(text):
    """The OBJ `v` / `f` records of `text` (str or bytes): (verts [V, 3]
    f32, 0-based faces [F, 3] i64); an unparseable float is NaN, a bad or
    missing index -1."""
    lib = _lib()
    if isinstance(text, str):
        text = text.encode("utf-8", errors="replace")
    n = len(text)
    nv = ctypes.c_int64(0)
    nf = ctypes.c_int64(0)
    lib.ptx_count_obj(text, n, ctypes.byref(nv), ctypes.byref(nf))
    verts = np.empty((nv.value, 3), np.float32)
    faces = np.empty((nf.value, 3), np.int64)
    runs["parse_obj"] += 1
    lib.ptx_parse_obj(text, n, _ptr(verts, _F32), nv.value, _ptr(faces, _I64), nf.value)
    return verts, faces
