"""The dense pair record: a scene's whole triangle set as one table of
Plücker / Möller–Trumbore features, one row per triangle.

Numpy port of `cpupathtrace_tpu/accel/kernel_traverse.py:pack_pair_record_np`
with the same [rows, 128] layout, so the bytes compare equal. Only the first
28 columns are used; the CUDA megakernel stages just those in shared memory.

    det   = -d . N                  (N = e1 x e2)
    u_num =  m . e2 + d . (v0 x e2) (m = o x d)
    v_num = -m . e1 - d . (v0 x e1)
    t_num =  o . N  - v0 . N
"""
from __future__ import annotations

import numpy as np

PAIR_COLS = 128  # row width of the TPU layout (28 used)
REC_USED_COLS = 28
# Feature columns:
#   0:3 -N   3:6 e2   6:9 v0 x e2   9:12 -e1   12:15 -(v0 x e1)   15 v0 . N
#   16 cull flag   17 prim id   18 mat id   19:22 n0   22:25 n1   25:28 n2
C_CULL, C_PRIM, C_MAT, C_N0 = 16, 17, 18, 19


def pack_pair_record_np(v0, v1, v2, cull, prim, n0, n1, n2, mat, rows=None):
    """Pack one record [rows, PAIR_COLS] from [L <= rows, ...] triangle
    arrays; rows defaults to L padded to a multiple of 8. Padding slots
    carry N = 0 (det = 0, so they always miss) and prim = -1."""
    v0 = np.asarray(v0, np.float32)
    n_live = v0.shape[0]
    if rows is None:
        rows = max(8, -(-n_live // 8) * 8)
    if n_live > rows:
        raise ValueError(f"{n_live} triangles > record capacity {rows}")
    prim = np.asarray(prim, np.float32)
    e1 = np.asarray(v1, np.float32) - v0
    e2 = np.asarray(v2, np.float32) - v0
    n = np.cross(e1, e2)
    live = prim >= 0
    n = np.where(live[..., None], n, 0.0)

    rec = np.zeros((rows, PAIR_COLS), np.float32)
    rec[:, C_PRIM] = -1.0
    rec[:n_live, 0:3] = -n
    rec[:n_live, 3:6] = e2
    rec[:n_live, 6:9] = np.cross(v0, e2)
    rec[:n_live, 9:12] = -e1
    rec[:n_live, 12:15] = -np.cross(v0, e1)
    rec[:n_live, 15] = (v0 * n).sum(-1)
    rec[:n_live, C_CULL] = np.asarray(cull, np.float32)
    rec[:n_live, C_PRIM] = prim
    rec[:n_live, C_MAT] = np.asarray(mat, np.float32)
    rec[:n_live, C_N0:C_N0 + 3] = np.asarray(n0, np.float32)
    rec[:n_live, C_N0 + 3:C_N0 + 6] = np.asarray(n1, np.float32)
    rec[:n_live, C_N0 + 6:C_N0 + 9] = np.asarray(n2, np.float32)
    return rec


def cull_uniformity(culls) -> int:
    """Static cull class of a record: 0 = none cull, 1 = all cull,
    -1 = mixed (selects the pair test's cull rule)."""
    culls = np.asarray(culls, bool)
    if not culls.any():
        return 0
    if culls.all():
        return 1
    return -1
