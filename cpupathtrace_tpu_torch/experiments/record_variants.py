"""X3: the record test as a serial loop, a pairwise outer product or a
matrix product.

Port of benchmarks/experiments/exp_record_variants.py to the card: 1024 rays
(8 x 128) against K record tests of T = 128 triangles, cycling over
NREC = 32 records, with the script's tables (`make_tables`) and rays
(`make_rays`) from np.random.default_rng(0). Four variants, each returning
bt [8, 128], the running nearest t from 100:
  * serial: Moller-Trumbore per ray over a 4-record table, triangle after
    triangle;
  * outer: the pairwise Plucker test, features [T, 16] per triangle;
  * matmul: the Plucker quantities as the product [16, 5T]^T x [16, 128]
    per row of rays (on the tensor cores in the kernel, 3xTF32), then the
    test epilogue;
  * matmul_extract: matmul with the one-hot extraction of the winner's
    barycentrics on row 0.
The kernels are csrc/exp_record_variants.cu; `variant_reference` is the
plain version of each (the matmul ones with torch.matmul in float32).
`main()` prints microseconds per record test from the difference between
k_lo = 2048 and k_hi = 16384 in-kernel record tests, as the TPU script did:
the latency of one record test of all 1024 rays, run as eight blocks of
128 rays at once on 8 of the card's SMs (the TPU script's one core).

    python -m cpupathtrace_tpu_torch.experiments.record_variants
"""
from __future__ import annotations

import ctypes

import numpy as np
import torch

from .. import _build
from ..accel.kernel_traverse import check_tensor
from . import best_ms, card, need_cuda

NREC = 32
T = 128
EPS = 1e-6
ROWS, LANES = 8, 128
SER_RECS = 4
VARIANTS = ("serial", "outer", "matmul", "matmul_extract")
K_LO, K_HI = 2048, 16384
REPS = 1


def make_tables(rng, nrec):
    """The script's tables (exp_record_variants.py:31-68): matmul pf
    [nrec, 16, 5T], outer op [nrec, T, 16], serial ser [nrec, 24, T]."""
    v0 = rng.uniform(-1, 1, (nrec, T, 3)).astype(np.float32)
    e1 = rng.uniform(-0.1, 0.1, (nrec, T, 3)).astype(np.float32)
    e2 = rng.uniform(-0.1, 0.1, (nrec, T, 3)).astype(np.float32)
    n = np.cross(e1, e2)
    v0xe2 = np.cross(v0, e2)
    v0xe1 = np.cross(v0, e1)
    d0 = (v0 * n).sum(-1)
    pf = np.zeros((nrec, 16, 5 * T), np.float32)
    pf[:, 0:3, 0 * T:1 * T] = -n.transpose(0, 2, 1)
    pf[:, 3:6, 1 * T:2 * T] = e2.transpose(0, 2, 1)
    pf[:, 0:3, 1 * T:2 * T] = v0xe2.transpose(0, 2, 1)
    pf[:, 3:6, 2 * T:3 * T] = -e1.transpose(0, 2, 1)
    pf[:, 0:3, 2 * T:3 * T] = -v0xe1.transpose(0, 2, 1)
    pf[:, 6:9, 3 * T:4 * T] = n.transpose(0, 2, 1)
    pf[:, 9, 3 * T:4 * T] = -d0
    op = np.zeros((nrec, T, 16), np.float32)
    op[:, :, 0:3] = -n
    op[:, :, 3:6] = e2
    op[:, :, 6:9] = v0xe2
    op[:, :, 9:12] = -e1
    op[:, :, 12:15] = -v0xe1
    op[:, :, 15] = d0
    ser = np.zeros((nrec, 24, T), np.float32)
    ser[:, 0:3] = v0.transpose(0, 2, 1)
    ser[:, 3:6] = e1.transpose(0, 2, 1)
    ser[:, 6:9] = e2.transpose(0, 2, 1)
    ser[:, 10] = np.arange(T)[None, :]
    return pf, op, ser


def make_rays(rng):
    """rays [6, 1024]: o then d components, ray i = row * 128 + lane."""
    o = rng.uniform(-2, 2, (1024, 3)).astype(np.float32)
    d = rng.normal(size=(1024, 3)).astype(np.float32)
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    return np.ascontiguousarray(np.concatenate([o.T, d.T]).astype(np.float32))


def inputs():
    """{variant: table} and rays [6, 1024] in the script's draw order."""
    rng = np.random.default_rng(0)
    pf, op, ser = make_tables(rng, NREC)
    rays = make_rays(rng)
    tables = {"serial": np.ascontiguousarray(ser[:SER_RECS]), "outer": op,
              "matmul": pf, "matmul_extract": pf}
    return tables, rays


def _serial(ser, rays, k_iters):
    ox, oy, oz, dx, dy, dz = (rays[j][None] for j in range(6))
    bt = torch.full((rays.shape[1],), 100.0, dtype=torch.float32, device=rays.device)
    for k in range(k_iters):
        r = ser[k % SER_RECS]
        v0x, v0y, v0z, e1x, e1y, e1z, e2x, e2y, e2z = (r[j][:, None] for j in range(9))
        px = dy * e2z - dz * e2y
        py = dz * e2x - dx * e2z
        pz = dx * e2y - dy * e2x
        det = e1x * px + e1y * py + e1z * pz
        miss = det.abs() <= EPS
        inv = 1.0 / torch.where(miss, 1.0, det)
        tx, ty, tz = ox - v0x, oy - v0y, oz - v0z
        u = (tx * px + ty * py + tz * pz) * inv
        qx = ty * e1z - tz * e1y
        qy = tz * e1x - tx * e1z
        qz = tx * e1y - ty * e1x
        v = (dx * qx + dy * qy + dz * qz) * inv
        t = (e2x * qx + e2y * qy + e2z * qz) * inv
        ok = ~miss & (u >= 0) & (u <= 1) & (v >= 0) & (u + v <= 1) & (t >= 0)
        # Triangle after triangle, bt takes each passing t below it: the
        # least passing t below the record's entry value.
        bt = torch.minimum(bt, torch.where(ok, t, float("inf")).amin(0))
    return bt


def _test(det, un, vn, tn, bt):
    """The test epilogue (exp_record_variants.py:107-118): (key, su, sv, sd)."""
    sgn = torch.where(det >= 0, 1.0, -1.0)
    sd, su, sv, st = det * sgn, un * sgn, vn * sgn, tn * sgn
    inside = torch.minimum(torch.minimum(su, sv), sd - su - sv)
    ok = (inside >= 0.0) & (st >= 0.0) & (sd > EPS)
    tv = st / torch.where(ok, sd, 1.0)
    return torch.where(ok & (tv < bt), tv, float("inf")), su, sv, sd


def _outer(op, rays, k_iters):
    ox, oy, oz, dx, dy, dz = (rays[j][None] for j in range(6))
    mx, my, mz = oy * dz - oz * dy, oz * dx - ox * dz, ox * dy - oy * dx
    bt = torch.full((rays.shape[1],), 100.0, dtype=torch.float32, device=rays.device)
    for k in range(k_iters):
        c = [op[k % NREC][:, i:i + 1] for i in range(16)]
        det = c[0] * dx + c[1] * dy + c[2] * dz
        un = c[3] * mx + c[4] * my + c[5] * mz + c[6] * dx + c[7] * dy + c[8] * dz
        vn = c[9] * mx + c[10] * my + c[11] * mz + c[12] * dx + c[13] * dy + c[14] * dz
        tn = (-c[0] * ox - c[1] * oy - c[2] * oz) - c[15]
        key, *_ = _test(det, un, vn, tn, bt)
        bt = torch.minimum(bt, key.amin(0))
    return bt


def _matmul(pf, rays, k_iters, extract):
    ox, oy, oz, dx, dy, dz = (rays[j].reshape(ROWS, LANES) for j in range(6))
    feats = [dx, dy, dz, oy * dz - oz * dy, oz * dx - ox * dz, ox * dy - oy * dx, ox, oy, oz,
             torch.ones_like(ox)] + [torch.zeros_like(ox)] * 6
    a = torch.stack(feats, dim=1)  # [8, 16, 128]
    bt = torch.full((ROWS, LANES), 100.0, dtype=torch.float32, device=rays.device)
    for k in range(k_iters):
        c = torch.matmul(pf[k % NREC].t(), a)  # [8, 5T, 128], float32
        key, su, sv, sd = _test(c[:, 0:T], c[:, T:2 * T], c[:, 2 * T:3 * T], c[:, 3 * T:4 * T],
                                bt[:, None])
        tmin = key.amin(1)
        new = torch.minimum(bt, tmin)
        if extract:
            onehot = (key[0] == tmin[0][None]).to(torch.float32)
            sdw = (onehot * sd[0]).sum(0)
            uw = (onehot * su[0]).sum(0) / sdw.clamp_min(1e-30)
            vw = (onehot * sv[0]).sum(0) / sdw.clamp_min(1e-30)
            new[0] = new[0] + 1e-12 * (uw + vw)
        bt = new
    return bt.reshape(-1)


def variant_reference(variant: str, table, rays, k_iters: int):
    """The plain version of a variant: bt [1024]."""
    variant_reference.calls += 1
    if variant == "serial":
        return _serial(table, rays, k_iters)
    if variant == "outer":
        return _outer(table, rays, k_iters)
    if variant in ("matmul", "matmul_extract"):
        return _matmul(table, rays, k_iters, variant == "matmul_extract")
    raise ValueError(f"unknown variant {variant}")


variant_reference.calls = 0

_SHAPES = {"serial": (SER_RECS, 24, T), "outer": (NREC, T, 16), "matmul": (NREC, 16, 5 * T),
           "matmul_extract": (NREC, 16, 5 * T)}


def _launch_fn():
    fn = _build.load("exp_record_variants").ptx_record_variant_launch
    if fn.argtypes is None:
        p, i = ctypes.c_void_p, ctypes.c_int
        fn.argtypes = [i, p, p, p, i, p]
        fn.restype = ctypes.c_int
    return fn


def record_variant(variant: str, table, rays, k_iters: int):
    """bt [1024] of `k_iters` record tests: CPU tensors take the plain
    version, CUDA tensors launch csrc/exp_record_variants.cu."""
    dev = rays.device
    if dev.type == "cpu":
        return variant_reference(variant, table, rays, k_iters)
    if dev.type != "cuda":
        raise ValueError(f"record_variant: no kernel for device {dev}")
    check_tensor("table", table, dev, torch.float32, _SHAPES[variant])
    check_tensor("rays", rays, dev, torch.float32, (6, ROWS * LANES))
    bt = torch.empty(ROWS * LANES, dtype=torch.float32, device=dev)
    with torch.cuda.device(dev):
        err = _launch_fn()(VARIANTS.index(variant), table.data_ptr(), rays.data_ptr(),
                           bt.data_ptr(), int(k_iters), torch.cuda.current_stream(dev).cuda_stream)
    if err:
        raise RuntimeError(f"record_variant launch failed: cudaError_t {err}")
    record_variant.launches[variant] += 1
    return bt


# Launches per variant.
record_variant.launches = dict.fromkeys(VARIANTS, 0)


def record_ops(variant: str, k_iters: int) -> tuple[int, str]:
    """(operations of a call, their type): per (triangle, ray) test, the
    serial Moller-Trumbore's ~40 float operations, the outer product's ~45;
    for the matmul, the product the test needs, the 10 used features by the
    4 quantity blocks (2 * 10 * 4T * 1024 per record; the kernel's K = 16
    padding and its fifth block are not needed), three times over on the
    tensor cores (3xTF32 runs three TF32 products for float32 accuracy).
    The epilogue's ~20 float32 operations per (triangle, ray) are counted
    apart (`epilogue_ops`)."""
    tests = k_iters * T * ROWS * LANES
    if variant == "serial":
        return tests * 40, "fp32"
    if variant == "outer":
        return tests * 45, "fp32"
    return 3 * 2 * 10 * 4 * T * ROWS * LANES * k_iters, "tf32"


def epilogue_ops(variant: str, k_iters: int) -> int:
    """The matmul variants' float32 epilogue: ~20 operations per (triangle,
    ray); 0 for serial and outer, whose record_ops count it."""
    return k_iters * T * ROWS * LANES * 20 if variant.startswith("matmul") else 0


def sweep(reps: int = REPS, k_lo: int = K_LO, k_hi: int = K_HI):
    """Per variant on the card: the best launch ms at k_lo and k_hi record
    tests and the us per record test from their difference."""
    need_cuda()
    tables, rays_np = inputs()
    rays = torch.from_numpy(rays_np).cuda()
    out = {}
    for v in VARIANTS:
        table = torch.from_numpy(tables[v]).cuda()
        lo = best_ms(lambda: record_variant(v, table, rays, k_lo), reps)
        hi = best_ms(lambda: record_variant(v, table, rays, k_hi), reps)
        bt = record_variant(v, table, rays, k_lo)
        out[v] = dict(lo_ms=lo, hi_ms=hi, us_per_record=(hi - lo) / (k_hi - k_lo) * 1e3,
                      bt_mean=float(bt.mean()))
    return out


def main():
    name = card()
    for v, r in sweep().items():
        print(f"# {v:24s} lo {r['lo_ms']:8.3f} ms hi {r['hi_ms']:9.3f} ms -> "
              f"{r['us_per_record']:8.4f} us/record   bt_mean={r['bt_mean']:.4f}  ({name})",
              flush=True)


if __name__ == "__main__":
    main()
