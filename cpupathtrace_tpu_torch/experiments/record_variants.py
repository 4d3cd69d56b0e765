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
The kernel splits the record tests over the card: block (row, chunk) tests
one row against the contiguous range `chunk_bounds` gives its chunk, and a
second kernel folds the partial minima in chunk order (`split_model` is
the plain model of that, `block_work` the grid's map). Row 0 of
matmul_extract, whose corrections chain the record tests, needs of each
test only its least t and the one-hot sums at it and over all triangles,
which do not depend on bt: its blocks write those per test, split like
the other rows, and a scan runs the corrections in test order
(`extract_scan_model` is its plain model). `record_grid` picks the chunks
from the occupancy.

On the script's inputs the extraction never reaches bt (its correction,
1e-12 (uw + vw), is far below an ulp of a t of 0.1-100), and a minimum over
records visited again is the same, so neither a skipped extraction nor a
skipped record test would show. `check_inputs` puts row 0's rays 1e-5 in
front of a triangle, where the corrections move bt by many ulps (and
`extraction` holds their sum to the plain version's), and `counts=True`
returns the ray-record tests run on each record index.

`main()` prints microseconds per record test from the difference between
k_lo = 2048 and k_hi = 16384 in-kernel record tests, as the TPU script did:
the card's time for one record test of all 1024 rays, the tests spread
over every SM.

    python -m cpupathtrace_tpu_torch.experiments.record_variants [--parent ROOT] [--out DIR]

With --parent (a checkout of the parent commit) it also builds the
parent's exp_record_variants.cu, holds serial's and outer's outputs to it
bit for bit, and times parent, change, change, parent.
"""
from __future__ import annotations

import argparse
import ctypes
import json
import os
from pathlib import Path

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
CHECK_RECORDS = 256  # the record tests of chip_smoke.py's check and timing
START = 100.0
SUMMARY = 3  # matmul_extract: (least t, the corrections at it and over all) a test and ray
# check_inputs: row 0's rays start NEAR_DIST in front of their triangle,
# directions drawn from NEAR_SEED within NEAR_MIN_COS of its normal.
NEAR_DIST = 1e-5
NEAR_SEED = 5
NEAR_MIN_COS = 0.5
# Row 0 of the near inputs against the float64 plain version: within
# NEAR_ULPS units of float32 roundoff of the t product's magnitude
# (`near_bound`).
NEAR_ULPS = 16
# `extraction` on the near inputs: matmul_extract - matmul moves at least
# MIN_MOVED of row 0's 128 rays (the plain versions move 128 at 256 tests)
# and is within EXTRACT_ULPS ulps of bt of the plain versions' difference
# on each (the same corrections, summed in another order: each moves bt by
# about an ulp, ~200 ulps in all on some rays).
MIN_MOVED = 96
EXTRACT_ULPS = 2


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


def check_inputs():
    """The script's tables and rays [6, 1024] with row 0 (rays 0-127) moved:
    ray `lane` starts NEAR_DIST in front of the point v0 + 0.3 e1 + 0.3 e2
    of triangle `lane` of record 0 (so it hits it at t ~ 1e-5), its unit
    direction drawn from np.random.default_rng(NEAR_SEED) uniformly among
    those within acos(NEAR_MIN_COS) = 60 degrees of the triangle's normal
    (either side; by rejection), so that every float32 formulation of t
    hits that triangle. Rows 1-7 stay the script's."""
    tables, rays = inputs()
    ser = tables["serial"][0].astype(np.float64)  # [24, T]
    v0, e1, e2 = ser[0:3].T, ser[3:6].T, ser[6:9].T
    n = np.cross(e1, e2)
    n /= np.linalg.norm(n, axis=1, keepdims=True)
    rng = np.random.default_rng(NEAR_SEED)
    d = np.zeros((LANES, 3))
    for lane in range(LANES):
        while True:
            x = rng.normal(size=3)
            x /= np.linalg.norm(x)
            if abs(x @ n[lane]) >= NEAR_MIN_COS:
                break
        d[lane] = x
    o = v0 + 0.3 * e1 + 0.3 * e2 - NEAR_DIST * d
    rays = rays.copy()
    rays[0:3, :LANES] = o.T.astype(np.float32)
    rays[3:6, :LANES] = d.T.astype(np.float32)
    return tables, rays


def near_bound(pf, rays):
    """Per row-0 ray of `check_inputs`, an absolute bound on the error of a
    float32 formulation of its t on triangle `lane` of record 0: NEAR_ULPS
    x 2^-24 x (S_t + |t| S_det) / |det|, where S_t and S_det are the sums of
    the magnitudes of the products that make the t and det quantities
    (t = tn / det; tn cancels ~1e5-fold there, so float32 and float64 plain
    versions differ by up to ~10% of t). float64 numpy [128]."""
    pf = np.asarray(pf, np.float64)[0]
    ox, oy, oz, dx, dy, dz = np.asarray(rays, np.float64)[:, :LANES]
    a = np.stack([dx, dy, dz, oy * dz - oz * dy, oz * dx - ox * dz, ox * dy - oy * dx,
                  ox, oy, oz, np.ones(LANES)])
    lane = np.arange(LANES)
    det_terms = pf[:10, lane] * a
    t_terms = pf[:10, 3 * T + lane] * a
    det = det_terms.sum(0)
    t = t_terms.sum(0) / det
    mag = np.abs(t_terms).sum(0) + np.abs(t) * np.abs(det_terms).sum(0)
    return NEAR_ULPS * 2.0 ** -24 * mag / np.abs(det)


def count_slots(variant: str) -> int:
    """Entries of a `counts=True` result: the record indices (4 for serial,
    NREC otherwise), then for matmul_extract row 0's extraction passes."""
    return SER_RECS if variant == "serial" else NREC + (variant == "matmul_extract")


def expected_counts(variant: str, k_iters: int):
    """What `counts=True` must return: per record index r, (number of
    k < k_iters with k % n == r) x 1024 ray-record tests; for
    matmul_extract also k_iters x 128 extraction passes. int64 numpy."""
    n = SER_RECS if variant == "serial" else NREC
    out = np.zeros(count_slots(variant), np.int64)
    out[:n] = np.bincount(np.arange(k_iters) % n, minlength=n) * ROWS * LANES
    if variant == "matmul_extract":
        out[NREC] = k_iters * LANES
    return out


def chunk_bounds(k_iters: int, chunks: int):
    """[(k0, k1)] of each chunk: chunk c's record tests [K c / C, K (c + 1) / C),
    as the kernel's chunk_begin."""
    return [(k_iters * c // chunks, k_iters * (c + 1) // chunks) for c in range(chunks)]


def grid_blocks(chunks: int) -> int:
    """Blocks of the kernel's launch at `chunks`: a row and chunk each."""
    return ROWS * chunks


def block_work(k_iters: int, chunks: int):
    """The kernel's map, block by block in launch order: (first ray, rays,
    k0, k1) of the record tests each block runs, the row fastest."""
    bounds = chunk_bounds(k_iters, chunks)
    return [(b % ROWS * LANES, LANES) + bounds[b // ROWS] for b in range(ROWS * chunks)]


def _serial(ser, rays, ks, bt):
    ox, oy, oz, dx, dy, dz = (rays[j][None] for j in range(6))
    for k in ks:
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
        ok = ~miss & (u >= 0) & (u <= 1) & (v >= 0) & (u + v <= 1) & (t >= 0) & (t < bt)
        # Triangle after triangle, bt takes each passing t below it: the
        # least passing t below the record's entry value (a t equal to bt,
        # such as +0.0 after -0.0, never passes, as in the TPU kernel).
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


def _outer(op, rays, ks, bt):
    ox, oy, oz, dx, dy, dz = (rays[j][None] for j in range(6))
    mx, my, mz = oy * dz - oz * dy, oz * dx - ox * dz, ox * dy - oy * dx
    for k in ks:
        c = [op[k % NREC][:, i:i + 1] for i in range(16)]
        det = c[0] * dx + c[1] * dy + c[2] * dz
        un = c[3] * mx + c[4] * my + c[5] * mz + c[6] * dx + c[7] * dy + c[8] * dz
        vn = c[9] * mx + c[10] * my + c[11] * mz + c[12] * dx + c[13] * dy + c[14] * dz
        tn = (-c[0] * ox - c[1] * oy - c[2] * oz) - c[15]
        key, *_ = _test(det, un, vn, tn, bt)
        bt = torch.minimum(bt, key.amin(0))
    return bt


def _matmul(pf, rays, ks, extract, bt):
    ox, oy, oz, dx, dy, dz = (rays[j].reshape(ROWS, LANES) for j in range(6))
    feats = [dx, dy, dz, oy * dz - oz * dy, oz * dx - ox * dz, ox * dy - oy * dx, ox, oy, oz,
             torch.ones_like(ox)] + [torch.zeros_like(ox)] * 6
    a = torch.stack(feats, dim=1)  # [8, 16, 128]
    bt = bt.reshape(ROWS, LANES)
    for k in ks:
        c = torch.matmul(pf[k % NREC].t(), a)  # [8, 5T, 128], float32
        key, su, sv, sd = _test(c[:, 0:T], c[:, T:2 * T], c[:, 2 * T:3 * T], c[:, 3 * T:4 * T],
                                bt[:, None])
        tmin = key.amin(1)
        new = torch.minimum(bt, tmin)
        if extract:
            onehot = (key[0] == tmin[0][None]).to(pf.dtype)
            sdw = (onehot * sd[0]).sum(0)
            uw = (onehot * su[0]).sum(0) / sdw.clamp_min(1e-30)
            vw = (onehot * sv[0]).sum(0) / sdw.clamp_min(1e-30)
            new[0] = new[0] + 1e-12 * (uw + vw)
        bt = new
    return bt.reshape(-1)


def _run(variant, table, rays, ks, bt=None):
    """The plain version over the record tests `ks` from bt (100 when None)."""
    if bt is None:
        bt = torch.full((rays.shape[1],), START, dtype=rays.dtype, device=rays.device)
    if variant == "serial":
        return _serial(table, rays, ks, bt)
    if variant == "outer":
        return _outer(table, rays, ks, bt)
    if variant in ("matmul", "matmul_extract"):
        return _matmul(table, rays, ks, variant == "matmul_extract", bt)
    raise ValueError(f"unknown variant {variant}")


def variant_reference(variant: str, table, rays, k_iters: int, counts: bool = False):
    """The plain version of a variant: bt [1024], and with `counts` the
    ray-record tests it ran per record index (`expected_counts`' layout,
    int64 on the rays' device)."""
    variant_reference.calls += 1
    bt = _run(variant, table, rays, range(k_iters))
    if not counts:
        return bt
    n = SER_RECS if variant == "serial" else NREC
    cnt = torch.zeros(count_slots(variant), dtype=torch.int64, device=rays.device)
    for k in range(k_iters):
        cnt[k % n] += rays.shape[1]
        if variant == "matmul_extract":
            cnt[NREC] += LANES
    return bt, cnt


variant_reference.calls = 0


def combine_minimum(acc, part):
    """The combine's fold step (the kernel's combine_kernel): the first of
    equal values stays, as in the sequential loop, where a t passes only
    below the running bt (so -0.0 found before +0.0 stays, and the other
    way round)."""
    return torch.where(part < acc, part, acc)


def _correction(su, sv, sd):
    """The script's correction 1e-12 (uw + vw) from one-hot sums."""
    return 1e-12 * (su / sd.clamp_min(1e-30) + sv / sd.clamp_min(1e-30))


def extract_scan_model(pf, rays, k_iters: int):
    """The plain model of matmul_extract's row 0 in the kernel: per record
    test, without bt, the least t m0 of each ray (`_test` with bt = inf) and
    the corrections from the one-hot sums of su, sv, sd at it and over every
    triangle; then in test order from 100: the filter passes m0 iff
    m0 < bt (every t of the record is >= m0), the correction is the one at
    m0 then, else the one over all (every key inf). bt [128], the plain
    version's bits."""
    ox, oy, oz, dx, dy, dz = (rays[j].reshape(ROWS, LANES) for j in range(6))
    a = torch.stack([dx, dy, dz, oy * dz - oz * dy, oz * dx - ox * dz, ox * dy - oy * dx, ox,
                     oy, oz, torch.ones_like(ox)] + [torch.zeros_like(ox)] * 6, dim=1)
    bt = torch.full((LANES,), START, dtype=rays.dtype, device=rays.device)
    for k in range(k_iters):
        c = torch.matmul(pf[k % NREC].t(), a)[0]  # row 0 of the plain version's product
        t, su, sv, sd = _test(c[0:T], c[T:2 * T], c[2 * T:3 * T], c[3 * T:4 * T], float("inf"))
        m0 = t.amin(0)
        at = (t == m0[None]).to(pf.dtype)
        c_at = _correction(*((at * x).sum(0) for x in (su, sv, sd)))
        c_all = _correction(su.sum(0), sv.sum(0), sd.sum(0))
        hit = m0 < bt
        bt = torch.minimum(bt, torch.where(hit, m0, float("inf"))) + torch.where(hit, c_at, c_all)
    return bt


def split_model(variant: str, table, rays, k_iters: int, chunks: int, row0_split: bool = False,
                combine=combine_minimum):
    """The plain model of the kernel: each chunk of `chunk_bounds` runs the
    plain version over its record tests from 100 (+inf where it has none),
    then the partials are folded from 100 in chunk order by `combine`.
    matmul_extract's row 0 is `extract_scan_model`'s, unless `row0_split`,
    which folds it like the other rows. bt [1024]."""
    partials = []
    for k0, k1 in chunk_bounds(k_iters, chunks):
        if k0 == k1:
            partials.append(torch.full((rays.shape[1],), float("inf"), dtype=rays.dtype,
                                       device=rays.device))
        else:
            partials.append(_run(variant, table, rays, range(k0, k1)))
    bt = torch.full((rays.shape[1],), START, dtype=rays.dtype, device=rays.device)
    for p in partials:
        bt = combine(bt, p)
    if variant == "matmul_extract" and not row0_split:
        bt[:LANES] = extract_scan_model(table, rays, k_iters)
    return bt


_SHAPES = {"serial": (SER_RECS, 24, T), "outer": (NREC, T, 16), "matmul": (NREC, 16, 5 * T),
           "matmul_extract": (NREC, 16, 5 * T)}


def _bind(lib):
    """ptx_record_variant_launch and _occupancy of `lib`, argtypes set."""
    p, i = ctypes.c_void_p, ctypes.c_int
    launch, occ = lib.ptx_record_variant_launch, lib.ptx_record_variant_occupancy
    if launch.argtypes is None:
        # variant table rays bt k_iters chunks partial summary counts stream
        launch.argtypes = [i, p, p, p, i, i, p, p, p, p]
        launch.restype = i
        occ.argtypes = [i] + [ctypes.POINTER(i)] * 3
        occ.restype = i
    return launch, occ


_OCCUPANCY: dict = {}


def occupancy(variant: str, lib=None):
    """The timed instance of `variant` on the current card: dict(blocks_per_sm,
    threads, smem, sms), queried once per library, card and variant."""
    lib = _build.load("exp_record_variants") if lib is None else lib
    dev = torch.cuda.current_device()
    key = (id(lib), dev, variant)
    if key not in _OCCUPANCY:
        out = [ctypes.c_int(0) for _ in range(3)]
        err = _bind(lib)[1](VARIANTS.index(variant), *(ctypes.byref(v) for v in out))
        if err:
            raise RuntimeError(f"record_variant occupancy query failed: cudaError_t {err}")
        _OCCUPANCY[key] = dict(blocks_per_sm=out[0].value, threads=out[1].value,
                               smem=out[2].value,
                               sms=torch.cuda.get_device_properties(dev).multi_processor_count)
    return _OCCUPANCY[key]


def chunks_for(k_iters: int, resident: int) -> int:
    """The chunks the wrapper launches: one wave of `resident` blocks over
    the rows, at least 1, at most one record test a chunk."""
    return max(1, min(k_iters, resident // ROWS))


def record_grid(variant: str, k_iters: int, lib=None):
    """(blocks, chunks) of the wrapper's launch on the current card."""
    occ = occupancy(variant, lib)
    chunks = chunks_for(k_iters, occ["blocks_per_sm"] * occ["sms"])
    return grid_blocks(chunks), chunks


def _launch(lib, variant, table, rays, k_iters, chunks, counts):
    dev = rays.device
    launch = _bind(lib)[0]
    v = VARIANTS.index(variant)
    bt = torch.empty(ROWS * LANES, dtype=torch.float32, device=dev)
    partials = torch.empty((int(chunks), ROWS * LANES), dtype=torch.float32, device=dev)
    summary = torch.empty((max(1, int(k_iters)), SUMMARY, LANES), dtype=torch.float32, device=dev) \
        if variant == "matmul_extract" else None
    cnt = torch.zeros(count_slots(variant), dtype=torch.int64, device=dev) if counts else None
    with torch.cuda.device(dev):
        err = launch(v, table.data_ptr(), rays.data_ptr(), bt.data_ptr(), int(k_iters),
                     int(chunks), partials.data_ptr(),
                     None if summary is None else summary.data_ptr(),
                     None if cnt is None else cnt.data_ptr(),
                     torch.cuda.current_stream(dev).cuda_stream)
    if err:
        raise RuntimeError(f"record_variant launch failed: cudaError_t {err}")
    return (bt, cnt) if counts else bt


def record_variant(variant: str, table, rays, k_iters: int, counts: bool = False,
                   chunks: int | None = None):
    """bt [1024] of `k_iters` record tests (and with `counts` the ray-record
    tests per record index, as `expected_counts`): CPU tensors take the
    plain version, CUDA tensors launch csrc/exp_record_variants.cu with
    `chunks` (None: `record_grid`'s)."""
    dev = rays.device
    if dev.type == "cpu":
        return variant_reference(variant, table, rays, k_iters, counts)
    if dev.type != "cuda":
        raise ValueError(f"record_variant: no kernel for device {dev}")
    if variant not in VARIANTS:
        raise ValueError(f"unknown variant {variant}")
    check_tensor("table", table, dev, torch.float32, _SHAPES[variant])
    check_tensor("rays", rays, dev, torch.float32, (6, ROWS * LANES))
    if table.data_ptr() % 16:
        raise ValueError("record_variant: the table must be 16-byte aligned (bulk copies)")
    if k_iters < 0 or (chunks is not None and chunks < 1):
        raise ValueError(f"record_variant: k_iters {k_iters}, chunks {chunks}")
    lib = _build.load("exp_record_variants")
    if chunks is None:
        with torch.cuda.device(dev):
            chunks = record_grid(variant, k_iters, lib)[1]
    out = _launch(lib, variant, table, rays, k_iters, chunks, counts)
    record_variant.launches[variant] += 1
    return out


# Launches per variant.
record_variant.launches = dict.fromkeys(VARIANTS, 0)


def record_ops(variant: str, k_iters: int) -> tuple[int, str]:
    """(operations of a call, their type): per (triangle, ray) test, the
    serial Moller-Trumbore's ~40 float operations, the outer product's ~45;
    for the matmul, the product the test needs, the 10 used features by the
    4 quantity blocks (2 * 10 * 4T * 1024 per record; the kernel's K = 16
    padding is not needed), three times over on the tensor cores (3xTF32
    runs three TF32 products for float32 accuracy). The epilogue's ~20
    float32 operations per (triangle, ray) are counted apart
    (`epilogue_ops`)."""
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


class LibParent:
    """X3 from a parent commit's library of exp_record_variants.cu, through
    its C interface (variant, table, rays, bt, k_iters, stream)."""

    def __init__(self, path):
        self.lib = ctypes.CDLL(str(path))
        fn = self.lib.ptx_record_variant_launch
        p, i = ctypes.c_void_p, ctypes.c_int
        fn.argtypes = [i, p, p, p, i, p]
        fn.restype = i

    def __call__(self, variant, table, rays, k_iters):
        bt = torch.empty(ROWS * LANES, dtype=torch.float32, device=rays.device)
        err = self.lib.ptx_record_variant_launch(
            VARIANTS.index(variant), table.data_ptr(), rays.data_ptr(), bt.data_ptr(),
            int(k_iters), torch.cuda.current_stream().cuda_stream)
        if err:
            raise RuntimeError(f"parent record_variant launch failed: cudaError_t {err}")
        return bt


def sweep(reps: int = REPS, k_lo: int = K_LO, k_hi: int = K_HI, run=None):
    """Per variant on the card: the best launch ms at k_lo and k_hi record
    tests and the us per record test from their difference, and the best of
    5 launches at CHECK_RECORDS (`check_ms`). `run(variant, table, rays,
    k_iters)` is the launch timed (`record_variant` when None)."""
    need_cuda()
    run = record_variant if run is None else run
    tables, rays_np = inputs()
    rays = torch.from_numpy(rays_np).cuda()
    out = {}
    for v in VARIANTS:
        table = torch.from_numpy(tables[v]).cuda()
        lo = best_ms(lambda: run(v, table, rays, k_lo), reps)
        hi = best_ms(lambda: run(v, table, rays, k_hi), reps)
        bt = run(v, table, rays, k_lo)
        out[v] = dict(lo_ms=lo, hi_ms=hi, us_per_record=(hi - lo) / (k_hi - k_lo) * 1e3,
                      bt_mean=float(bt.mean()),
                      check_ms=best_ms(lambda: run(v, table, rays, CHECK_RECORDS), 5))
    return out


def check(variant: str, table, rays, k_iters: int, near: bool, chunks: int | None = None):
    """The kernel against the plain version on the card: bt within rtol 1e-6
    (serial, outer: the same float32 operations) or 1e-5 (matmul: 3xTF32
    against a float32 product); on the near inputs, the matmul variants'
    row 0 instead within `near_bound` of the float64 plain version (their
    t there is ill-conditioned); the counts equal to `expected_counts`.
    Returns (bt, figures); raises where a check fails."""
    k, kc = record_variant(variant, table, rays, k_iters, counts=True, chunks=chunks)
    p, pc = variant_reference(variant, table, rays, k_iters, counts=True)
    rtol = 1e-6 if variant in ("serial", "outer") else 1e-5
    lo = LANES if near and variant.startswith("matmul") else 0
    ok = bool(torch.allclose(k[lo:], p[lo:], rtol=rtol, atol=0.0))
    fig = dict(k_iters=k_iters, hits=int((k < START).sum()),
               max_rel_err=float(((k[lo:] - p[lo:]).abs() / p[lo:].abs()).max()))
    if lo:
        p64 = _run(variant, table.double(), rays.double(), range(k_iters)).cpu().numpy()
        err = np.abs(k[:LANES].double().cpu().numpy() - p64[:LANES])
        bound = near_bound(table.cpu().numpy(), rays.cpu().numpy())
        fig.update(row0_err_over_bound=float((err / bound).max()))
        ok = ok and bool((err <= bound).all())
    counts_ok = np.array_equal(kc.cpu().numpy(), expected_counts(variant, k_iters)) and \
        torch.equal(kc, pc)
    if not (ok and counts_ok and (fig["hits"] > 0 or k_iters == 0)):
        raise RuntimeError(f"X3 {variant} differs from its plain version "
                           f"({'near' if near else 'script'} inputs, chunks {chunks}): {fig}, "
                           f"counts {kc.tolist()}")
    return k, fig


def extraction(table, rays, k_iters: int, near: bool, run=None):
    """matmul_extract - matmul of `run` (`record_variant` when None) against
    the plain versions' difference: dict(row0_moved, rest_moved: the rays of
    row 0 and of rows 1-7 whose bt the extraction moved, plain_row0_moved,
    row0_err_ulps: the largest |difference - the plain one| on row 0 in
    ulps of bt). Raises unless rows 1-7 stay and, on the near inputs, at
    least MIN_MOVED row-0 rays move with row0_err_ulps <= EXTRACT_ULPS (on
    the script's inputs the corrections are below an ulp: none moves)."""
    run = record_variant if run is None else run
    e, m = run("matmul_extract", table, rays, k_iters), run("matmul", table, rays, k_iters)
    pe = variant_reference("matmul_extract", table, rays, k_iters)
    pm = variant_reference("matmul", table, rays, k_iters)
    e, m, pe, pm = (np.asarray(x.cpu().numpy()) for x in (e, m, pe, pm))
    moved = e != m
    d = e[:LANES].astype(np.float64) - m[:LANES]
    dp = pe[:LANES].astype(np.float64) - pm[:LANES]
    ulp = np.maximum(np.spacing(np.abs(m[:LANES])), np.spacing(np.abs(pm[:LANES])))
    out = dict(row0_moved=int(moved[:LANES].sum()), rest_moved=int(moved[LANES:].sum()),
               plain_row0_moved=int((pe[:LANES] != pm[:LANES]).sum()),
               row0_err_ulps=float((np.abs(d - dp) / ulp).max()))
    ok = out["rest_moved"] == 0 and (
        out["row0_moved"] >= MIN_MOVED and out["row0_err_ulps"] <= EXTRACT_ULPS if near
        else out["row0_moved"] == 0)
    if not ok:
        raise RuntimeError(f"X3's extraction on the {'near' if near else 'script'} inputs: {out}")
    return out


def main():
    ap = argparse.ArgumentParser(description="X3's sweep (with --parent, the parent's beside)")
    ap.add_argument("--parent", help="a checkout of the parent commit: its X3 beside")
    ap.add_argument("--out", help="also write the figures there (record_variants_sweep.json)")
    args = ap.parse_args()
    need_cuda()
    name = card()
    runs = {"change": record_variant}
    if args.parent:
        from .dense_sweep import compile_all

        src = (Path(args.parent).resolve() / "cpupathtrace_tpu_torch" / "csrc" /
               "exp_record_variants.cu")
        sweep_dir = _build.BUILD_DIR / "sweep"
        sweep_dir.mkdir(parents=True, exist_ok=True)
        path = sweep_dir / "libexp_record_variants_parent.so"
        compile_all([(src, path, list(_build.NVCC_FLAGS))])
        runs["parent"] = LibParent(path)
    figures = {"card": name, "layout": {}, "parent_equal": {}, "turns": []}
    for v in VARIANTS:
        blocks, chunks = record_grid(v, K_LO)
        figures["layout"][v] = dict(occupancy(v), blocks_at_k_lo=blocks, chunks_at_k_lo=chunks,
                                    chunks_at_256=record_grid(v, 256)[1])
    if args.parent:  # serial and outer must give the parent's bits
        for inp, (tables, rays_np) in (("script", inputs()), ("near", check_inputs())):
            rays = torch.from_numpy(rays_np).cuda()
            for v in ("serial", "outer"):
                table = torch.from_numpy(tables[v]).cuda()
                a, b = record_variant(v, table, rays, 256), runs["parent"](v, table, rays, 256)
                same = torch.equal(a.view(torch.int32), b.view(torch.int32))
                figures["parent_equal"][f"{v} {inp}"] = same
                if not same:
                    raise RuntimeError(f"X3 {v} differs from the parent's kernel on the {inp} "
                                       f"inputs")
    order = ["parent", "change", "change", "parent"] if args.parent else ["change"]
    for who in order:
        figures["turns"].append(dict(run=who, sweep=sweep(run=runs[who])))
    for turn in figures["turns"]:
        for v, r in turn["sweep"].items():
            print(f"# {turn['run']:6s} {v:16s} lo {r['lo_ms']:8.3f} ms hi {r['hi_ms']:9.3f} ms "
                  f"-> {r['us_per_record']:8.4f} us/record, {CHECK_RECORDS} tests "
                  f"{r['check_ms']:8.4f} ms   bt_mean={r['bt_mean']:.4f}  ({name})", flush=True)
    print(json.dumps(figures, default=float), flush=True)
    if args.out:
        os.makedirs(args.out, exist_ok=True)
        with open(os.path.join(args.out, "record_variants_sweep.json"), "w") as f:
            json.dump(figures, f, indent=1, default=float)


if __name__ == "__main__":
    main()
