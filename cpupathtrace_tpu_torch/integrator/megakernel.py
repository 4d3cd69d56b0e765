"""The path-trace megakernel (K1) and its plain-torch twin.

`trace_megakernel` runs the whole estimator for a batch of rays in one CUDA
launch (csrc/megakernel.cu, the port of `_make_megakernel` in
cpupathtrace_tpu/integrator/pallas_megakernel.py, while-loop form): nearest
hit, material, emission, roulette, NEE over the point lights and `em_k`
CDF-drawn emitters with shadow rays, then the BSDF sample (Lambertian,
Fresnel glass, mirror), up to `max_depth` bounces.

`trace_megakernel_reference` is the twin: the same arithmetic in the same
order over flat [R] tensors, with the same random stream (integrator/rng.py)
and the same draw order. The tests hold it against the JAX kernel on the
CPU; chip_smoke.py holds the CUDA kernel against it on the card. The wrapper
calls it only for tensors that lie on the CPU: a CUDA tensor launches the
kernel or raises.

Both dense forms are covered: the pair-record form (1..128 triangles ride
`scene.krn_big_pair`, spheres the sphere table) and the table form
(triangle table + spheres; scenes without triangles); and the binned form
(n_super > 0): spheres, the big-partition pair record, then the cluster
traversal of accel/kernel_traverse.py, its seed keyed on 8 x 128-ray blocks
as the TPU's. The film runs the binned form with PTX_SORTED_WAVEFRONT=0;
binned scenes take the sorted driver by default. The twin's bounce
(`_bounce`) is also the plain version of the single-bounce kernel K2
(integrator/sorted_wavefront.py).

`debug_visits` (binned scenes; the JAX package's profiling counters): the
per-ray traversal counts of csrc/cluster_traverse.cuh, summed per block of
1024 rays: [n_blocks, 9] int32 columns nearest supercluster descends,
nearest record visits, shadow supercluster descends, shadow record visits
(the JAX package's four), then nearest slab tests, nearest filled rows
tested, shadow slab tests, shadow filled rows tested (the walks' work) and
the nearest queries, one per ray-bounce (accel/kernel_traverse.py
GEO_VISIT_COLS). The TPU counted per ray block (a block descended when any
lane needed it), so the numbers do not compare with the JAX package's.
On the card the counting form also adds the walks' warp steps to
`warp_steps` ([3] int64: slab-test steps, filled-row steps, served
record streams; kernel_traverse.warp_utilisation), which no plain version reproduces.

Both forms launch only the resident blocks (`resident_grid`, from the
instance's occupancy, queried once per card and size by
`resident_blocks`), whose warps refill their free lanes from a counter
(csrc/megakernel.cu); the output starts as NaN, so a ray that no lane
traced shows. Binned blocks and K2's hold each thread's ring of record
rows and cluster boxes in shared memory beside the tables, sized by
`KernelScene.smem_bytes`. On the card the dense form counts its warps'
bounce steps and ray-bounces into `bounce_steps` (`lane_use`). Each trace
call builds one `kernel_scene`, whose `SceneArgs` every K1 and K2 launch of
it takes (csrc/scene_args.cuh).
"""
from __future__ import annotations

import ctypes
import os

import torch

from .. import _build
from ..accel.kernel_traverse import (
    GEO_VISIT_COLS,
    NEAR_COLS,
    QUERY_COL,
    SHADOW_COLS,
    VISIT_BLOCK,
    WALK_COLS,
    WARP_LANES,
    WARP_STEP_COLS,
    ClusterTables,
    block_sums,
    check_tables,
    check_tensor,
    cluster_tables,
    kernel_smem_bytes,
    kernel_tables,
    pair_quantities,
    resident_grid,
    traverse_clusters,
    traverse_clusters_anyhit,
    walk_layout,
)
from ..accel.pair_record import C_MAT, C_N0, C_PRIM, REC_USED_COLS
from ..ops.intersect import table_nearest
from ..scene.scene import BSDF_GLASS, BSDF_MIRROR, SceneData
from ..utils.math import PI
from ..utils.profiling import trace_annotation
from .rng import BINNED_BLOCK_ROWS, BLOCK_ROWS, next_u01, seed_rng

PD_CUTOFF = 1e-20

# Table row layouts (all f32), as pallas_megakernel.py:80-93:
# tri: v0(0:3) e1(3:6) e2(6:9) cull(9) valid(10) n0(11:14) n1(14:17) n2(17:20)
#      mat(20)
TRI_COLS = 24
# sph: center(0:3) radius(3) valid(4) mat(5)
SPH_COLS = 8
# mat: diffuse(0:3) specular(3:6) ior(6) emission(7:10) bsdf(10) one_way(11)
MAT_COLS = 12
# light (point): pos(0:3) spectrum(3:6)
LGT_COLS = 8
# emissive: cdf(0) sel_p(1) is_sphere(2) v0|center(3:6) e1|radius(6:9)
# e2(9:12) face_normal(12:15) pd_area(15) cull(16) emission(17:20)
EM_COLS = 24

# H100 limits of the CUDA kernel. Every table lives in the block's shared
# memory (at most 14.3 KB record + 48 KB triangle table + 2 KB spheres +
# 12 KB materials + 2 KB lights + 24 KB emitters), and each row is one
# per-thread loop iteration per bounce.
MAX_REC_ROWS = 128
MAX_TRI = 512
MAX_SPH = 64
MAX_MAT = 256
MAX_LIGHTS = 64
MAX_EM = 256

# The JAX package's ablation switches, read at import as
# pallas_megakernel.py:275 and :321-323 read them (profiling only: each
# takes a part of the bounce out, so a frame's time can be split among
# them). PTX_SKIP_TRAVERSE=1 skips the cluster walks (binned scenes);
# PTX_ABLATE is a comma-separated set of "nee" (no point lights and no
# emitter draws), "bigpair" (no big-partition pair tests), "prop" (the
# straight-through ray in place of the sampled bounce) and "mat" (JAX's
# constant material in place of the gather); unknown tokens are ignored.
# The wrappers and the twin read these attributes at each call, so tests
# can set them on both packages.
_SKIP_TRAVERSE = os.environ.get("PTX_SKIP_TRAVERSE", "") == "1"
_ABLATE = frozenset(x for x in os.environ.get("PTX_ABLATE", "").split(",") if x)
# Bits of the kernels' ablation mask (csrc/bounce_body.cuh kAblate*).
ABLATE_BITS = {"nee": 1, "bigpair": 2, "prop": 4, "mat": 8}
SKIP_TRAVERSE_BIT = 16
# "mat": pallas_megakernel.py:465-471's material row (diffuse 0.5,
# specular 0, ior 1.5, emission 0.05, bsdf 0, one_way 0), in MAT_COLS order.
ABLATED_MATERIAL = (0.5, 0.5, 0.5, 0.0, 0.0, 0.0, 1.5, 0.05, 0.05, 0.05, 0.0, 0.0)


def ablation_mask(binned: bool) -> int:
    """The kernels' ablation bits from the switches as they stand at the
    call (0: the default instances run). PTX_SKIP_TRAVERSE counts for a
    binned scene only: a dense scene has no walk to skip."""
    mask = 0
    for name, bit in ABLATE_BITS.items():
        if name in _ABLATE:
            mask |= bit
    if _SKIP_TRAVERSE and binned:
        mask |= SKIP_TRAVERSE_BIT
    return mask


def megakernel_supported(scene: SceneData) -> bool:
    """True when the scene's tables fit the kernels' limits
    (pallas_megakernel.py:957-979). A scene with traversal tiers (binned)
    needs its big partition in the one pair record and its emitters in
    that dense part; any other scene, whatever its accelerator, needs its
    triangles in the pair record or the MAX_TRI-row triangle table."""
    if scene.has_kernel_records:
        tri_ok = (scene.dense_pair and scene.n_big <= MAX_REC_ROWS
                  and scene.emissive_in_dense)
    elif scene.dense_pair:
        tri_ok = scene.krn_big_pair.shape[0] <= MAX_REC_ROWS
    else:
        tri_ok = scene.tri_v0.shape[0] <= MAX_TRI
    return (
        tri_ok
        and scene.sph_center.shape[0] <= MAX_SPH
        and scene.num_materials <= MAX_MAT
        and scene.n_point_lights <= MAX_LIGHTS
        and scene.n_emissive <= MAX_EM
    )


def check_warp_steps(warp_steps, device):
    """The warp-step output of a counting launch: zeroed by the caller,
    [WARP_STEP_COLS] int64 on the card."""
    if device.type != "cuda":
        raise ValueError("warp_steps: the warps' steps are counted on the card only")
    check_tensor("warp_steps", warp_steps, device, torch.int64, (WARP_STEP_COLS,))


def pack_tables(scene: SceneData):
    """The kernel's tables (tri, sph, mat, lgt, em) on the scene's device,
    equal to the JAX `_pack_tables` (pallas_megakernel.py:982-1098). For a
    binned scene the triangle table holds the big partition only. The
    material columns are packed from detached copies: no graph reaches
    the kernels' tables (gradients go through the replay)."""
    f32 = torch.float32
    dev = scene.device

    def col(x):
        return x.to(f32)[:, None]

    def zeros(n, c):
        return torch.zeros((n, c), dtype=f32, device=dev)

    if scene.has_kernel_records:
        idx = scene.big_prim.clamp_min(0).long()
        tv0, tv1, tv2 = scene.big_v0, scene.big_v1, scene.big_v2
        t_cull, t_valid = scene.big_cull, scene.big_prim >= 0
        tn0, tn1, tn2 = scene.tri_n0[idx], scene.tri_n1[idx], scene.tri_n2[idx]
        t_mat = scene.tri_material[idx]
    else:
        tv0, tv1, tv2 = scene.tri_v0, scene.tri_v1, scene.tri_v2
        t_cull, t_valid = scene.tri_cull, scene.tri_valid
        tn0, tn1, tn2 = scene.tri_n0, scene.tri_n1, scene.tri_n2
        t_mat = scene.tri_material
    tri = torch.cat(
        [
            tv0, tv1 - tv0, tv2 - tv0, col(t_cull), col(t_valid),
            tn0, tn1, tn2, col(t_mat), zeros(tv0.shape[0], TRI_COLS - 21),
        ],
        dim=1,
    )
    # The emitter rows below resolve global prim ids through the full
    # triangle arrays, binned or not.
    tri_v0 = scene.tri_v0
    n_rows = tri_v0.shape[0]
    s_rows = scene.sph_center.shape[0]
    sph = torch.cat(
        [
            scene.sph_center, col(scene.sph_radius), col(scene.sph_valid),
            col(scene.sph_material), zeros(s_rows, SPH_COLS - 6),
        ],
        dim=1,
    )
    mat_diffuse = scene.mat_diffuse.detach()
    mat_specular = scene.mat_specular.detach()
    mat_emission = scene.mat_emission.detach()
    mat = torch.cat(
        [
            mat_diffuse[:, :3], mat_specular[:, :3],
            col(scene.mat_ior), mat_emission[:, :3],
            col(scene.mat_bsdf), col(scene.mat_one_way),
        ],
        dim=1,
    )
    l_rows = scene.light_pos.shape[0]
    lgt = torch.cat(
        [scene.light_pos, scene.light_spectrum[:, :3], zeros(l_rows, LGT_COLS - 6)],
        dim=1,
    )
    # Emissive rows fully pre-resolved (geometry, pdf, emission).
    cdf = scene.emissive_cdf
    e_rows = cdf.shape[0]
    prob = torch.diff(torch.cat([torch.zeros(1, dtype=f32, device=dev), cdf]))
    prim = scene.emissive_prim.long()
    is_sph = prim >= scene.n_tri
    ti = prim.clamp(0, n_rows - 1)
    si = (prim - scene.n_tri).clamp(0, s_rows - 1)
    v0 = torch.where(is_sph[:, None], scene.sph_center[si], tri_v0[ti])
    e1t = scene.tri_v1[ti] - tri_v0[ti]
    e2t = scene.tri_v2[ti] - tri_v0[ti]
    radius = scene.sph_radius[si]
    e1 = torch.where(
        is_sph[:, None],
        torch.stack([radius, torch.zeros_like(radius), torch.zeros_like(radius)], -1),
        e1t,
    )
    e2 = torch.where(is_sph[:, None], torch.zeros_like(e2t), e2t)
    fn = torch.stack(
        [
            e1t[:, 1] * e2t[:, 2] - e1t[:, 2] * e2t[:, 1],
            e1t[:, 2] * e2t[:, 0] - e1t[:, 0] * e2t[:, 2],
            e1t[:, 0] * e2t[:, 1] - e1t[:, 1] * e2t[:, 0],
        ],
        -1,
    )
    area2 = torch.sqrt(fn[:, 0] * fn[:, 0] + fn[:, 1] * fn[:, 1] + fn[:, 2] * fn[:, 2])
    fn = fn / area2.clamp_min(1e-30)[:, None]
    pd_area = torch.where(
        is_sph,
        1.0 / (4.0 * PI * (radius * radius)).clamp_min(1e-30),
        1.0 / (area2 * 0.5).clamp_min(1e-30),
    )
    cull = torch.where(is_sph, torch.zeros_like(is_sph), scene.tri_cull[ti])
    mid = torch.where(is_sph, scene.sph_material[si], scene.tri_material[ti]).long()
    emission = mat_emission[mid][:, :3]
    em = torch.cat(
        [
            cdf[:, None], (prob * float(scene.emissive_sample_count))[:, None],
            col(is_sph), v0, e1, e2, fn, pd_area[:, None], col(cull),
            emission, zeros(e_rows, EM_COLS - 20),
        ],
        dim=1,
    )
    return tri, sph, mat, lgt, em


_P = ctypes.c_void_p
_I = ctypes.c_int


class SceneArgs(ctypes.Structure):
    """The kernels' view of a scene as K1 and K2 take it: the ctypes mirror
    of csrc/scene_args.cuh `SceneArgs`, field for field. `tier_floats`
    stays 0: each launch derives it (scene_args.cuh launch_scene)."""

    _fields_ = [("tri", _P), ("n_tri", _I), ("sph", _P), ("n_sph", _I), ("mat", _P),
                ("n_mat", _I), ("lgt", _P), ("n_lights", _I), ("em", _P), ("n_em", _I),
                ("em_k", _I), ("rec", _P), ("rec_rows", _I), ("rec_stride", _I),
                ("rec_cull", _I), ("binned", _I), ("cl", ClusterTables), ("tier_floats", _I)]


class KernelScene:
    """The kernels' view of `scene` on its `device`, checked once a trace
    and handed to each launch (K1, K2) and twin of it: `tables`
    (pack_tables' tri, sph, mat, lgt, em), a binned scene's `clusters`
    (kernel_tables), the pair record `rec` (None in the table form) and
    `args`, the SceneArgs each launch takes by pointer; it keeps every
    tensor whose pointer `args` holds. Raises ValueError on a table
    without the kernels' layout."""

    def __init__(self, scene: SceneData, tables):
        self.device = dev = scene.device
        self.tables = tri, sph, mat, lgt, em = tuple(tables)
        for name, t, c in zip(("tri", "sph", "mat", "lgt", "em"), self.tables,
                              (TRI_COLS, SPH_COLS, MAT_COLS, LGT_COLS, EM_COLS)):
            check_tensor(name, t, dev, torch.float32, (None, c))
        self.binned = scene.has_kernel_records
        self.clusters = kernel_tables(scene) if self.binned else None
        cl = ClusterTables(cull=-1)
        if self.binned:
            check_tables(self.clusters, dev)
            cl = cluster_tables(self.clusters, scene.krn_cull_mode)
        self.rec = rec = scene.krn_big_pair if scene.dense_pair else None
        if rec is not None:
            check_tensor("krn_big_pair", rec, dev, torch.float32, (None, None))
        self.args = SceneArgs(
            tri=tri.data_ptr(), n_tri=0 if rec is not None else tri.shape[0],
            sph=sph.data_ptr(), n_sph=sph.shape[0], mat=mat.data_ptr(), n_mat=mat.shape[0],
            lgt=lgt.data_ptr(), n_lights=scene.n_point_lights, em=em.data_ptr(),
            n_em=scene.n_emissive, em_k=scene.emissive_sample_count,
            rec=None if rec is None else rec.data_ptr(),
            rec_rows=0 if rec is None else rec.shape[0],
            rec_stride=0 if rec is None else rec.shape[1],
            # A dense table form has no record: its instances are the per-row class.
            rec_cull=int(scene.krn_big_cull_mode) if self.binned or rec is not None else -1,
            binned=int(self.binned), cl=cl)

    def check_device(self, device):
        """Raise unless this scene lies on `device`, a launch's."""
        if self.device != device:
            raise ValueError(f"kscene: the kernel scene lies on {self.device}, not {device}")

    def smem_bytes(self, layout=None) -> int:
        """Dynamic shared memory of a K1 or K2 block on this scene
        (kernel_traverse.kernel_smem_bytes): its tables, and a binned
        scene's staged tiers and rings as the kernel's `layout`
        (walk_layout) lays them out. ValueError past what a block can use."""
        a = self.args
        floats = (a.rec_rows * REC_USED_COLS + a.n_tri * TRI_COLS + a.n_sph * SPH_COLS
                  + a.n_mat * MAT_COLS + a.n_lights * LGT_COLS + a.n_em * EM_COLS)
        return kernel_smem_bytes(floats, a.cl.n_pages if self.binned else None, layout)


def kernel_scene(scene: SceneData) -> KernelScene:
    """The KernelScene of `scene` on its device, its tables packed by
    `pack_tables`: every trace call builds one for all its launches."""
    return KernelScene(scene, pack_tables(scene))


# ---------------------------------------------------------------------------
# The twin.
# ---------------------------------------------------------------------------


class _Ctx:
    """Per-call constants of the twin: tables, forms and scalar divisors.
    Divisors are 1-element tensors so a CUDA division stays a true
    division (torch turns `x / python_scalar` into x * (1/c) there)."""

    def __init__(self, scene, tables, options, device):
        self.tri, self.sph, self.mat, self.lgt, self.em = tables
        self.dense_pair = scene.dense_pair
        self.rec = scene.krn_big_pair[:, :REC_USED_COLS] if self.dense_pair else None
        self.rec_cols = [self.rec[:, j, None] for j in range(17)] if self.dense_pair else None
        self.n_tri = 0 if self.dense_pair else self.tri.shape[0]
        # Binned scenes: the cluster traversal tiers and their cull class.
        self.clusters = kernel_tables(scene) if scene.has_kernel_records else None
        self.krn_cull_mode = scene.krn_cull_mode
        self.n_sph = self.sph.shape[0]
        self.n_lights = scene.n_point_lights
        self.n_em = scene.n_emissive
        self.em_k = scene.emissive_sample_count
        self.cull_mode = scene.krn_big_cull_mode
        self.eps = float(options.epsilon)
        # The ablation switches as they stand at the call: which parts of
        # the bounce run.
        mask = ablation_mask(self.clusters is not None)
        self.pair = self.dense_pair and not mask & ABLATE_BITS["bigpair"]
        self.walks = self.clusters is not None and not mask & SKIP_TRAVERSE_BIT
        nee = not mask & ABLATE_BITS["nee"]
        self.nee_lights = self.n_lights if nee else 0
        self.nee_draws = self.em_k if nee else 0
        self.straight = bool(mask & ABLATE_BITS["prop"])
        self.const_mat = (torch.tensor(ABLATED_MATERIAL, dtype=torch.float32, device=device)
                          if mask & ABLATE_BITS["mat"] else None)

        def c(v):
            return torch.full((1,), v, dtype=torch.float32, device=device)

        self.three, self.pi, self.two_pi = c(3.0), c(PI), c(2.0 * PI)


def _table_occluded(ctx, ox, oy, oz, dx, dy, dz, n_tri, t_max):
    """Shadow test over the tables: True where the nearest table hit lies
    below t_max (pallas_megakernel.py:516-522: visible iff no hit or
    nearest t >= dist - eps)."""
    t, p, *_ = table_nearest(ctx.tri, ctx.sph, ox, oy, oz, dx, dy, dz, n_tri)
    return (p >= 0) & ~(t >= t_max)


def _moment(ox, oy, oz, dx, dy, dz):
    return oy * dz - oz * dy, oz * dx - ox * dz, ox * dy - oy * dx


def _pair_nearest(ctx, ox, oy, oz, dx, dy, dz, hit):
    """Nearest hit of the pair record, improving strictly on `hit`
    (pair_test_nearest, kernel_traverse.py:467-596): the lowest record
    slot wins among equal t."""
    bt, bp, nx, ny, nz, mid = hit
    mx, my, mz = _moment(ox, oy, oz, dx, dy, dz)
    sd, su, sv, st, ok = pair_quantities(
        ctx.rec_cols, ox, oy, oz, dx, dy, dz, mx, my, mz, ctx.cull_mode
    )
    tv = st / torch.where(ok, sd, 1.0)
    key = torch.where(ok & (tv < bt), tv, float("inf"))
    tmin, k = key.min(dim=0)
    won = tmin < bt
    sdw = sd.gather(0, k[None])[0].clamp_min(1e-30)
    uw = su.gather(0, k[None])[0] / sdw
    vw = sv.gather(0, k[None])[0] / sdw
    w0 = 1.0 - uw - vw
    row = ctx.rec[k]
    n0 = row[:, C_N0:C_N0 + 3]
    n1 = row[:, C_N0 + 3:C_N0 + 6]
    n2 = row[:, C_N0 + 6:C_N0 + 9]
    snx = w0 * n0[:, 0] + uw * n1[:, 0] + vw * n2[:, 0]
    sny = w0 * n0[:, 1] + uw * n1[:, 1] + vw * n2[:, 1]
    snz = w0 * n0[:, 2] + uw * n1[:, 2] + vw * n2[:, 2]
    inv = torch.rsqrt(snx * snx + sny * sny + snz * snz + 1e-30)
    return (
        torch.minimum(bt, tmin),
        torch.where(won, row[:, C_PRIM].long(), bp),
        torch.where(won, snx * inv, nx),
        torch.where(won, sny * inv, ny),
        torch.where(won, snz * inv, nz),
        torch.where(won, row[:, C_MAT].long(), mid),
    )


def _pair_occluded(ctx, ox, oy, oz, dx, dy, dz, t_lim):
    """Any-hit of the pair record below t_lim, division-free:
    t < t_lim iff st < t_lim * sd (pair_test_anyhit, kernel_traverse.py:599)."""
    mx, my, mz = _moment(ox, oy, oz, dx, dy, dz)
    sd, _, _, st, ok = pair_quantities(
        ctx.rec_cols, ox, oy, oz, dx, dy, dz, mx, my, mz, ctx.cull_mode
    )
    return (ok & (st < t_lim * sd)).any(dim=0)


def _nearest(ctx, ox, oy, oz, dx, dy, dz, visits=None):
    """Spheres (and the triangle table), then the pair record, then the
    clusters of a binned scene, each improving strictly on the last.
    `visits` (int64 [n, 4] or None) receives the traversal counts."""
    if ctx.dense_pair:
        hit = table_nearest(ctx.tri, ctx.sph, ox, oy, oz, dx, dy, dz, 0)
        if ctx.pair:
            hit = _pair_nearest(ctx, ox, oy, oz, dx, dy, dz, hit)
        if ctx.walks:
            hit = traverse_clusters(ctx.clusters, ox, oy, oz, dx, dy, dz, hit,
                                    ctx.krn_cull_mode, visits=visits)
        return hit
    return table_nearest(ctx.tri, ctx.sph, ox, oy, oz, dx, dy, dz, ctx.n_tri)


def _tangent_frame(nx, ny, nz):
    """Branch-free tangent frame (pallas_megakernel.py:251-272)."""
    has_x = nx.abs() > 0.0
    has_y = ny.abs() > 0.0
    dxv = torch.where(has_x, 0.0, torch.where(has_y, -ny, 1.0))
    dyv = torch.where(has_x, -nx, torch.where(has_y, nz, 0.0))
    dzv = torch.where(has_x, torch.where(has_y, ny, nz), 0.0)
    inv = torch.rsqrt(dxv * dxv + dyv * dyv + dzv * dzv + 1e-30)
    dxv, dyv, dzv = dxv * inv, dyv * inv, dzv * inv
    b1x = dyv * nz - dzv * ny
    b1y = dzv * nx - dxv * nz
    b1z = dxv * ny - dyv * nx
    inv1 = torch.rsqrt(b1x * b1x + b1y * b1y + b1z * b1z + 1e-30)
    b1x, b1y, b1z = b1x * inv1, b1y * inv1, b1z * inv1
    b2x = b1y * nz - b1z * ny
    b2y = b1z * nx - b1x * nz
    b2z = b1x * ny - b1y * nx
    inv2 = torch.rsqrt(b2x * b2x + b2y * b2y + b2z * b2z + 1e-30)
    return b1x, b1y, b1z, b2x * inv2, b2y * inv2, b2z * inv2


def _bounce(ctx, depth, s, rec=None):
    """One bounce for the live rays held in dict `s` (all alive on entry):
    the body of `_make_megakernel` (pallas_megakernel.py:412-876). Returns
    the live mask after the bounce; `s` is updated. A list `rec` receives
    the record planes of K2's record form (pallas_megakernel.py:485-489,
    581-586, 711-712, 851-862), in the order mid, W, sel, one weight per
    point light, (CDF row, weight) per emitter draw. An int64 [n, 9]
    `s["vis"]`, when present, receives the traversal counts in the columns
    of GEO_VISIT_COLS."""
    eps = ctx.eps
    ox, oy, oz, dx, dy, dz = s["ox"], s["oy"], s["oz"], s["dx"], s["dy"], s["dz"]
    sr, sg, sb = s["sr"], s["sg"], s["sb"]
    divisor, bounce_pd, contrib = s["divisor"], s["bounce_pd"], s["contrib"]
    rng = s["rng"]
    vis = s.get("vis")

    near = None if vis is None else vis.new_zeros((ox.shape[0], WALK_COLS))
    bt, bp, nx, ny, nz, mid = _nearest(ctx, ox, oy, oz, dx, dy, dz, near)
    if vis is not None and ctx.clusters is not None:
        vis[:, NEAR_COLS] += near
        vis[:, QUERY_COL] += 1
    hit = bp >= 0
    s["collected"] = s["collected"] | hit
    t_hit = torch.where(hit, bt, 0.0)
    pxp = ox + dx * t_hit
    pyp = oy + dy * t_hit
    pzp = oz + dz * t_hit

    m = ctx.mat[mid] if ctx.const_mat is None else ctx.const_mat.expand(mid.shape[0], MAT_COLS)
    md_r, md_g, md_b = m[:, 0], m[:, 1], m[:, 2]
    ms_r, ms_g, ms_b = m[:, 3], m[:, 4], m[:, 5]
    ior = m[:, 6]
    me_r, me_g, me_b = m[:, 7], m[:, 8], m[:, 9]
    one_way = m[:, 11] > 0.5
    is_glass = m[:, 10] == float(BSDF_GLASS)
    is_mirror = m[:, 10] == float(BSDF_MIRROR)
    is_spec = is_glass | is_mirror

    weight = torch.reciprocal(divisor * bounce_pd)
    out_r = s["out_r"] + torch.where(hit, sr * me_r * weight, 0.0)
    out_g = s["out_g"] + torch.where(hit, sg * me_g * weight, 0.0)
    out_b = s["out_b"] + torch.where(hit, sb * me_b * weight, 0.0)
    light_w, em_rows = [], []

    # Russian roulette, keyed on the loop index (ref: worker.cpp:67-70).
    if depth + 1 <= 4:
        bpv = torch.ones_like(sr)
    else:
        mean_s = (sr + sg + sb) / ctx.three
        bpv = 0.1 + 0.1 * torch.minimum(contrib * mean_s, torch.ones_like(sr))
    rng, u_rt = next_u01(rng)
    do_bounce = u_rt < bpv

    def nee(lx, ly, lz, ls_r, ls_g, ls_b, lpd, lvalid, acc):
        tlx = lx - pxp
        tly = ly - pyp
        tlz = lz - pzp
        dist2 = tlx * tlx + tly * tly + tlz * tlz
        dist = torch.sqrt(dist2)
        inv = torch.reciprocal(dist.clamp_min(1e-30))
        ldx, ldy, ldz = tlx * inv, tly * inv, tlz * inv
        sox = pxp + ldx * eps
        soy = pyp + ldy * eps
        soz = pzp + ldz * eps
        occ = _table_occluded(
            ctx, sox, soy, soz, ldx, ldy, ldz, ctx.n_tri, dist - eps
        )
        if ctx.pair:
            occ = occ | _pair_occluded(
                ctx, sox, soy, soz, ldx, ldy, ldz, (dist - eps).clamp_min(0.0)
            )
        if ctx.walks:
            # Only rays the dense parts left visible, on a vertex that
            # takes the light, query the clusters (t_lim 0 = no query).
            want = hit & lvalid & ~occ & ~is_spec & (lpd > 0.0)
            t_lim = torch.where(want, dist - eps, torch.zeros_like(dist))
            shadow = None if vis is None else vis.new_zeros((sox.shape[0], WALK_COLS))
            occ = occ | traverse_clusters_anyhit(
                ctx.clusters, sox, soy, soz, ldx, ldy, ldz, t_lim, ctx.krn_cull_mode,
                visits=shadow,
            )
            if vis is not None:
                vis[:, SHADOW_COLS] += shadow
        cos_s = (nx * ldx + ny * ldy + nz * ldz).clamp_min(0.0)
        shade = cos_s / ctx.pi
        use = hit & lvalid & ~occ & ~is_spec & (lpd > 0.0)
        w = torch.where(use, shade / (divisor * bounce_pd * lpd), 0.0)
        light_w.append(w)
        a_r, a_g, a_b = acc
        return a_r + w * md_r * ls_r * sr, a_g + w * md_g * ls_g * sg, a_b + w * md_b * ls_b * sb

    acc = (out_r, out_g, out_b)
    all_valid = torch.ones_like(hit)
    one = torch.ones_like(sr)
    for li in range(ctx.nee_lights):
        lg = ctx.lgt[li]
        acc = nee(lg[0], lg[1], lg[2], lg[3], lg[4], lg[5], one, all_valid, acc)

    n_em = ctx.n_em
    for _ in range(ctx.nee_draws):
        rng, rsel = next_u01(rng)
        rng, u1 = next_u01(rng)
        rng, u2 = next_u01(rng)
        # CDF lower bound (ref: scene.cpp:238-257); n_em - 1 when above.
        sel = torch.searchsorted(ctx.em[:n_em, 0].contiguous(), rsel).clamp_max(n_em - 1)
        em_rows.append(sel.float())
        e = ctx.em[sel]
        sq = torch.sqrt(u1)
        w2 = sq * (1.0 - u2)
        w3 = sq * u2
        theta = 2.0 * PI * u1
        cphi = 1.0 - 2.0 * u2
        sphi = torch.sqrt((1.0 - cphi * cphi).clamp_min(0.0))
        ux_s = sphi * torch.cos(theta)
        uy_s = sphi * torch.sin(theta)
        uz_s = cphi
        is_sph = e[:, 2] > 0.5
        r_s = e[:, 6]
        spx = torch.where(is_sph, e[:, 3] + r_s * ux_s, e[:, 3] + w2 * e[:, 6] + w3 * e[:, 9])
        spy = torch.where(is_sph, e[:, 4] + r_s * uy_s, e[:, 4] + w2 * e[:, 7] + w3 * e[:, 10])
        spz = torch.where(is_sph, e[:, 5] + r_s * uz_s, e[:, 5] + w2 * e[:, 8] + w3 * e[:, 11])
        snx = torch.where(is_sph, ux_s, e[:, 12])
        sny = torch.where(is_sph, uy_s, e[:, 13])
        snz = torch.where(is_sph, uz_s, e[:, 14])
        s_pd = e[:, 1] * e[:, 15]
        cullm = e[:, 16] > 0.5
        # Area -> solid angle (ref: scene.cpp:280).
        tlx = spx - pxp
        tly = spy - pyp
        tlz = spz - pzp
        dist2 = tlx * tlx + tly * tly + tlz * tlz
        invd = torch.rsqrt(dist2.clamp_min(1e-30))
        ldx, ldy, ldz = tlx * invd, tly * invd, tlz * invd
        ldn = ldx * snx + ldy * sny + ldz * snz
        adot = (-ldn).abs()
        lvalid = (adot > 0.0) & (dist2 > 0.0) & (~cullm | (ldn < 0.0))
        lpd = s_pd * dist2 / adot.clamp_min(1e-30)
        acc = nee(spx, spy, spz, e[:, 17], e[:, 18], e[:, 19], lpd, lvalid, acc)
    s["out_r"], s["out_g"], s["out_b"] = acc

    # Roulette bookkeeping (ref: worker.cpp:106-110).
    bounce_pd = torch.where(
        hit, torch.where(do_bounce, bounce_pd * bpv, bounce_pd * (1.0 - bpv)), bounce_pd
    )
    cont = hit & do_bounce & (bounce_pd > PD_CUTOFF)

    # ---- Propagate (ref: propagation.cpp) ----
    rng, u1 = next_u01(rng)
    rng, u2 = next_u01(rng)
    rng, ub = next_u01(rng)

    fac = torch.sqrt((1.0 - u2).clamp_min(0.0))
    cos_t = torch.sqrt(u2)
    ang = 2.0 * PI * u1
    lx_t = fac * torch.cos(ang)
    ly_t = fac * torch.sin(ang)
    p_lam = 2.0 * cos_t / ctx.two_pi
    b1x, b1y, b1z, b2x, b2y, b2z = _tangent_frame(nx, ny, nz)
    ldx_l = b1x * lx_t + b2x * ly_t + nx * cos_t
    ldy_l = b1y * lx_t + b2y * ly_t + ny * cos_t
    ldz_l = b1z * lx_t + b2z * ly_t + nz * cos_t

    # Glass (Fresnel unpolarised; ref: propagation.cpp:64-160).
    ray_dot = -(dx * nx + dy * ny + dz * nz)
    entering = ray_dot >= 0.0
    ri_l = torch.where(entering, 1.0, ior)
    ri_e = torch.where(entering, ior, 1.0)
    adot = ray_dot.abs()
    sin_i = torch.sqrt((1.0 - adot * adot).clamp_min(0.0))
    sin_t = ri_l / ri_e * sin_i
    tir = sin_t >= 1.0
    cos_tt = torch.sqrt((1.0 - sin_t * sin_t).clamp_min(0.0))
    r_par = (ri_e * adot - ri_l * cos_tt) / (ri_e * adot + ri_l * cos_tt)
    r_perp = (ri_l * adot - ri_e * cos_tt) / (ri_l * adot + ri_e * cos_tt)
    rat = torch.where(tir, 1.0, (r_par * r_par + r_perp * r_perp) * 0.5)
    cos_tt = torch.where(tir, 0.0, cos_tt)
    refl = ub < rat
    sgn = torch.where(ray_dot < 0.0, -1.0, 1.0)
    ddn = dx * nx * sgn + dy * ny * sgn + dz * nz * sgn
    rx = dx - 2.0 * ddn * nx * sgn
    ry = dy - 2.0 * ddn * ny * sgn
    rz = dz - 2.0 * ddn * nz * sgn
    ratio = ri_l / ri_e
    fx = dx * ratio + nx * (ratio * adot - cos_tt) * sgn
    fy = dy * ratio + ny * (ratio * adot - cos_tt) * sgn
    fz = dz * ratio + nz * (ratio * adot - cos_tt) * sgn
    invf = torch.rsqrt(fx * fx + fy * fy + fz * fz + 1e-30)
    fx, fy, fz = fx * invf, fy * invf, fz * invf
    gdx = torch.where(refl, rx, fx)
    gdy = torch.where(refl, ry, fy)
    gdz = torch.where(refl, rz, fz)
    ri_fac = (ri_e * ri_e) / (ri_l * ri_l)
    fac_glass = torch.where(refl, rat, ri_fac * (1.0 - rat))
    p_glass = torch.where(refl, rat, 1.0 - rat)

    # Mirror (ref: propagation.cpp:180-204).
    unaligned = (dx * nx + dy * ny + dz * nz) > 0.0
    pass_through = one_way & unaligned
    flip = ~one_way & unaligned
    msgn = torch.where(flip, -1.0, 1.0)
    mdn = dx * nx * msgn + dy * ny * msgn + dz * nz * msgn
    mx = torch.where(pass_through, dx, dx - 2.0 * mdn * nx * msgn)
    my = torch.where(pass_through, dy, dy - 2.0 * mdn * ny * msgn)
    mz = torch.where(pass_through, dz, dz - 2.0 * mdn * nz * msgn)

    ndx = torch.where(is_glass, gdx, torch.where(is_mirror, mx, ldx_l))
    ndy = torch.where(is_glass, gdy, torch.where(is_mirror, my, ldy_l))
    ndz = torch.where(is_glass, gdz, torch.where(is_mirror, mz, ldz_l))
    ray_factor = torch.where(is_glass, fac_glass, 1.0)
    ray_pd = torch.where(is_glass, p_glass, torch.where(is_mirror, 1.0, p_lam))

    # Bounce eval (non-synthetic getSpectrum).
    cos_n = (nx * ndx + ny * ndy + nz * ndz).clamp_min(0.0)
    shade_l = cos_n / ctx.pi
    same_side = (dx * ndx + dy * ndy + dz * ndz) <= 0.0
    mm = ~one_way | same_side

    def mult(ms, md):
        gl = torch.where(same_side, ms, md)
        mi = torch.where(mm, ms, 1.0)
        return torch.where(is_glass, gl, torch.where(is_mirror, mi, md))

    shading = torch.where(is_spec, 1.0, shade_l)
    if ctx.straight:
        # "prop" (pallas_megakernel.py:831-839): the straight-through ray
        # in place of the sampled one, with unit factor, pdf and shading
        # and the diffuse colour.
        ndx, ndy, ndz = torch.where(u1 > 0.5, dx, -dx), dy, dz
        ray_factor = ray_pd = shading = torch.ones_like(dx)

        def mult(ms, md):
            return md

    divisor_new = (
        divisor * (ray_pd / ray_factor.clamp_min(1e-30))
        * torch.reciprocal(shading.clamp_min(1e-30))
    )
    divisor = torch.where(cont, divisor_new, divisor)
    s["contrib"] = torch.where(cont, contrib * ray_factor * shading, contrib)
    s["sr"] = torch.where(cont, mult(ms_r, md_r) * sr, sr)
    s["sg"] = torch.where(cont, mult(ms_g, md_g) * sg, sg)
    s["sb"] = torch.where(cont, mult(ms_b, md_b) * sb, sb)
    s["divisor"] = divisor
    s["bounce_pd"] = bounce_pd
    s["rng"] = rng
    if rec is not None:
        # Chain selector: 0 no advance, 1 diffuse, 2 specular, 3 ones.
        code = torch.where(
            is_glass, torch.where(same_side, 2.0, 1.0),
            torch.where(is_mirror, torch.where(mm, 2.0, 3.0), 1.0),
        )
        rec += [torch.where(hit, mid.float(), -1.0), torch.where(hit, weight, 0.0),
                torch.where(cont, code, 0.0)] + light_w[:ctx.n_lights]
        for k in range(ctx.em_k):
            rec += [em_rows[k], light_w[ctx.n_lights + k]]

    alive = cont & (divisor > PD_CUTOFF)
    s["ox"] = torch.where(alive, pxp + ndx * eps, ox)
    s["oy"] = torch.where(alive, pyp + ndy * eps, oy)
    s["oz"] = torch.where(alive, pzp + ndz * eps, oz)
    s["dx"] = torch.where(alive, ndx, dx)
    s["dy"] = torch.where(alive, ndy, dy)
    s["dz"] = torch.where(alive, ndz, dz)
    return alive


_OUT_FIELDS = ("out_r", "out_g", "out_b", "collected")


def trace_megakernel_reference(scene: SceneData, rays, options, seed, kscene=None,
                               debug_visits=False):
    """The twin of the CUDA kernel: returns (spectrum [R,4] with alpha =
    collected, collected [R] bool), and with `debug_visits` the traversal
    counters [ceil(R / 1024), 9] int32. `kscene`: the scene's KernelScene
    on the rays' device (built here when None). A ray leaves the loop when
    it dies, as a kernel thread does; dead rays never change their sums, so
    this equals the TPU's whole-block exit."""
    trace_megakernel_reference.calls += 1
    origin, direction = rays.origin, rays.direction
    dev = origin.device
    scene = scene.to(dev)
    ks = kernel_scene(scene) if kscene is None else kscene
    ctx = _Ctx(scene, ks.tables, options, dev)
    n = origin.shape[0]
    f32 = torch.float32
    idx = torch.arange(n, device=dev)
    ones = torch.ones(n, dtype=f32, device=dev)
    zeros = torch.zeros(n, dtype=f32, device=dev)
    rows = BINNED_BLOCK_ROWS if scene.has_kernel_records else BLOCK_ROWS
    s = {
        "rng": seed_rng(seed, idx, rows),
        "ox": origin[:, 0], "oy": origin[:, 1], "oz": origin[:, 2],
        "dx": direction[:, 0], "dy": direction[:, 1], "dz": direction[:, 2],
        "sr": ones, "sg": ones, "sb": ones,
        "out_r": zeros, "out_g": zeros, "out_b": zeros,
        "divisor": ones, "bounce_pd": ones, "contrib": ones,
        "collected": torch.zeros(n, dtype=torch.bool, device=dev),
    }
    fields = _OUT_FIELDS
    if debug_visits:
        s["vis"] = torch.zeros((n, GEO_VISIT_COLS), dtype=torch.int64, device=dev)
        fields = _OUT_FIELDS + ("vis",)
    out = {k: s[k].clone() for k in fields}
    for depth in range(int(options.max_depth)):
        if idx.numel() == 0:
            break
        alive = _bounce(ctx, depth, s)
        for k in fields:
            out[k][idx] = s[k]
        idx = idx[alive]
        s = {k: v[alive] for k, v in s.items()}
    coll = out["collected"]
    spectrum = torch.stack([out["out_r"], out["out_g"], out["out_b"], coll.to(f32)], -1)
    if debug_visits:
        return spectrum, coll, block_sums(out["vis"])
    return spectrum, coll


trace_megakernel_reference.calls = 0


# ---------------------------------------------------------------------------
# The CUDA kernel's wrapper.
# ---------------------------------------------------------------------------

# The dense counting instance's output (csrc/megakernel.cu BounceSteps):
# the bounce steps the warps execute, then the ray-bounces.
BOUNCE_STEP_COLS = 2


def _library():
    lib = _build.load("megakernel")
    fn = lib.ptx_megakernel_launch
    if fn.argtypes is None:
        fn.argtypes = ([ctypes.POINTER(SceneArgs), _P, _P, _P, _I]  # scene, rays, spectrum
                       + [_P, _P, _P, _P, _I, ctypes.c_float]  # counters, refill, seed, depth, eps
                       + [_I, ctypes.c_longlong, _I, _P])  # grid, smem, ablation mask, stream
        fn.restype = ctypes.c_int
    return fn


def lane_use(bounce_steps):
    """Lane use of a dense counting launch from its `bounce_steps` [2]
    (warp bounce steps, ray-bounces): ray-bounces / (32 x steps). Raises
    ValueError unless 0 < steps <= ray-bounces <= 32 x steps."""
    steps, bounces = torch.as_tensor(bounce_steps).reshape(-1).long().tolist()
    if not 0 < steps <= bounces <= WARP_LANES * steps:
        raise ValueError(f"bounce steps {steps} against {bounces} ray-bounces: need "
                         f"0 < steps <= ray-bounces <= {WARP_LANES} x steps")
    return bounces / (WARP_LANES * steps)


def predicted_lane_use(live, lanes=WARP_LANES):
    """Lane use of one path per thread in warps of `lanes` rays, from the
    live counts per bounce `live` (rays entering bounce 0, 1, ...) of
    paths whose lengths are independent across lanes: a warp runs bounce d
    while any of its lanes is alive there, so lane use = sum_d p_d /
    sum_d (1 - (1 - p_d)^lanes), with p_d = live[d] / live[0]. Raises
    ValueError unless the counts are positive and do not grow."""
    p = torch.as_tensor(live, dtype=torch.float64).reshape(-1)
    if p.numel() == 0 or not bool((p > 0).all()) or bool((p[1:] > p[:-1]).any()):
        raise ValueError(f"live counts per bounce must be positive and not grow: {live}")
    p = p / p[0]
    return float(p.sum() / (1.0 - (1.0 - p) ** lanes).sum())


def trace_megakernel(scene: SceneData, rays, options, seed, kscene=None, debug_visits=False,
                     warp_steps=None, bounce_steps=None):
    """Full-path trace of a ray batch: (spectrum [R,4] with alpha =
    collected, collected [R] bool), and with `debug_visits` the traversal
    counters [ceil(R / 1024), 9] int32 (zero for a dense scene). `seed`
    is an int32 Python int or a 1-element tensor (read on the device, so
    drawing it costs no sync). `kscene`: the scene's KernelScene on the
    rays' device (built here when None). `warp_steps` (binned, with
    `debug_visits`, on the card): a zeroed [3] int64 tensor the walks' warp
    steps are added to. `bounce_steps` (dense, on the card): a zeroed [2]
    int64 tensor the warps' bounce steps and the ray-bounces are added to
    (`lane_use`). CPU rays go to the twin; CUDA rays launch
    csrc/megakernel.cu, its binned form for a scene with kernel records,
    and its ablation instances while a switch is set (`ablation_mask`, read
    at the call)."""
    with trace_annotation("k1.trace"):
        origin, direction = rays.origin, rays.direction
        dev = origin.device
        binned = scene.has_kernel_records
        if warp_steps is not None:
            if not debug_visits or not binned:
                raise ValueError("trace_megakernel: warp_steps count binned scenes with "
                                 "debug_visits")
            check_warp_steps(warp_steps, dev)
        if bounce_steps is not None:
            if binned:
                raise ValueError("trace_megakernel: bounce_steps count dense scenes")
            if dev.type != "cuda":
                raise ValueError("bounce_steps: the warps' steps are counted on the card only")
            check_tensor("bounce_steps", bounce_steps, dev, torch.int64, (BOUNCE_STEP_COLS,))
        if dev.type == "cpu":
            return trace_megakernel_reference(scene, rays, options, seed, kscene, debug_visits)
        if dev.type != "cuda":
            raise ValueError(f"trace_megakernel: no kernel for device {dev}")
        if binned and scene.big_v0.shape[0] > scene.krn_big_pair.shape[0]:
            # pallas_megakernel.py:1219-1229: the big partition outgrew the one
            # pair record.
            raise ValueError(
                f"megakernel unsupported: {scene.big_v0.shape[0]} dense triangles exceed "
                f"the pair record ({scene.krn_big_pair.shape[0]} rows)"
            )
        if not megakernel_supported(scene):
            raise ValueError(
                "trace_megakernel: scene exceeds the kernel's limits (see "
                "megakernel_supported / PERF.md)"
            )
        check_tensor("origin", origin, dev, torch.float32, (None, 3))
        check_tensor("direction", direction, dev, torch.float32, (origin.shape[0], 3))
        ks = kernel_scene(scene.to(dev)) if kscene is None else kscene
        ks.check_device(dev)
        if isinstance(seed, torch.Tensor):
            seed_t = seed.to(device=dev, dtype=torch.int32).reshape(-1)[:1].contiguous()
        else:
            seed_t = torch.tensor([int(seed)], dtype=torch.int32, device=dev)

        smem = ks.smem_bytes(walk_layout("megakernel") if binned else None)
        n = origin.shape[0]
        # The warps hand rays out from a counter: the output starts as NaN, so
        # a ray that no lane traced shows.
        spectrum = torch.full((n, 4), float("nan"), device=dev)
        visits = (torch.zeros((-(-n // VISIT_BLOCK), GEO_VISIT_COLS), dtype=torch.int32, device=dev)
                  if debug_visits else None)
        count = binned and debug_visits
        if count and warp_steps is None:
            warp_steps = torch.zeros(WARP_STEP_COLS, dtype=torch.int64, device=dev)
        steps = warp_steps if count else bounce_steps
        # The refill counter: the next ray index to hand out.
        next_ray = torch.zeros(1, dtype=torch.int32, device=dev)
        ablate = ablation_mask(binned)
        # Temporaries made here (seed_t, a KernelScene built here) may be
        # freed before the kernel runs: the caching allocator reuses memory in
        # the order of the current stream, which the launch is on.
        if n:
            with torch.cuda.device(dev):
                per_sm, threads = resident_blocks(smem, binned, steps is not None,
                                                  ks.args.rec_cull, bool(ablate))
                grid = resident_grid(n, threads, per_sm,
                                     torch.cuda.get_device_properties(dev).multi_processor_count)
                err = _library()(
                    ctypes.byref(ks.args), origin.data_ptr(), direction.data_ptr(),
                    spectrum.data_ptr(), n, visits.data_ptr() if count else None,
                    None if steps is None else steps.data_ptr(), next_ray.data_ptr(),
                    seed_t.data_ptr(), int(options.max_depth), float(options.epsilon), grid, smem,
                    ablate, torch.cuda.current_stream(dev).cuda_stream,
                )
            if err:
                raise RuntimeError(f"megakernel launch failed: cudaError_t {err}")
            trace_megakernel.launches += 1
        coll = spectrum[:, 3] > 0.5
        return (spectrum, coll, visits) if debug_visits else (spectrum, coll)


trace_megakernel.launches = 0


def occupancy(smem_bytes, binned, count=False, cull=-1, ablate=False):
    """(resident blocks per SM, threads per block) of K1's instance (form,
    counting or not, cull class, ablation instance or not) at `smem_bytes`
    of dynamic shared memory, by
    cudaOccupancyMaxActiveBlocksPerMultiprocessor on the current card."""
    fn = _build.load("megakernel").ptx_megakernel_occupancy
    if fn.argtypes is None:
        fn.argtypes = [_I, _I, _I, _I, ctypes.c_longlong, ctypes.POINTER(_I),
                       ctypes.POINTER(_I)]
        fn.restype = ctypes.c_int
    blocks, threads = ctypes.c_int(0), ctypes.c_int(0)
    err = fn(int(bool(binned)), int(cull), int(bool(count)), int(bool(ablate)), int(smem_bytes),
             ctypes.byref(blocks), ctypes.byref(threads))
    if err:
        raise RuntimeError(f"megakernel occupancy query failed: cudaError_t {err}")
    return blocks.value, threads.value


# (library, card, instance, shared memory) -> (blocks per SM, threads): a
# launch queries its instance's occupancy once and then keeps it.
_RESIDENT: dict = {}


def resident_blocks(smem_bytes, binned, count=False, cull=-1, ablate=False):
    """`occupancy` on the current card, queried at an instance's first
    launch at a given shared-memory size and then kept."""
    key = (_build.load("megakernel")._name, torch.cuda.current_device(), bool(binned),
           bool(count), int(cull), bool(ablate), int(smem_bytes))
    if key not in _RESIDENT:
        _RESIDENT[key] = occupancy(smem_bytes, binned, count, cull, ablate)
    return _RESIDENT[key]
