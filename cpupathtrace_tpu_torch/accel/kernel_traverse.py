"""The tiered cluster traversal (K3): table packing, its plain-torch
version, and the standalone query (K4).

Port of `cpupathtrace_tpu/accel/kernel_traverse.py`. The small-triangle
partition of a binned scene is cut into clusters of up to 56 triangles,
each packed as one pair record (one row per triangle of Plücker /
Möller-Trumbore features, see accel/pair_record.py), and bounded by three
tiers of boxes: cluster bounds in pages of GROUP = 32 clusters (one page
per supercluster), supercluster bounds in pages of GROUP2 = 16 (one page
per hyper), and the hyper bounds. A query passes the root gate (the union
of the hypers), then descends hypers, superclusters and clusters whose
slab entry lies below its bound, and pair-tests the records it reaches.

Layouts on the device (the port's own, compact; the TPU pads every row to
128 lanes):
  * records [Cp, L, REC_COLS = 32] f32: columns 0-27 as the JAX columns
    0-27, 28-31 zero; padding records carry prim = -1 and N = 0;
  * bounds [..., BND_COLS = 8] f32 per box: lo3, hi3, valid, pad. The
    half-record bounds of the TPU (its columns 28-34) are not carried.

`traverse_clusters` / `traverse_clusters_anyhit` are the plain versions
of the CUDA device functions in csrc/cluster_traverse.cuh (inlined in the
bounce kernel K2 and launched alone by K4, `cluster_intersect`). They
apply the same gates per ray (root, hyper, supercluster, cluster entry
below the ray's initial bound), test the entered records in ascending
cluster order and take the first strict minimum. The kernel also prunes
each box against its running nearest t; that changes nothing but ties
of exactly equal t across records (the same lowest cluster wins in both)
and boxes whose slab entry rounds above a triangle's t on its face.

Traversal counters (`visits`, the JAX package's debug_visits): per ray, the
superclusters descended (entered below the bound, so their 32 cluster
boxes are read) and the records visited (tested), as the kernel's walk
counts them: against the running nearest t (the bound before a box is the
initial bound or the nearest hit of the clusters before it), and for
any-hit queries up to the first occluding cluster; and the walk's work:
its slab tests below the root gate (hypers, the superclusters of entered
hypers, the clusters of descends) and the filled record rows it tests
(any-hit: up to the occluding row). A box is never entered
below its parent's entry, so a supercluster or cluster that passes its own
test under the running bound passes its parents' too. These are per-ray
counts; the TPU kernel counted per ray block (a block descended when any
lane needed it), so they do not compare with the JAX package's.
"""
from __future__ import annotations

import ctypes
from typing import NamedTuple

import numpy as np
import torch

from .. import _build
from ..native import pack_pair_records_native
from .pair_record import C_CULL, C_MAT, C_N0, C_PRIM, REC_USED_COLS

GROUP = 32  # clusters per supercluster
GROUP2 = 16  # superclusters per hyper page
REC_COLS = 32  # record row width on the device (28 used)
BND_COLS = 8  # bounds row: lo3 hi3 valid pad
B_LO, B_HI, B_VALID = 0, 3, 6
FLT_MAX = 3.4028234663852886e38
TRI_EPS = 1e-6

# Plain traversal chunking: at most this many (ray, box) entries or
# (pair, slot) tests are held at once (the main path's 262,144 rays x
# 4,128 clusters would be 4.3 GB of f32 entries in one piece).
_CHUNK_ELEMS = 1 << 24


# ---------------------------------------------------------------------------
# Packing (numpy, at scene build).
# ---------------------------------------------------------------------------


def _pack_pair_records_batch(v0, v1, v2, cull, prim, n0, n1, n2, mat, out):
    """Pack [C, L, ...] cluster arrays into the records `out` [C, L, >=28]
    (kernel_traverse.py:_pack_pair_records_batch): the plain version of
    the C++ packer the build runs (native.pack_pair_records_native), kept
    as the tests' reference. The arithmetic is that of the JAX package's
    native packer (ptx_native.cpp ptx_pack_pair_records): v0 . N is summed
    in axis order from the first product, so a padding slot's zero keeps
    the sign the C++ gives it."""
    e1 = v1 - v0
    e2 = v2 - v0
    n = np.cross(e1, e2)
    live = prim >= 0
    n = np.where(live[..., None], n, 0.0)
    blk = np.empty(v0.shape[:2] + (REC_USED_COLS,), np.float32)
    blk[..., 0:3] = -n
    blk[..., 3:6] = e2
    blk[..., 6:9] = np.cross(v0, e2)
    blk[..., 9:12] = -e1
    blk[..., 12:15] = -np.cross(v0, e1)
    blk[..., 15] = v0[..., 0] * n[..., 0] + v0[..., 1] * n[..., 1] + v0[..., 2] * n[..., 2]
    blk[..., C_CULL] = cull
    blk[..., C_PRIM] = prim
    blk[..., C_MAT] = mat
    blk[..., C_N0:C_N0 + 3] = n0
    blk[..., C_N0 + 3:C_N0 + 6] = n1
    blk[..., C_N0 + 6:C_N0 + 9] = n2
    out[..., :REC_USED_COLS] = blk
    return out


def _reduce_bounds_rows(lo, hi, vmask):
    """[N, G, 3] boxes -> [N, BND_COLS] rows reducing the group axis over
    its valid members; empty groups carry valid = 0 and zero bounds."""
    any_v = vmask.any(axis=1)
    out = np.zeros((lo.shape[0], BND_COLS), np.float32)
    out[:, B_LO:B_LO + 3] = np.where(
        any_v[:, None], np.where(vmask[..., None], lo, np.inf).min(axis=1), 0.0
    )
    out[:, B_HI:B_HI + 3] = np.where(
        any_v[:, None], np.where(vmask[..., None], hi, -np.inf).max(axis=1), 0.0
    )
    out[:, B_VALID] = any_v.astype(np.float32)
    return out


def tiers_from_cluster_bounds(clb):
    """Supercluster pages [Hp, GROUP2, BND_COLS] and hyper bounds
    [Hp8, BND_COLS] (Hp8 = Hp rounded up to 8) from the cluster-bounds
    pages [S, GROUP, BND_COLS]."""
    clb = np.asarray(clb, np.float32)
    s = clb.shape[0]
    sup_s = _reduce_bounds_rows(
        clb[:, :, B_LO:B_LO + 3], clb[:, :, B_HI:B_HI + 3], clb[:, :, B_VALID] > 0.5
    )
    hp = -(-s // GROUP2)
    sup = np.zeros((hp * GROUP2, BND_COLS), np.float32)
    sup[:s] = sup_s
    pages = sup.reshape(hp, GROUP2, BND_COLS)
    hyp = np.zeros((-(-hp // 8) * 8, BND_COLS), np.float32)
    hyp[:hp] = _reduce_bounds_rows(
        pages[:, :, B_LO:B_LO + 3], pages[:, :, B_HI:B_HI + 3], pages[:, :, B_VALID] > 0.5
    )
    return pages, hyp


def pack_kernel_tables_np(cl_v0, cl_v1, cl_v2, cl_cull, cl_prim,
                          cl_n0, cl_n1, cl_n2, cl_mat, c_lo, c_hi):
    """The traversal tiers from [C, L, ...] cluster arrays and the cluster
    bounds [C, 3]: (records [Cp, L, REC_COLS], cluster bounds
    [S, GROUP, BND_COLS], supercluster pages [Hp, GROUP2, BND_COLS],
    hyper bounds [Hp8, BND_COLS]) with Cp = S * GROUP. Padding boxes carry
    valid = 0 (padding clusters lo = +inf, hi = -inf) and are never
    entered."""
    v0 = np.asarray(cl_v0, np.float32)
    c, l, _ = v0.shape
    if l % 8:
        raise ValueError(f"cluster_size {l} must be a multiple of 8")
    prim = np.asarray(cl_prim, np.float32)
    if prim.max(initial=0) >= 2 ** 24:
        raise ValueError("the records carry prim ids as f32 (< 2^24)")
    s = -(-c // GROUP)
    cp = s * GROUP
    rec = np.zeros((cp, l, REC_COLS), np.float32)
    rec[c:, :, C_PRIM] = -1.0
    # The C++ packer, bit-equal to _pack_pair_records_batch (as the JAX
    # builder runs its native packer); rec[:c] is zeroed and C-contiguous.
    pack_pair_records_native(v0, cl_v1, cl_v2, cl_cull, prim, cl_mat,
                             cl_n0, cl_n1, cl_n2, out=rec[:c])
    lo_p = np.full((cp, 3), np.inf, np.float32)
    hi_p = np.full((cp, 3), -np.inf, np.float32)
    lo_p[:c] = np.asarray(c_lo, np.float32)
    hi_p[:c] = np.asarray(c_hi, np.float32)
    valid = np.zeros(cp, np.float32)
    valid[:c] = 1.0
    clb = np.zeros((s, GROUP, BND_COLS), np.float32)
    clb[:, :, B_LO:B_LO + 3] = lo_p.reshape(s, GROUP, 3)
    clb[:, :, B_HI:B_HI + 3] = hi_p.reshape(s, GROUP, 3)
    clb[:, :, B_VALID] = valid.reshape(s, GROUP)
    sup, hyp = tiers_from_cluster_bounds(clb)
    return rec, clb, sup, hyp


def compact_kernel_tables(records, cl_bounds, sup_bounds, hyp_bounds):
    """The JAX package's 128-lane tables in the port's compact layout:
    record columns 0-27 (28-31 zero, dropping the TPU's half-record
    bounds) and bounds columns 0-6 (7 zero)."""
    def cut(a, used, cols):
        a = np.asarray(a, np.float32)
        out = np.zeros(a.shape[:-1] + (cols,), np.float32)
        out[..., :used] = a[..., :used]
        return out

    return (cut(records, REC_USED_COLS, REC_COLS), cut(cl_bounds, 7, BND_COLS),
            cut(sup_bounds, 7, BND_COLS), cut(hyp_bounds, 7, BND_COLS))


# ---------------------------------------------------------------------------
# The plain traversal (torch).
# ---------------------------------------------------------------------------


def _inv_dir(d):
    """Slab-test inverse: zero components use FLT_MAX
    (ref: src/scene/bounding_box.cpp:44-49)."""
    nz = d.abs() > 0.0
    return torch.where(nz, torch.reciprocal(torch.where(nz, d, 1.0)), FLT_MAX)


def pair_slab_entries(bnd, ox, oy, oz, ix, iy, iz):
    """Slab entries of every (box, ray) pair: [B, n] f32, the clamped entry
    t where the ray meets a valid box, +inf otherwise. `bnd` [B, BND_COLS];
    rays [n]. min/max propagate NaN, so a NaN entry enters nothing."""
    return _slab([bnd[:, j, None] for j in range(7)], ox, oy, oz, ix, iy, iz)


def _slab(b, ox, oy, oz, ix, iy, iz):
    """The clamped slab entry of boxes given as 7 bounds columns (lo3, hi3,
    valid) against rays, broadcasting, +inf on a miss."""
    t1x, t2x = (b[0] - ox) * ix, (b[3] - ox) * ix
    t1y, t2y = (b[1] - oy) * iy, (b[4] - oy) * iy
    t1z, t2z = (b[2] - oz) * iz, (b[5] - oz) * iz
    tmin = torch.maximum(
        torch.maximum(torch.minimum(t1x, t2x), torch.minimum(t1y, t2y)),
        torch.minimum(t1z, t2z),
    )
    tmax = torch.minimum(
        torch.minimum(torch.maximum(t1x, t2x), torch.maximum(t1y, t2y)),
        torch.maximum(t1z, t2z),
    )
    miss = (b[6] < 0.5) | (tmax < 0.0) | (tmin > tmax)
    return torch.where(miss, float("inf"), torch.maximum(tmin, torch.zeros_like(tmin)))


def root_box(hyp):
    """[1, BND_COLS] union of the valid hyper boxes (the root gate's box;
    lo = +inf, hi = -inf when none is valid). Used by `_root_gate` and
    handed to the CUDA kernels."""
    valid = hyp[:, B_VALID:B_VALID + 1] > 0.5
    lo = torch.where(valid, hyp[:, B_LO:B_LO + 3], float("inf")).amin(0)
    hi = torch.where(valid, hyp[:, B_HI:B_HI + 3], float("-inf")).amax(0)
    # Built on the device alone: a Python number stored into a CUDA tensor
    # is a copy from the host that waits for the stream.
    return torch.cat([lo, hi, lo.new_ones(1), lo.new_zeros(BND_COLS - B_VALID - 1)])[None]


def _root_gate(root, ox, oy, oz, ix, iy, iz, bound):
    """Per ray: does it enter the root box closer than its bound?"""
    return (pair_slab_entries(root, ox, oy, oz, ix, iy, iz)[0] < bound)


def _candidates(tables, ox, oy, oz, dx, dy, dz, bound):
    """Entered (ray, cluster) pairs of rays [n] under per-ray `bound`:
    (ray index [P], cluster index [P]) sorted by ray, then cluster, the
    slab entries of the superclusters [S, n], clusters [C, n] and hypers
    [Hp, n], and the root gate [n]."""
    rec, clb, sup, hyp, root = tables
    ix, iy, iz = _inv_dir(dx), _inv_dir(dy), _inv_dir(dz)
    gate = _root_gate(root, ox, oy, oz, ix, iy, iz, bound)
    hp = sup.shape[0]
    s_count = clb.shape[0]
    h_ent = pair_slab_entries(hyp[:hp], ox, oy, oz, ix, iy, iz)
    h_ok = (h_ent < bound) & gate
    s_ent = pair_slab_entries(sup.reshape(-1, BND_COLS)[:s_count], ox, oy, oz, ix, iy, iz)
    s_ok = (s_ent < bound) & h_ok.repeat_interleave(GROUP2, dim=0)[:s_count]
    c_ent = pair_slab_entries(clb.reshape(-1, BND_COLS), ox, oy, oz, ix, iy, iz)
    c_ok = (c_ent < bound) & s_ok.repeat_interleave(GROUP, dim=0)
    ray, cl = c_ok.t().nonzero(as_tuple=True)
    return ray, cl, s_ent, c_ent, h_ent, gate


def _filled_rows(rec):
    """Per cluster, the filled record rows (prim >= 0) [C] and their running
    count along the rows [C, L] (inclusive)."""
    cum = (rec[:, :, C_PRIM] >= 0.0).long().cumsum(1)
    return cum[:, -1], cum


def _page_sups(s_count, hp, device):
    """Superclusters in each hyper page [Hp]: the walk tests every one of
    an entered hyper."""
    first = torch.arange(hp, device=device) * GROUP2
    return (s_count - first).clamp(max=GROUP2)


def _count_nearest(visits, ray, cl, pair_t, s_ent, c_ent, h_ent, gate, bound, filled):
    """Adds the nearest walk's counts of a chunk of rays to `visits` [n, 4]
    (descends, record visits, slab tests, filled rows tested): the running
    bound before cluster c is the initial bound or the least hit t of the
    entered clusters before it (a pruned cluster holds no hit below its own
    entry, so it could not have lowered it). Past the root gate the walk
    tests every hyper, every supercluster of an entered hyper and the 32
    clusters of a descend, and every row of a visited record."""
    n = bound.shape[0]
    inf = torch.full_like(c_ent, float("inf"))
    hit_t = inf.index_put((cl, ray), pair_t)
    run = torch.cat([inf[:1], hit_t.cummin(dim=0).values[:-1]])
    run = torch.minimum(run, bound[None])
    s_count = s_ent.shape[0]
    hp = h_ent.shape[0]
    s_in = s_ent < run[::GROUP][:s_count]
    h_in = h_ent < run[::GROUP * GROUP2][:hp]
    descends = s_in.sum(0)
    visited = c_ent[cl, ray] < run[cl, ray]
    rv, cv = ray[visited], cl[visited]
    visits[:, 0] += descends
    visits[:, 1] += torch.bincount(rv, minlength=n)
    visits[:, 2] += (gate.long() * hp + (h_in.long() * _page_sups(s_count, hp, ray.device)[:, None])
                     .sum(0) + GROUP * descends)
    visits[:, 3] += torch.zeros(n, dtype=torch.int64, device=ray.device).index_add_(
        0, rv, filled[cv])


def _count_anyhit(visits, ray, cl, pair_hit, pair_rows, s_ent, h_ent, gate, t_lim, filled):
    """Adds the any-hit walk's counts of a chunk of rays to `visits` [n, 4]:
    every entered cluster up to the first occluding one, and every entered
    supercluster up to that cluster's; the slab tests up to the occluding
    cluster's box, and the filled rows of the visited records, the
    occluding one's up to its occluding row (`pair_rows`)."""
    n = t_lim.shape[0]
    dev = ray.device
    k = torch.arange(ray.numel(), device=dev)
    first = torch.full((n,), ray.numel(), dtype=torch.int64, device=dev)
    first = first.scatter_reduce(0, ray, torch.where(pair_hit, k, ray.numel()), "amin")
    visited = k <= first[ray]
    visits[:, 1] += torch.bincount(ray[visited], minlength=n)
    rows = torch.where(pair_hit, pair_rows, filled[cl])
    visits[:, 3] += torch.zeros(n, dtype=torch.int64, device=dev).index_add_(
        0, ray[visited], rows[visited])
    s_count = s_ent.shape[0]
    hp = h_ent.shape[0]
    occluded = first < ray.numel()
    c_stop = cl[first[occluded]]
    last_sup = torch.full((n,), s_count, dtype=torch.int64, device=dev)
    last_sup[occluded] = c_stop // GROUP
    sup_idx = torch.arange(s_count, device=dev)[:, None]
    descends = ((s_ent < t_lim[None]) & (sup_idx <= last_sup[None])).sum(0)
    visits[:, 0] += descends
    # Slab tests: every hyper up to the stopping one, every supercluster of
    # the entered hypers before it and of its page up to the stopping one,
    # 32 clusters a descend but the stopping descend's up to the occluder.
    last_hyp = torch.full((n,), hp, dtype=torch.int64, device=dev)
    last_hyp[occluded] = last_sup[occluded] // GROUP2
    h_idx = torch.arange(hp, device=dev)[:, None]
    h_in = (h_ent < t_lim[None]) & gate[None] & (h_idx < last_hyp[None])
    slabs = gate.long() * torch.clamp(last_hyp + occluded.long(), max=hp)
    slabs += (h_in.long() * _page_sups(s_count, hp, dev)[:, None]).sum(0) + GROUP * descends
    stop = torch.zeros(n, dtype=torch.int64, device=dev)
    stop[occluded] = (c_stop // GROUP - (c_stop // (GROUP * GROUP2)) * GROUP2 + 1
                      - (GROUP - 1 - c_stop % GROUP))
    visits[:, 2] += slabs + stop


def _ray_chunks(n, n_boxes):
    step = max(1, _CHUNK_ELEMS // max(n_boxes, 1))
    return range(0, n, step), step


def pair_quantities(c, ox, oy, oz, dx, dy, dz, mx, my, mz, cull_mode):
    """Sign-normalised Plücker quantities (sd, su, sv, st, ok) of record
    rows against rays (kernel_traverse.py:405-441). `c` holds the first 17
    feature columns, shaped to broadcast against the rays: [T, 1] columns
    against [n] rays give [T, n]."""
    det = c[0] * dx + c[1] * dy + c[2] * dz
    un = c[3] * mx + c[4] * my + c[5] * mz + c[6] * dx + c[7] * dy + c[8] * dz
    vn = c[9] * mx + c[10] * my + c[11] * mz + c[12] * dx + c[13] * dy + c[14] * dz
    tn = -(c[0] * ox + c[1] * oy + c[2] * oz) - c[15]
    sgn = torch.where(det >= 0.0, 1.0, -1.0)
    sd = det * sgn
    su = un * sgn
    sv = vn * sgn
    st = tn * sgn
    inside = torch.minimum(torch.minimum(torch.minimum(su, sv), sd - su - sv), st)
    if cull_mode == 0:
        ok = (inside >= 0.0) & (sd > TRI_EPS)
    elif cull_mode == 1:
        ok = (inside >= 0.0) & (det > TRI_EPS)
    else:
        ok = (inside >= 0.0) & (sd > TRI_EPS) & ((c[16] < 0.5) | (det > 0.0))
    return sd, su, sv, st, ok


def _pair_cols(rec_rows):
    """The 17 feature columns of gathered record rows [P, L, >=17] as
    [P, L] tensors, for pair_quantities against rays shaped [P, 1]."""
    return [rec_rows[:, :, j] for j in range(17)]


def traverse_clusters(tables, ox, oy, oz, dx, dy, dz, hit, cull_mode,
                      active=None, want_normal_mat=True, visits=None):
    """Nearest hit over the cluster set, improving strictly on `hit` =
    (best_t, best_p, nx, ny, nz, mid) per ray [n]. `active` (bool [n] or
    None) masks the rays that query. `visits` (int64 [n, 4] or None)
    receives each ray's supercluster descends, record visits, slab tests
    below the root gate and filled record rows tested. Returns the updated
    tuple."""
    bt, bp, nx, ny, nz, mid = hit
    bound = bt if active is None else torch.where(active, bt, torch.zeros_like(bt))
    rec = tables[0]
    rec17 = rec[:, :, :17]  # the columns the pair test reads
    n_boxes = rec.shape[0]
    l = rec.shape[1]
    best_t, best_p = bt.clone(), bp.clone()
    nx, ny, nz, mid = nx.clone(), ny.clone(), nz.clone(), mid.clone()
    filled = _filled_rows(rec)[0] if visits is not None else None
    starts, step = _ray_chunks(ox.shape[0], n_boxes)
    for a in starts:
        sl = slice(a, a + step)
        ray, cl, s_ent, c_ent, h_ent, gate = _candidates(tables, ox[sl], oy[sl], oz[sl], dx[sl],
                                                         dy[sl], dz[sl], bound[sl])
        pair_t = []
        ray_local = ray
        ray = ray + a
        p_step = max(1, _CHUNK_ELEMS // (l * 17))
        for b in range(0, ray.numel(), p_step):
            r = ray[b:b + p_step]
            c = cl[b:b + p_step]
            o = [v[r, None] for v in (ox, oy, oz, dx, dy, dz)]
            mx = o[1] * o[5] - o[2] * o[4]
            my = o[2] * o[3] - o[0] * o[5]
            mz = o[0] * o[4] - o[1] * o[3]
            sd, su, sv, st, ok = pair_quantities(_pair_cols(rec17[c]), *o, mx, my, mz, cull_mode)
            tv = st / torch.where(ok, sd, 1.0)
            key = torch.where(ok & (tv < bound[r, None]), tv, float("inf"))
            tmin, slot = key.min(dim=1)  # the lowest slot among equal t
            pair_t.append(tmin)
            # Per ray, the lowest (cluster, slot) of strictly minimal t:
            # pairs are ordered by ray then cluster, so that is the first
            # pair whose t equals the ray's minimum, and the pair improves
            # on the running best only if strictly below it.
            ray_min = torch.full_like(best_t, float("inf")).scatter_reduce(
                0, r, tmin, "amin"
            )
            first = torch.full_like(best_p, r.numel()).scatter_reduce(
                0, r, torch.where(tmin == ray_min[r], torch.arange(r.numel(), device=r.device),
                                  r.numel()), "amin"
            )
            won = (tmin < best_t[r]) & (first[r] == torch.arange(r.numel(), device=r.device))
            w = won.nonzero(as_tuple=True)[0]
            if w.numel() == 0:
                continue
            rw, sw = r[w], slot[w]
            row = rec[c[w], sw]  # [W, REC_COLS]
            best_t[rw] = tmin[w]
            best_p[rw] = row[:, C_PRIM].long()
            if want_normal_mat:
                sdw = sd[w, sw].clamp_min(1e-30)
                uw = su[w, sw] / sdw
                vw = sv[w, sw] / sdw
                w0 = 1.0 - uw - vw
                n0, n1, n2 = (row[:, C_N0 + 3 * k:C_N0 + 3 * k + 3] for k in range(3))
                snx = w0 * n0[:, 0] + uw * n1[:, 0] + vw * n2[:, 0]
                sny = w0 * n0[:, 1] + uw * n1[:, 1] + vw * n2[:, 1]
                snz = w0 * n0[:, 2] + uw * n1[:, 2] + vw * n2[:, 2]
                inv = torch.rsqrt(snx * snx + sny * sny + snz * snz + 1e-30)
                nx[rw] = snx * inv
                ny[rw] = sny * inv
                nz[rw] = snz * inv
                mid[rw] = row[:, C_MAT].long()
        if visits is not None:
            pt = torch.cat(pair_t) if pair_t else bound.new_empty(0)
            _count_nearest(visits[sl], ray_local, cl, pt, s_ent, c_ent, h_ent, gate, bound[sl],
                           filled)
    return best_t, best_p, nx, ny, nz, mid


def traverse_clusters_anyhit(tables, ox, oy, oz, dx, dy, dz, t_lim, cull_mode,
                             visits=None):
    """Any-hit over the cluster set: True where some triangle hits at t in
    [0, t_lim) (division-free: st < t_lim * sd). Rays with t_lim <= 0 do
    not query. `visits` (int64 [n, 4] or None) receives each ray's
    supercluster descends, record visits, slab tests below the root gate
    and filled record rows tested, as traverse_clusters."""
    rec = tables[0]
    rec17 = rec[:, :, :17]
    occ = torch.zeros(ox.shape[0], dtype=torch.bool, device=ox.device)
    if visits is not None:
        filled, cum = _filled_rows(rec)
    starts, step = _ray_chunks(ox.shape[0], rec.shape[0])
    for a in starts:
        sl = slice(a, a + step)
        ray, cl, s_ent, _, h_ent, gate = _candidates(tables, ox[sl], oy[sl], oz[sl], dx[sl],
                                                     dy[sl], dz[sl], t_lim[sl])
        pair_hit, pair_rows = [], []
        ray_local = ray
        ray = ray + a
        p_step = max(1, _CHUNK_ELEMS // (rec.shape[1] * 17))
        for b in range(0, ray.numel(), p_step):
            r = ray[b:b + p_step]
            o = [v[r, None] for v in (ox, oy, oz, dx, dy, dz)]
            mx = o[1] * o[5] - o[2] * o[4]
            my = o[2] * o[3] - o[0] * o[5]
            mz = o[0] * o[4] - o[1] * o[3]
            sd, _, _, st, ok = pair_quantities(
                _pair_cols(rec17[cl[b:b + p_step]]), *o, mx, my, mz, cull_mode
            )
            rows_hit = ok & (st < t_lim[r, None] * sd)
            hit = rows_hit.any(dim=1)
            occ[r[hit]] = True
            pair_hit.append(hit)
            if visits is not None:
                # Filled rows up to the first occluding one (argmax: the first).
                pair_rows.append(cum[cl[b:b + p_step], rows_hit.long().argmax(1)])
        if visits is not None:
            z = ox.new_zeros(0)
            ph = torch.cat(pair_hit) if pair_hit else z.bool()
            pr = torch.cat(pair_rows) if pair_rows else z.long()
            _count_anyhit(visits[sl], ray_local, cl, ph, pr, s_ent, h_ent, gate, t_lim[sl],
                          filled)
    return occ


def kernel_tables(scene):
    """(records, cluster bounds, supercluster pages, hyper bounds, root box)
    of a binned scene on its device: the order the traversal takes them."""
    return (scene.krn_records, scene.krn_cl_bounds, scene.krn_sup_bounds,
            scene.krn_hyp_bounds, root_box(scene.krn_hyp_bounds))


# ---------------------------------------------------------------------------
# K4: the standalone query.
# ---------------------------------------------------------------------------

_P = ctypes.c_void_p
_I = ctypes.c_int


def check_tensor(name, t, device, dtype, shape=None):
    """Raise unless `t` is a contiguous `dtype` tensor on `device` whose
    shape matches `shape` (None entries match any size): what a kernel
    wrapper checks before it hands a pointer to a kernel."""
    if t.device != device or t.dtype != dtype or not t.is_contiguous():
        raise ValueError(
            f"{name}: need a contiguous {dtype} tensor on {device}, got "
            f"{t.dtype} on {t.device} (contiguous={t.is_contiguous()})"
        )
    if shape is not None and (t.dim() != len(shape) or any(
            s is not None and t.shape[i] != s for i, s in enumerate(shape))):
        raise ValueError(f"{name}: need shape {shape}, got {tuple(t.shape)}")


def check_tables(tables, device):
    """Raise unless the traversal tables have the kernel's layout."""
    rec, clb, sup, hyp, root = tables
    check_tensor("krn_records", rec, device, torch.float32, (None, None, REC_COLS))
    check_tensor("krn_cl_bounds", clb, device, torch.float32, (None, GROUP, BND_COLS))
    check_tensor("krn_sup_bounds", sup, device, torch.float32, (None, GROUP2, BND_COLS))
    check_tensor("krn_hyp_bounds", hyp, device, torch.float32, (None, BND_COLS))
    check_tensor("root box", root, device, torch.float32, (1, BND_COLS))
    if rec.shape[0] != clb.shape[0] * GROUP or hyp.shape[0] < sup.shape[0]:
        raise ValueError("inconsistent traversal tier shapes")
    if rec.shape[1] % 8 or rec.shape[1] > 128:
        raise ValueError(f"record height {rec.shape[1]}: need a multiple of 8, <= 128")


# table_args' place holders for a dense scene (no tiers), with cull mode -1.
NO_TIERS = (None, 0, 0, None, None, 0, None, 0, None, -1)


def table_args(tables):
    """The tables as the kernels' C arguments: rec, n_rec, rec_rows, clb,
    sup, n_pages, hyp, hyp_rows, root."""
    rec, clb, sup, hyp, root = tables
    return (rec.data_ptr(), rec.shape[0], rec.shape[1], clb.data_ptr(), sup.data_ptr(),
            sup.shape[0], hyp.data_ptr(), hyp.shape[0], root.data_ptr())


def _query_fn():
    lib = _build.load("cluster_query")
    fn = lib.ptx_cluster_query_launch
    if fn.argtypes is None:
        fn.argtypes = ([_P, _P, _P, _P, _P, _I]  # origin direction t_lim t prim n
                       + [_P, _I, _I, _P, _P, _I, _P, _I, _P]  # tables, root box
                       + [_I, _I, _P, _P, _P]  # cull mode, any_hit, visits, steps, next ray
                       + [_I, ctypes.c_longlong, _P])  # grid, shared bytes, stream
        fn.restype = ctypes.c_int
    return fn


# Rays per row of the traversal counters: one TPU ray block of 8 x 128.
VISIT_BLOCK = 1024
# The counters of one walk (K4's columns; traverse_clusters[_anyhit]'s
# `visits`): supercluster descends, record visits, slab tests below the root
# gate, filled record rows tested.
WALK_COLS = 4
# The K1 / K2 counters (csrc/binned_geo.cuh kGeoVisitCols): the JAX
# package's four (nearest descends, nearest record visits, shadow descends,
# shadow record visits), then the nearest and shadow walks' slab tests and
# filled rows, then the nearest queries (one per ray-bounce).
GEO_VISIT_COLS = 9
NEAR_COLS = [0, 1, 4, 5]
SHADOW_COLS = [2, 3, 6, 7]
QUERY_COL = 8


# The walk's warp steps (csrc/binned_geo.cuh kWarpStepCols), counted by
# K1's binned form and K2 beside their counters: the slab-test steps and the
# filled-row steps the warps execute (once per step, by the lowest active
# lane), summed over a launch. They depend on how the card schedules lanes,
# so no plain version reproduces them. K4's counting instance
# (csrc/cluster_query.cu kQueryStepCols) adds, at each filled-row step, the
# distinct clusters among the warp's active lanes and the active lanes.
WARP_STEP_COLS = 2
QUERY_STEP_COLS = 4
WARP_LANES = 32


def warp_utilisation(visits, steps):
    """Lane utilisation of the walks of K1 / K2 counters `visits` [..., 9]
    against their warp steps `steps` [2] (slab-test steps, filled-row
    steps), or of K4 counters [..., 4] against K4's steps [4] (the same
    two, then the clusters and the active lanes summed over the filled-row
    steps): work / (32 x steps) for the slab tests and the filled rows
    tested, and for K4 the mean distinct clusters and active lanes per
    filled-row step. Raises ValueError unless steps <= work <= 32 x steps
    for each, which also makes steps > 0 wherever work > 0, and for K4
    unless row steps <= clusters <= active lanes <= 32 x row steps and
    filled rows <= active lanes."""
    cols = torch.as_tensor(visits).shape[-1]
    v = torch.as_tensor(visits).reshape(-1, cols).long().sum(0).tolist()
    st = torch.as_tensor(steps).reshape(-1).long().tolist()
    want = QUERY_STEP_COLS if cols == WALK_COLS else WARP_STEP_COLS
    if len(st) != want:
        raise ValueError(f"warp steps: need {want} columns, got {len(st)}")
    if cols == WALK_COLS:
        work = dict(slab=v[2], row=v[3])
    else:
        work = dict(slab=v[NEAR_COLS[2]] + v[SHADOW_COLS[2]],
                    row=v[NEAR_COLS[3]] + v[SHADOW_COLS[3]])
    out = {}
    for (name, w), n in zip(work.items(), st):
        if not n <= w <= WARP_LANES * n:
            raise ValueError(f"{name} steps {n} against {w} tests: need steps <= tests <= "
                             f"{WARP_LANES} x steps")
        out.update({f"{name}_tests": w, f"{name}_steps": n,
                    f"{name}_lane_utilisation": w / (WARP_LANES * n) if n else None})
    if cols == WALK_COLS:
        n, clusters, active = st[1], st[2], st[3]
        if not n <= clusters <= active <= WARP_LANES * n or work["row"] > active:
            raise ValueError(f"row steps {n}, clusters {clusters}, active lanes {active}, "
                             f"filled rows {work['row']}: need steps <= clusters <= active "
                             f"<= {WARP_LANES} x steps and filled rows <= active")
        out.update(row_clusters=clusters, row_active_lanes=active,
                   clusters_per_row_step=clusters / n if n else None,
                   active_lanes_per_row_step=active / n if n else None)
    return out


class WalkLayout(NamedTuple):
    """The layout of a binned K1 / K2 block's dynamic shared memory as the
    kernels are built (csrc/binned_geo.cuh ptx_walk_layout): threads a
    block, ring slots a thread, bytes a slot, and the most tier floats
    staged (larger tiers are read from global memory)."""

    threads: int
    depth: int
    slot_bytes: int
    tier_floats: int


# The dynamic shared memory a Hopper block can use (227 KB).
SMEM_LIMIT = 232448

_LAYOUTS: dict = {}


def walk_layout(library):
    """The WalkLayout that csrc/<library>.cu ("megakernel" or "bounce") was
    built with, read from the library (built at first use)."""
    if library not in _LAYOUTS:
        fn = _build.load(library).ptx_walk_layout
        fn.argtypes = [ctypes.POINTER(ctypes.c_int)] * 4
        fn.restype = ctypes.c_int
        out = [ctypes.c_int(0) for _ in range(4)]
        fn(*(ctypes.byref(v) for v in out))
        _LAYOUTS[library] = WalkLayout(*(v.value for v in out))
    return _LAYOUTS[library]


def walk_smem_bytes(layout):
    """Bytes of the rings of a block: `layout.depth` slots of
    `layout.slot_bytes` for each of its `layout.threads` walks."""
    return layout.depth * layout.slot_bytes * layout.threads


def tier_floats(n_pages, layout):
    """Shared floats of the staged hyper and supercluster boxes (0 when
    they exceed `layout.tier_floats` and are read from global memory)."""
    n = n_pages * (BND_COLS + GROUP2 * BND_COLS)
    return n if n <= layout.tier_floats else 0


def kernel_smem_bytes(table_floats, n_pages=None, layout=None):
    """Dynamic shared memory of a K1 / K2 block: `table_floats` floats of
    staged tables, and for a binned scene (`n_pages` supercluster pages, the
    kernels' WalkLayout `layout`) the staged tiers, then the rings at a
    16-byte boundary. Raises ValueError above SMEM_LIMIT: the launch would
    be refused, and no smaller form is taken instead."""
    if n_pages is None:
        total = table_floats * 4
    else:
        floats = table_floats + tier_floats(n_pages, layout)
        total = -(-floats // 4) * 16 + walk_smem_bytes(layout)
    if total > SMEM_LIMIT:
        raise ValueError(f"the block needs {total} bytes of shared memory: above {SMEM_LIMIT}")
    return total


def block_sums(per_ray, block=VISIT_BLOCK):
    """[n, k] per-ray counts -> [ceil(n / block), k] int32 sums over each
    block of `block` consecutive rays (the counters' rows)."""
    n, k = per_ray.shape
    rows = -(-n // block)
    out = torch.zeros((rows * block, k), dtype=torch.int64, device=per_ray.device)
    out[:n] = per_ray
    return out.reshape(rows, block, k).sum(1).to(torch.int32)


def _limits(o, t_max):
    r = o.shape[0]
    if t_max is None:
        return torch.full((r,), float("inf"), device=o.device)
    return torch.as_tensor(t_max, dtype=torch.float32, device=o.device)


def cluster_intersect_reference(scene, o, d, t_max=None, any_hit=False, debug_visits=False):
    """The plain version of `cluster_intersect`, on the device of `o`."""
    cluster_intersect_reference.calls += 1
    dev = o.device
    r = o.shape[0]
    lim = _limits(o, t_max)
    tables = kernel_tables(scene.to(dev))
    c = [o[:, 0], o[:, 1], o[:, 2], d[:, 0], d[:, 1], d[:, 2]]
    vis = torch.zeros((r, WALK_COLS), dtype=torch.int64, device=dev) if debug_visits else None
    if any_hit:
        occ = traverse_clusters_anyhit(tables, *c, lim, scene.krn_cull_mode, visits=vis)
        out = torch.where(occ, 1.0, -1.0), torch.where(occ, 0, -1).long()
    else:
        z = torch.zeros(r, device=dev)
        miss = torch.full((r,), -1, dtype=torch.int64, device=dev)
        t, p, *_ = traverse_clusters(tables, *c, (lim, miss, z, z, z, miss),
                                     scene.krn_cull_mode, want_normal_mat=False, visits=vis)
        out = torch.where(p >= 0, t, -1.0), p
    return (*out, block_sums(vis)) if debug_visits else out


cluster_intersect_reference.calls = 0


def resident_grid(n_rays, threads, blocks_per_sm, sms):
    """The grid of a launch on refilling persistent warps (K1, K4): the
    resident blocks (`sms` x `blocks_per_sm` of `threads` threads), at most
    one thread per ray. Raises ValueError when no block of the instance
    fits an SM (its shared memory or registers)."""
    if blocks_per_sm < 1:
        raise ValueError(f"no block of {threads} threads fits an SM")
    return max(1, min(-(-n_rays // threads), sms * blocks_per_sm))


def query_occupancy(smem_bytes, count=False, any_hit=False):
    """(resident blocks per SM, threads per block) of K4's plain or
    counting, nearest or any-hit instance at `smem_bytes` of dynamic shared
    memory, by cudaOccupancyMaxActiveBlocksPerMultiprocessor on the current
    card."""
    fn = _build.load("cluster_query").ptx_cluster_query_occupancy
    if fn.argtypes is None:
        fn.argtypes = [_I, _I, ctypes.c_longlong, ctypes.POINTER(_I), ctypes.POINTER(_I)]
        fn.restype = ctypes.c_int
    blocks, threads = ctypes.c_int(0), ctypes.c_int(0)
    err = fn(int(bool(count)), int(bool(any_hit)), int(smem_bytes), ctypes.byref(blocks),
             ctypes.byref(threads))
    if err:
        raise RuntimeError(f"cluster_query occupancy query failed: cudaError_t {err}")
    return blocks.value, threads.value


# (library, card, instance, shared memory) -> (blocks per SM, threads): a
# launch queries its instance's occupancy once and then keeps it.
_QUERY_RESIDENT: dict = {}


def query_smem_bytes(n_pages):
    """K4's dynamic shared memory for a scene of `n_pages` supercluster
    pages: the staged tiers and its rings (its own WalkLayout)."""
    return kernel_smem_bytes(0, n_pages, walk_layout("cluster_query"))


def cluster_intersect(scene, o, d, t_max=None, any_hit=False, debug_visits=False,
                      warp_steps=None):
    """Standalone query of the cluster set (the dense big-triangle and
    sphere parts are not included), as `cluster_intersect_kernel` of the
    JAX package. o, d: [R,3] f32 tensors. Returns (t [R], prim [R] i64),
    -1 / -1 on a miss; for any_hit, t = 1.0 and prim = 0 where something
    occludes in [0, t_max). With `debug_visits`, also the traversal
    counters [ceil(R / 1024), 4] int32: per block of 1024 rays, the summed
    supercluster descends, record visits, slab tests below the root gate
    and filled record rows tested of its rays (per-ray counts, not the
    TPU's per-block ones). `warp_steps` (with `debug_visits`, on the card):
    a zeroed [4] int64 tensor the warps' steps are added to
    (`warp_utilisation`). CPU tensors take the plain version; CUDA tensors
    launch K4 (csrc/cluster_query.cu) on the resident blocks, whose warps
    claim the rays from a counter."""
    dev = o.device
    if warp_steps is not None:
        if not debug_visits or dev.type != "cuda":
            raise ValueError("cluster_intersect: warp_steps are counted on the card, with "
                             "debug_visits")
        check_tensor("warp_steps", warp_steps, dev, torch.int64, (QUERY_STEP_COLS,))
    if dev.type == "cpu":
        return cluster_intersect_reference(scene, o, d, t_max, any_hit, debug_visits)
    if dev.type != "cuda":
        raise ValueError(f"cluster_intersect: no kernel for device {dev}")
    r = o.shape[0]
    lim = _limits(o, t_max).contiguous()
    tables = kernel_tables(scene.to(dev))
    check_tensor("origin", o, dev, torch.float32, (r, 3))
    check_tensor("direction", d, dev, torch.float32, (r, 3))
    check_tensor("t_max", lim, dev, torch.float32, (r,))
    check_tables(tables, dev)
    smem = query_smem_bytes(tables[2].shape[0])
    # The warps hand rays out from a counter: t starts as NaN, so a ray no
    # lane ran shows.
    t = torch.full((r,), float("nan"), device=dev)
    p = torch.empty(r, dtype=torch.int32, device=dev)
    vis = (torch.zeros((-(-r // VISIT_BLOCK), WALK_COLS), dtype=torch.int32, device=dev)
           if debug_visits else None)
    if debug_visits and warp_steps is None:
        warp_steps = torch.zeros(QUERY_STEP_COLS, dtype=torch.int64, device=dev)
    if r:
        next_ray = torch.zeros(1, dtype=torch.int32, device=dev)
        with torch.cuda.device(dev):
            key = (_build.load("cluster_query")._name, torch.cuda.current_device(),
                   bool(debug_visits), bool(any_hit), smem)
            if key not in _QUERY_RESIDENT:
                _QUERY_RESIDENT[key] = query_occupancy(smem, debug_visits, any_hit)
            per_sm, threads = _QUERY_RESIDENT[key]
            grid = resident_grid(r, threads, per_sm,
                                 torch.cuda.get_device_properties(dev).multi_processor_count)
            err = _query_fn()(
                o.data_ptr(), d.data_ptr(), lim.data_ptr(), t.data_ptr(), p.data_ptr(), r,
                *table_args(tables), int(scene.krn_cull_mode), int(bool(any_hit)),
                None if vis is None else vis.data_ptr(),
                None if vis is None else warp_steps.data_ptr(), next_ray.data_ptr(), grid, smem,
                torch.cuda.current_stream(dev).cuda_stream,
            )
        if err:
            raise RuntimeError(f"cluster_query launch failed: cudaError_t {err}")
        cluster_intersect.launches += 1
    return (t, p.long(), vis) if debug_visits else (t, p.long())


cluster_intersect.launches = 0
