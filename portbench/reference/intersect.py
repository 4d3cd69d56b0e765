"""Nearest-hit and shadow queries of the plain reference, over every
triangle, with no acceleration structure of the program's.

The ray-triangle test is the division-free Plucker form the estimator is
defined with (the JAX package's pair test, cpupathtrace_tpu/accel/
kernel_traverse.py pair_test_nearest / pair_test_anyhit): per triangle the
features -N, e2, v0 x e2, -e1, -(v0 x e1), v0 . N (N = e1 x e2), worked out
here from the vertices in float32 as the upstream record packing orders
them. The form matters where the estimator itself ties: the shadow ray to a
sampled emitter point starts epsilon along its direction and stops epsilon
short, so in exact arithmetic it meets the emitter at exactly its limit,
and rounding in this form decides the tie (`st < t_lim * sd`).

Large triangles (box diagonal over 5% of the scene's) are tested against
every ray first. The rest are cut into leaves of `leaf` triangles in Morton
order of their centroids; a ray tests the triangles of each leaf whose
padded box it enters. That cut is the reference's own: it changes which
triangles are tested, never the result of a test. A triangle wins only by
improving strictly on the running nearest t, so among equal t the large
set, then the lowest index, wins.
"""
from __future__ import annotations

import torch

from .scene import RefScene

DET_EPS = 1e-6
SMALL_SCENE = 4096
PAIR_BLOCK = 1 << 22  # ray-triangle tests per tensor


def _morton(c: torch.Tensor) -> torch.Tensor:
    """30-bit Morton codes of points in [0, 1)^3."""
    q = (c.clamp(0.0, 0.999999) * 1024.0).long()
    code = torch.zeros(c.shape[0], dtype=torch.int64, device=c.device)
    for b in range(10):
        for k in range(3):
            code |= ((q[:, k] >> b) & 1) << (3 * b + 2 - k)
    return code


class Geometry:
    def __init__(self, scene: RefScene, dtype=torch.float32, leaf: int = 512,
                 small_scene: int = SMALL_SCENE):
        self.dtype = dtype
        self.feat = scene.plucker.to(dtype)
        self.cull = scene.cull
        dev = self.feat.device
        v0, e1, e2 = scene.v0, scene.e1, scene.e2
        n = scene.n_tri
        lo = torch.minimum(torch.minimum(v0, v0 + e1), v0 + e2)
        hi = torch.maximum(torch.maximum(v0, v0 + e1), v0 + e2)
        self.leaves = None
        if n <= small_scene:
            self.big = torch.arange(n, device=dev)
            return
        diag = (hi - lo).norm(dim=1)
        is_big = diag > 0.05 * (hi.max(0).values - lo.min(0).values).norm()
        self.big = is_big.nonzero()[:, 0]
        small = (~is_big).nonzero()[:, 0]
        cen = (lo[small] + hi[small]) * 0.5
        c_lo, c_hi = cen.min(0).values, cen.max(0).values
        small = small[torch.argsort(_morton((cen - c_lo) / (c_hi - c_lo).clamp_min(1e-30)))]
        n_leaf = -(-small.numel() // leaf)
        # Padding repeats the leaf's last triangle: it cannot change a result.
        ids = torch.cat([small, small[-1:].expand(n_leaf * leaf - small.numel())])
        self.leaves = ids.reshape(n_leaf, leaf)
        box_lo = lo[self.leaves].min(1).values
        box_hi = hi[self.leaves].max(1).values
        margin = (box_hi - box_lo) * 1e-4 + 1e-6
        self.box_lo = (box_lo - margin).to(dtype)
        self.box_hi = (box_hi + margin).to(dtype)

    def _quantities(self, o, d, ids):
        """Sign-normalised (sd, su, sv, st, ok) [R,K] of rays o, d [R,3]
        against triangles ids ([R,K] or [K])."""
        c = self.feat[ids]
        cull = self.cull[ids]
        if ids.dim() == 1:
            c, cull = c[None], cull[None]
        ox, oy, oz = o[:, 0, None], o[:, 1, None], o[:, 2, None]
        dx, dy, dz = d[:, 0, None], d[:, 1, None], d[:, 2, None]
        mx = oy * dz - oz * dy
        my = oz * dx - ox * dz
        mz = ox * dy - oy * dx
        f = [c[..., j] for j in range(16)]
        det = f[0] * dx + f[1] * dy + f[2] * dz
        un = f[3] * mx + f[4] * my + f[5] * mz + f[6] * dx + f[7] * dy + f[8] * dz
        vn = f[9] * mx + f[10] * my + f[11] * mz + f[12] * dx + f[13] * dy + f[14] * dz
        tn = -(f[0] * ox + f[1] * oy + f[2] * oz) - f[15]
        sgn = torch.where(det >= 0, 1.0, -1.0).to(det.dtype)
        sd, su, sv, st = det * sgn, un * sgn, vn * sgn, tn * sgn
        inside = torch.minimum(torch.minimum(torch.minimum(su, sv), sd - su - sv), st)
        ok = (inside >= 0) & (sd > DET_EPS) & (~cull | (det > 0))
        return sd, su, sv, st, ok

    def _nearest_of(self, o, d, ids, bound):
        """Per ray the first least t of ids below `bound`: (t, prim, su/sd, sv/sd)."""
        sd, su, sv, st, ok = self._quantities(o, d, ids)
        t = torch.where(ok, st / sd, torch.full_like(sd, float("inf")))
        t = torch.where(t < bound[:, None], t, torch.full_like(t, float("inf")))
        j = torch.argmin(t, 1)[:, None]  # the first of equal minima
        ids = ids.expand(t.shape) if ids.dim() == 1 else ids
        sdw = sd.gather(1, j).clamp_min(1e-30)
        return (t.gather(1, j)[:, 0], ids.gather(1, j)[:, 0],
                (su.gather(1, j) / sdw)[:, 0], (sv.gather(1, j) / sdw)[:, 0])

    def _leaf_pairs(self, o, d, t_max):
        """(ray, leaf) pairs whose padded box the ray enters below t_max."""
        inv = 1.0 / torch.where(d.abs() < 1e-30, torch.where(d < 0, -1e-30, 1e-30).to(d.dtype), d)
        pairs = []
        step = max(1, PAIR_BLOCK // self.leaves.shape[0])
        for a in range(0, o.shape[0], step):
            oo, ii, tm = o[a:a + step, None, :], inv[a:a + step, None, :], t_max[a:a + step, None]
            t0 = (self.box_lo[None] - oo) * ii
            t1 = (self.box_hi[None] - oo) * ii
            near = torch.minimum(t0, t1).max(-1).values
            far = torch.maximum(t0, t1).min(-1).values
            rr, ll = ((far >= near.clamp_min(0.0)) & (near < tm)).nonzero(as_tuple=True)
            pairs.append(torch.stack([rr + a, ll], 1))
        return torch.cat(pairs)

    def nearest(self, o, d):
        """(t [R], prim [R] (-1: miss), u [R], v [R]) of the nearest hit."""
        r = o.shape[0]
        inf = torch.full((r,), float("inf"), dtype=self.dtype, device=o.device)
        t, prim = inf.clone(), torch.full((r,), -1, dtype=torch.int64, device=o.device)
        u, v = torch.zeros_like(inf), torch.zeros_like(inf)
        step = max(1, PAIR_BLOCK // max(self.big.numel(), 1))
        for a in range(0, r if self.big.numel() else 0, step):
            s = slice(a, a + step)
            t[s], prim[s], u[s], v[s] = self._nearest_of(o[s], d[s], self.big, inf[s])
        prim = torch.where(torch.isfinite(t), prim, -1)
        if self.leaves is None or r == 0:
            return t, prim, u, v
        pairs = self._leaf_pairs(o, d, t)
        res = []
        step = max(1, PAIR_BLOCK // self.leaves.shape[1])
        for a in range(0, pairs.shape[0], step):
            ray, leaf = pairs[a:a + step, 0], pairs[a:a + step, 1]
            res.append((ray, *self._nearest_of(o[ray], d[ray], self.leaves[leaf], t[ray])))
        if not res:
            return t, prim, u, v
        ray, lt, lp, lu, lv = (torch.cat(x) for x in zip(*res))
        hit = torch.isfinite(lt)
        ray, lt, lp, lu, lv = ray[hit], lt[hit], lp[hit], lu[hit], lv[hit]
        # Per ray the least t over its leaves, the lowest index among equal t.
        order = torch.argsort(lp, stable=True)
        order = order[torch.argsort(lt[order], stable=True)]
        order = order[torch.argsort(ray[order], stable=True)]
        first = torch.ones(order.numel(), dtype=torch.bool, device=o.device)
        first[1:] = ray[order][1:] != ray[order][:-1]
        w = order[first]
        rw = ray[w]
        t[rw], prim[rw], u[rw], v[rw] = lt[w], lp[w], lu[w], lv[w]
        return t, prim, u, v

    def _any(self, o, d, ids, t_lim):
        sd, _, _, st, ok = self._quantities(o, d, ids)
        return (ok & (st < t_lim[:, None] * sd)).any(1)

    def occluded(self, o, d, t_max):
        """True where a triangle lies below t_max along the ray."""
        r = o.shape[0]
        t_lim = t_max.clamp_min(0.0)
        hit = torch.zeros(r, dtype=torch.bool, device=o.device)
        step = max(1, PAIR_BLOCK // max(self.big.numel(), 1))
        for a in range(0, r if self.big.numel() else 0, step):
            s = slice(a, a + step)
            hit[s] = self._any(o[s], d[s], self.big, t_lim[s])
        if self.leaves is None or r == 0:
            return hit
        pairs = self._leaf_pairs(o, d, t_lim)
        step = max(1, PAIR_BLOCK // self.leaves.shape[1])
        for a in range(0, pairs.shape[0], step):
            ray, leaf = pairs[a:a + step, 0], pairs[a:a + step, 1]
            hit[ray[self._any(o[ray], d[ray], self.leaves[leaf], t_lim[ray])]] = True
        return hit
