"""The cluster walk of csrc/cluster_traverse.cuh as K1's binned form, K2
and K4 run it, one test a step (`Walk`), in a plain numpy model: the lanes
of a warp step their walks in lockstep, one test each a turn. A walk's
tests and results do not depend on how its lanes are scheduled, only its
warps' steps do; the lockstep schedule is one schedule, not the card's,
and its steps show the bounds that every schedule's steps keep. Each
lane's cluster boxes and record rows come through a model of its cp.async ring
(`Ring<D, T>`: commit groups that land at the waits, the newest first, so
that a copy left in flight overwrites what a later stream put in its
slot). Two ways to test a visited record's rows: each lane its own, one
row a turn (`Walk::step`, K4's walk), or together (`walk_together`, K1's
binned form and K2): a lane whose cluster box passes posts the cluster and
waits, and when the warp serves (kServeWaiting, read from the source) the
warp's lanes test the record's rows in rounds of one row a lane for each
lane that posted it, the round's least (t, row) taken where it improves
strictly (any-hit: the round's lowest occluding row). Per ray, the model's
result and its counters (descends, record visits, slab tests, filled rows
tested) must equal the plain walk's, `traverse_clusters` /
`traverse_clusters_anyhit` with `visits`, on a few hundred triangles at 56-
and 128-row records (also with rows planted at equal t, NaN rows and
occluders in the middle of a round), two hyper pages of a dragon and a
plate of small triangles that stops shadow walks early; the warps' steps
lie between the largest lane's tests and the sum of its lanes' tests
(rows tested together: at most the lane-alone walk's row steps), within
`warp_utilisation`'s bounds; models that skip the page's box-stream
restart or the drain before a visit or a serve, a round reduced without
its row tie-break and an any-hit round that counts its filled rows past
the occluder fail; and experiments/walk_stepping.py still finds the walks
and the constant it rewrites. The kernels themselves run on the card
(tests/test_torch_cuda.py, chip_smoke.py).
"""
import numpy as np
import pytest
import torch

from cpupathtrace_tpu_torch.accel import kernel_traverse as kt
from cpupathtrace_tpu_torch.accel.pair_record import C_PRIM
from cpupathtrace_tpu_torch.scene.geometry import make_box
from cpupathtrace_tpu_torch.scene.mesh import mesh_from_arrays
from cpupathtrace_tpu_torch.scene.scene import SceneBuilder
from tests.torch_util import CPU, dragon_scene, mixed_cull_scene, query_rays

F32 = np.float32
LANES = 32
DEPTH = 3  # WalkRing's slots (kRingDepth); the results do not depend on it
ROW_FLOATS, BOX_FLOATS = 20, 8  # kRowPieces and kBoxPieces 16-byte pieces
HYPER, SUPER, BOX, ROW, DONE = range(5)  # WalkPhase
TRI_EPS = F32(kt.TRI_EPS)
FLT_MAX = F32(kt.FLT_MAX)


def _inv(d):
    out = np.full(d.shape, FLT_MAX, F32)
    np.divide(F32(1.0), d, out=out, where=np.abs(d) > 0)
    return out


def slab_entry(b, o, inv):
    """Clamped slab entries of boxes b [n, 8] against rays o, inv [n, 3]
    (cluster_traverse.cuh slab_entry), +inf on a miss; NaN enters nothing."""
    t1 = [(b[:, j] - o[:, j]) * inv[:, j] for j in range(3)]
    t2 = [(b[:, j + 3] - o[:, j]) * inv[:, j] for j in range(3)]
    lo = [np.minimum(a, c) for a, c in zip(t1, t2)]
    hi = [np.maximum(a, c) for a, c in zip(t1, t2)]
    tmin = np.maximum(np.maximum(lo[0], lo[1]), lo[2])
    tmax = np.minimum(np.minimum(hi[0], hi[1]), hi[2])
    miss = (b[:, 6] < 0.5) | (tmax < 0) | (tmin > tmax)
    return np.where(miss, F32(np.inf), np.maximum(tmin, F32(0)))


def pair_test(q, o, d, m, cull):
    """The pair test of record rows q [n, >= 17] against rays: (sd, su, sv,
    st, ok), as dense_intersect.cuh pair_quantities; a NaN row is never
    ok."""
    with np.errstate(invalid="ignore"):
        return _pair_test(q, o, d, m, cull)


def _pair_test(q, o, d, m, cull):
    c = [q[:, j] for j in range(17)]
    det = c[0] * d[:, 0] + c[1] * d[:, 1] + c[2] * d[:, 2]
    un = (c[3] * m[:, 0] + c[4] * m[:, 1] + c[5] * m[:, 2] + c[6] * d[:, 0] + c[7] * d[:, 1]
          + c[8] * d[:, 2])
    vn = (c[9] * m[:, 0] + c[10] * m[:, 1] + c[11] * m[:, 2] + c[12] * d[:, 0]
          + c[13] * d[:, 1] + c[14] * d[:, 2])
    tn = -(c[0] * o[:, 0] + c[1] * o[:, 1] + c[2] * o[:, 2]) - c[15]
    sgn = np.where(det >= 0, F32(1), F32(-1))
    sd, su, sv, st = det * sgn, un * sgn, vn * sgn, tn * sgn
    inside = np.minimum(np.minimum(np.minimum(su, sv), sd - su - sv), st)
    if cull == 0:
        ok = (inside >= 0) & (sd > TRI_EPS)
    elif cull == 1:
        ok = (inside >= 0) & (det > TRI_EPS)
    else:
        ok = (inside >= 0) & (sd > TRI_EPS) & ((c[16] < 0.5) | (det > 0))
    return sd, su, sv, st, ok


class Rings:
    """Each lane's ring of DEPTH slots (Ring<D, T>): a stream of boxes (the
    32 of a page), of rows (a cluster's) or of a lane's share of a served
    record's rows (rows off, off + stride, ..., through the first DEPTH - 1
    slots: the last holds the lane's ray while the warp serves); element e
    of a stream goes to slot e mod S of its S slots. copy() commits one
    group that lands only at a wait (the newest first among those landing),
    at(k) copies element k + S - 1, then waits for all but S - 1 groups and
    reads slot k mod S; drain() waits for all."""

    def __init__(self, n, clb, rec):
        self.clb, self.rec = clb, rec
        self.slots = np.zeros((n, DEPTH, ROW_FLOATS), F32)
        self.rows = np.zeros(n, bool)  # the stream's kind
        self.src = np.zeros(n, np.int64)  # its page or cluster
        self.count = np.zeros(n, np.int64)
        self.off = np.zeros(n, np.int64)  # a row stream's first row and stride
        self.stride = np.ones(n, np.int64)
        self.pending = [[] for _ in range(n)]  # per lane: (slot, data or None)

    def copy(self, lanes, e, s):
        for i, ei in zip(lanes, e):
            data = None
            if ei < self.count[i]:
                data = (self.rec[self.src[i], self.off[i] + ei * self.stride[i], :ROW_FLOATS]
                        if self.rows[i] else self.clb[self.src[i], ei, :BOX_FLOATS])
            self.pending[i].append((ei % s, data))

    def wait(self, lanes, keep):
        for i in lanes:
            cut = max(len(self.pending[i]) - keep, 0)
            landing, self.pending[i] = self.pending[i][:cut], self.pending[i][cut:]
            for sl, data in reversed(landing):
                if data is not None:
                    self.slots[i, sl, :data.shape[0]] = data

    def drain(self, lanes):
        self.wait(lanes, 0)

    def begin(self, lanes, rows, src, count, first, off=0, stride=1, s=DEPTH):
        self.rows[lanes], self.src[lanes], self.count[lanes] = rows, src, count
        self.off[lanes], self.stride[lanes] = off, stride
        for j in range(s - 1):
            self.copy(lanes, np.broadcast_to(first + j, lanes.shape), s)

    def at(self, lanes, k, s=DEPTH):
        k = np.broadcast_to(k, lanes.shape)
        self.copy(lanes, k + s - 1, s)
        self.wait(lanes, s - 1)
        return self.slots[lanes, k % s].copy()


def shipped_serve_waiting():
    """cluster_traverse.cuh's kServeWaiting: when the warp serves."""
    from cpupathtrace_tpu_torch.experiments import walk_stepping as ws

    text = (ws._build.CSRC / "cluster_traverse.cuh").read_text()
    (value,) = ws.SERVE.findall(text)
    return int(value)


def walk_model(tables, cull, o, d, bound, any_hit, restart=True, drain=True, together=False,
               serve_waiting=None, tie_break=True, count_upto=True):
    """Every ray's walk stepped in lockstep, warps of LANES consecutive
    rays, each turn one step of every lane whose walk has not ended (with
    `together`, every lane not posted at a cluster). Returns the per-ray
    result (nearest: t [n], prim [n], -1 without a winner; any-hit:
    occluded [n]), the counters [n, 4] (descends, record visits, slab
    tests, filled rows tested), the steps each lane took [n] and each
    warp's counts [warps, 4]: slab steps, filled-row steps, then (alone)
    distinct clusters and row lanes at the filled-row steps
    (csrc/cluster_query.cu QuerySteps) or (together) the served record
    streams and 0. `restart` / `drain` False break the ring's protocol:
    no box stream restarted after a visit or a serve; no drain before a
    visit's or a serve's rows. `together` tests a visited record's rows
    across the warp (walk_together), which serves when no lane can take a
    box step, or, for `serve_waiting` n > 0 (None: the shipped value), also
    once n lanes wait; `tie_break` False takes the last lane of a round's
    equal least t, `count_upto` False counts the whole round of an
    occluding row."""
    rec, clb, sup, hyp, root = (t.numpy().astype(F32) for t in tables)
    n = o.shape[0]
    rec_rows, n_sup, n_pages = rec.shape[1], clb.shape[0], sup.shape[0]
    sup = sup.reshape(-1, kt.BND_COLS)
    o, d = o.astype(F32), d.astype(F32)
    inv = np.stack([_inv(d[:, j]) for j in range(3)], 1)
    m = np.stack([o[:, 1] * d[:, 2] - o[:, 2] * d[:, 1], o[:, 2] * d[:, 0] - o[:, 0] * d[:, 2],
                  o[:, 0] * d[:, 1] - o[:, 1] * d[:, 0]], 1)
    bound = bound.astype(F32).copy()
    phase = np.where(slab_entry(np.repeat(root, n, 0), o, inv) < bound, HYPER, DONE)
    h, s, g, k = (np.zeros(n, np.int64) for _ in range(4))
    win = np.full(n, -1, np.int64)
    counts = np.zeros((n, 4), np.int64)
    steps = np.zeros(n, np.int64)
    warps = np.zeros((-(-n // LANES), 4), np.int64)
    warp_of = np.arange(n) // LANES
    rings = Rings(n, clb, rec)
    if serve_waiting is None:
        serve_waiting = shipped_serve_waiting()

    def serve(w, lanes, c, peers):
        """Cluster c's rows for the lanes `peers` of warp w's `lanes`."""
        n_lanes = lanes.size
        rank = np.arange(n_lanes)
        mine = np.where(rank < rec_rows, (rec_rows - rank + n_lanes - 1) // n_lanes, 0)
        rings.begin(lanes, True, c, mine, 0, off=rank, stride=n_lanes, s=DEPTH - 1)
        warps[w, 2] += 1
        open_ = list(peers)
        for rnd in range(-(-rec_rows // n_lanes)):
            if not open_:
                break
            q = rings.at(lanes, rnd, s=DEPTH - 1)
            has = rnd < mine
            filled = has & (q[:, C_PRIM] >= 0)
            row0 = c * rec_rows + rnd * n_lanes
            for p in list(open_):
                rays = np.full(n_lanes, p)
                sd, _, _, st, ok = pair_test(q, o[rays], d[rays], m[rays], cull)
                ok &= has
                counted = int(filled.sum())
                if any_hit:
                    hit = np.flatnonzero(ok & (st < bound[p] * sd))
                    if hit.size:
                        if count_upto:
                            counted = int(filled[:hit[0] + 1].sum())
                        win[p], phase[p] = row0 + hit[0], DONE
                        open_.remove(p)
                else:
                    with np.errstate(divide="ignore", invalid="ignore"):
                        tv = st / np.where(ok, sd, F32(1))
                    cand = ok & (tv < bound[p])
                    if cand.any():
                        least = np.flatnonzero(cand & (tv == tv[cand].min()))
                        j = least[0] if tie_break else least[-1]
                        bound[p], win[p] = tv[j], row0 + j
                counts[p, 3] += counted
                warps[w, 1] += counted > 0
        rings.drain(lanes)
        back = peers[phase[peers] != DONE]
        phase[back], g[back] = BOX, g[back] + 1

    while (phase != DONE).any():
        walking = phase != DONE
        in_rows = phase == ROW
        steps[walking & ~(in_rows & together)] += 1
        # Rows: one record row of each row lane.
        r = np.flatnonzero(in_rows) if not together else np.zeros(0, np.int64)
        if r.size:
            q = rings.at(r, k[r])
            filled = q[:, C_PRIM] >= 0
            counts[r, 3] += filled
            cl = s[r] * kt.GROUP + g[r]
            for w in np.unique(warp_of[r[filled]]):
                lanes = warp_of[r] == w
                warps[w, 1] += 1
                warps[w, 2] += np.unique(cl[lanes]).size
                warps[w, 3] += lanes.sum()
            sd, _, _, st, ok = pair_test(q, o[r], d[r], m[r], cull)
            row_id = cl * rec_rows + k[r]
            if any_hit:
                hit = ok & (st < bound[r] * sd)
                rings.drain(r[hit])
                win[r[hit]] = row_id[hit]
                phase[r[hit]] = DONE
                r = r[~hit]
            else:
                tv = st / np.where(ok, sd, F32(1))
                better = ok & (tv < bound[r])
                bound[r[better]] = tv[better]
                win[r[better]] = row_id[better]
            k[r] += 1
            end = r[k[r] == rec_rows]
            phase[end] = BOX
            g[end] += 1
            if restart:
                rings.begin(end, False, s[end], kt.GROUP, g[end])
        # Boxes: step past the loops the last test ended, then one test.
        b_ = walking & ~in_rows
        lanes = b_ & (phase == BOX) & (g == kt.GROUP)
        phase[lanes], s[lanes] = SUPER, s[lanes] + 1
        lanes = b_ & (phase == SUPER) & (s == np.minimum(n_sup, (h + 1) * kt.GROUP2))
        phase[lanes], h[lanes] = HYPER, h[lanes] + 1
        phase[b_ & (phase == HYPER) & (h == n_pages)] = DONE
        test = np.flatnonzero(b_ & (phase != DONE))
        if test.size:
            box = np.zeros((test.size, kt.BND_COLS), F32)
            in_page = phase[test] == BOX
            if in_page.any():
                box[in_page] = rings.at(test[in_page], g[test[in_page]])[:, :BOX_FLOATS]
            hy = phase[test] == HYPER
            box[hy] = hyp[h[test[hy]]]
            su_ = phase[test] == SUPER
            box[su_] = sup[s[test[su_]]]
            counts[test, 2] += 1
            warps[np.unique(warp_of[test]), 0] += 1
            enters = slab_entry(box, o[test], inv[test]) < bound[test]
            t_h, t_s, t_b = test[hy], test[su_], test[in_page]
            e_h, e_s, e_b = enters[hy], enters[su_], enters[in_page]
            phase[t_h[e_h]], s[t_h[e_h]] = SUPER, h[t_h[e_h]] * kt.GROUP2
            h[t_h[~e_h]] += 1
            desc = t_s[e_s]
            counts[desc, 0] += 1
            phase[desc], g[desc] = BOX, 0
            rings.begin(desc, False, s[desc], kt.GROUP, 0)
            s[t_s[~e_s]] += 1
            visit = t_b[e_b]
            counts[visit, 1] += 1
            phase[visit], k[visit] = ROW, 0
            if not together:
                if drain:
                    rings.drain(visit)
                rings.begin(visit, True, s[visit] * kt.GROUP + g[visit], rec_rows, 0)
            g[t_b[~e_b]] += 1
        if not together:
            continue
        # The warps that serve this turn: each lane has posted or ended, or
        # serve_waiting lanes wait.
        for w in range(warps.shape[0]):
            lanes = np.arange(w * LANES, min((w + 1) * LANES, n))
            posted = lanes[phase[lanes] == ROW]
            stepping = (phase[lanes] != DONE) & (phase[lanes] != ROW)
            if not posted.size or (stepping.any() and not 0 < serve_waiting <= posted.size):
                continue
            if drain:
                rings.drain(lanes)
            cl = s[posted] * kt.GROUP + g[posted]
            while posted.size:
                same = cl == cl[0]
                serve(w, lanes, cl[0], posted[same])
                posted, cl = posted[~same], cl[~same]
            if restart:
                box = lanes[phase[lanes] == BOX]
                rings.begin(box, False, s[box], kt.GROUP, g[box])
    if any_hit:
        return win >= 0, counts, steps, warps
    prim = np.where(win >= 0, rec.reshape(-1, rec.shape[2])[np.maximum(win, 0), C_PRIM], -1)
    return (bound, prim.astype(np.int64)), counts, steps, warps


def plain_walk(tables, cull, o, d, lim, any_hit):
    """traverse_clusters[_anyhit] with `visits` on the same rays: (result,
    counters [n, 4])."""
    cols = [torch.from_numpy(a[:, j].astype(F32).copy()) for a in (o, d) for j in range(3)]
    n = o.shape[0]
    vis = torch.zeros((n, kt.WALK_COLS), dtype=torch.int64)
    if any_hit:
        occ = kt.traverse_clusters_anyhit(tables, *cols, torch.from_numpy(lim), cull,
                                          visits=vis)
        return occ.numpy(), vis.numpy()
    miss = torch.full((n,), -1, dtype=torch.int64)
    z = torch.zeros(n)
    t, p, *_ = kt.traverse_clusters(tables, *cols, (torch.from_numpy(lim), miss, z, z, z, miss),
                                    cull, want_normal_mat=False, visits=vis)
    return (t.numpy(), p.numpy()), vis.numpy()


def same_walk(res, counts, want, vis, any_hit):
    """The model's result and counters equal the plain walk's, bit for bit."""
    if not np.array_equal(counts, vis):
        return False
    if any_hit:
        return np.array_equal(res, want)
    return (np.array_equal(res[1], want[1])
            and np.array_equal(res[0].view(np.int32), want[0].view(np.int32)))


# ---------------------------------------------------------------------------
# Scenes and rays.
# ---------------------------------------------------------------------------

_SCENES: dict = {}


def plate_scene():
    """A white box and a plate of 2,048 small triangles between its floor
    and a point light (the card tests' shadowed plate, smaller): the
    shadow rays of floor points stop in the plate, some at the first
    filled row they test."""
    m = 32
    gr = np.linspace(-0.8, 0.8, m + 1)
    xs, zs = np.meshgrid(gr, gr, indexing="ij")
    verts = np.stack([xs.ravel(), np.full(xs.size, 0.2), zs.ravel()], axis=1)
    idx = np.arange((m + 1) * (m + 1)).reshape(m + 1, m + 1)
    a, b, c, e = idx[:-1, :-1], idx[1:, :-1], idx[1:, 1:], idx[:-1, 1:]
    faces = np.concatenate([np.stack([a, b, c], -1).reshape(-1, 3),
                            np.stack([a, c, e], -1).reshape(-1, 3)])
    bld = SceneBuilder()
    white = bld.add_material(diffuse=(0.8, 0.8, 0.8, 1))
    bld.add_triangles(make_box((-1, -1, -1), (1, 1, 1)), white)
    bld.add_triangles(mesh_from_arrays(verts, faces, np.eye(4), cull_backface=False,
                                       smooth=False, as_batch=True), white)
    bld.add_point_light((0.3, 0.8, 0.1), (1.0, 1.0, 1.0, 1.0))
    return bld.build(accel="binned", device=CPU)


def scene_of(name, monkeypatch):
    """mixed56 / mixed128: 400 random triangles, every other culling, at
    56- / 128-row records; dragon_two_pages: 30,000 triangles, two hyper
    pages; plate: plate_scene()."""
    if name not in _SCENES:
        if name.startswith("mixed"):
            monkeypatch.setenv("PTX_KRN_CLUSTER", name.removeprefix("mixed"))
            sc = mixed_cull_scene("port")
            assert sc.krn_records.shape[1] == int(name.removeprefix("mixed"))
        elif name == "dragon_two_pages":
            sc = dragon_scene("port", 30000)
            assert sc.krn_sup_bounds.shape[0] == 2
        else:
            sc = plate_scene()
        assert sc.has_kernel_records
        _SCENES[name] = sc
    return _SCENES[name]


def rays_of(scene, name, any_hit, n=256, seed=21):
    """(o, d, bound): query_rays with t_lim ~ U(0.05, 1.5) for any-hit and
    +inf for nearest; on the plate, the shadow rays of floor points to its
    light, bounded by the distance, for both."""
    if name == "plate":
        rng = np.random.default_rng(seed)
        f = np.stack([rng.uniform(-0.75, 0.75, n), np.full(n, -1.0), rng.uniform(-0.75, 0.75, n)],
                     axis=1)
        to = scene.light_pos[0].numpy().astype(np.float64) - f
        dist = np.linalg.norm(to, axis=1)
        return ((f + 1e-3 * to / dist[:, None]).astype(F32), (to / dist[:, None]).astype(F32),
                (dist - 1e-3).astype(F32))
    o, d = query_rays(n, seed)
    lim = (np.random.default_rng(seed).uniform(0.05, 1.5, n).astype(F32) if any_hit
           else np.full(n, np.inf, F32))
    return o, d, lim


SCENES = ["mixed56", "mixed128", "dragon_two_pages", "plate"]


# ---------------------------------------------------------------------------
# Planted rows: equal t, NaN, occluders in the middle of a round.
# ---------------------------------------------------------------------------


def planted_tables(scene, o, d):
    """The scene's tables with rows planted where the nearest walks of the
    rays (o, d) win: each winning row's test columns copied onto its
    neighbour in the same 32-row round (row ^ 1, a filled row: the same t,
    another prim, so the lowest of the two must win), and the test columns
    of the row two after it set to NaN (a filled row that enters
    nothing). Returns (tables, planted pairs)."""
    tables = kt.kernel_tables(scene)
    rec = tables[0].numpy().copy()
    n_rec, rec_rows = rec.shape[:2]
    lim = np.full(o.shape[0], np.inf, F32)
    (_, prim), _ = plain_walk(tables, scene.krn_cull_mode, o, d, lim, False)
    flat = rec.reshape(-1, rec.shape[2])
    where = {int(p): i for i, p in enumerate(flat[:, C_PRIM]) if p >= 0}
    pairs = 0
    for p in np.unique(prim[prim >= 0]):
        row = where[int(p)]
        c, j = divmod(row, rec_rows)
        twin = j ^ 1
        if twin < rec_rows and rec[c, twin, C_PRIM] >= 0:
            rec[c, twin, :C_PRIM] = rec[c, j, :C_PRIM]
            pairs += 1
        nan = j + 2
        if nan < rec_rows and rec[c, nan, C_PRIM] >= 0 and nan != twin:
            rec[c, nan, :C_PRIM] = np.nan
    return (torch.from_numpy(rec),) + tuple(tables[1:]), pairs


# ---------------------------------------------------------------------------
# The model against the plain walk, ray by ray.
# ---------------------------------------------------------------------------

# A case named "<case>+rounds" runs the warp's rounds (walk_together), the
# others each lane's own rows.
ROUNDS = "+rounds"


def with_rounds(cases):
    return list(cases) + [c + ROUNDS for c in cases]


def split_case(case):
    """(the case without its mode, whether it runs the warp's rounds)."""
    return case.removesuffix(ROUNDS), case.endswith(ROUNDS)


@pytest.mark.parametrize("any_hit", [False, True], ids=["nearest", "any_hit"])
@pytest.mark.parametrize("name", with_rounds(SCENES))
def test_stepped_walk_equals_the_plain_walk(name, any_hit, monkeypatch):
    """Per ray: t and prim (nearest) or the occlusion (any-hit) and all four
    counters equal the plain walk's, the rows of each visited record tested
    by the visiting lane alone or by the warp together; the rays visit
    records, and on the plate some shadow walks stop at the first filled
    row they test."""
    name, together = split_case(name)
    scene = scene_of(name, monkeypatch)
    o, d, lim = rays_of(scene, name, any_hit)
    tables = kt.kernel_tables(scene)
    res, counts, _, _ = walk_model(tables, scene.krn_cull_mode, o, d, lim, any_hit,
                                   together=together)
    want, vis = plain_walk(tables, scene.krn_cull_mode, o, d, lim, any_hit)
    np.testing.assert_array_equal(counts, vis)
    if any_hit:
        np.testing.assert_array_equal(res, want)
        assert 0 < int(res.sum()) < o.shape[0] or name == "plate"
    else:
        np.testing.assert_array_equal(res[1], want[1])
        np.testing.assert_array_equal(res[0].view(np.int32), want[0].view(np.int32))
        assert int((res[1] >= 0).sum()) > 20
    assert int((counts[:, 1] > 0).sum()) > 20
    if name == "plate" and any_hit:
        assert int((res & (counts[:, 3] == 1)).sum()) > 0


@pytest.mark.parametrize("any_hit", [False, True], ids=["nearest", "any_hit"])
@pytest.mark.parametrize("name", ["mixed56", "mixed128"])
def test_rounds_keep_ties_nan_rows_and_the_first_occluder(name, any_hit, monkeypatch):
    """On tables with rows planted at equal t and NaN rows (planted_tables),
    the warp's rounds give the plain walk's results and counters ray by ray
    (the lowest of two equal rows wins, a NaN row never does); the planted
    twins decide some rays' winners; and on the plate, shadow walks stop
    at occluders in the middle of a round, with filled rows after them in
    it that the round does not count."""
    scene = scene_of(name, monkeypatch)
    o, d, lim = rays_of(scene, name, any_hit)
    tables, pairs = planted_tables(scene, o, d)
    assert pairs > 10
    res, counts, _, _ = walk_model(tables, scene.krn_cull_mode, o, d, lim, any_hit,
                                   together=True)
    want, vis = plain_walk(tables, scene.krn_cull_mode, o, d, lim, any_hit)
    assert same_walk(res, counts, want, vis, any_hit)
    if not any_hit:
        before, _ = plain_walk(kt.kernel_tables(scene), scene.krn_cull_mode, o, d, lim, False)
        assert int((before[1] != want[1]).sum()) > 5  # the lower twin took over
    plate = scene_of("plate", monkeypatch)
    o, d, lim = rays_of(plate, "plate", True)
    tables = kt.kernel_tables(plate)
    res, counts, _, _ = walk_model(tables, plate.krn_cull_mode, o, d, lim, True, together=True)
    want, vis = plain_walk(tables, plate.krn_cull_mode, o, d, lim, True)
    assert same_walk(res, counts, want, vis, True)
    whole, wc, _, _ = walk_model(tables, plate.krn_cull_mode, o, d, lim, True, together=True,
                                 count_upto=False)
    assert int((wc[:, 3] > counts[:, 3]).sum()) > 10  # occluders before a round's last row


@pytest.mark.parametrize("fault", ["no_tie_break", "whole_round"])
@pytest.mark.parametrize("name", ["mixed56", "mixed128"])
def test_rounds_without_the_row_tie_break_or_counting_the_whole_round_fail(name, fault,
                                                                           monkeypatch):
    """A round reduced to its least t without the row tie-break (the last
    lane of equal t wins) on the planted tables, or an any-hit round that
    counts its filled rows past the occluder, disagrees with the plain
    walk: the test above would catch either in the kernels' rounds."""
    scene = scene_of(name, monkeypatch)
    any_hit = fault == "whole_round"
    if any_hit:
        scene, name = scene_of("plate", monkeypatch), "plate"
    o, d, lim = rays_of(scene, name, any_hit)
    tables = planted_tables(scene, o, d)[0] if not any_hit else kt.kernel_tables(scene)
    res, counts, _, _ = walk_model(tables, scene.krn_cull_mode, o, d, lim, any_hit,
                                   together=True, tie_break=fault != "no_tie_break",
                                   count_upto=fault != "whole_round")
    want, vis = plain_walk(tables, scene.krn_cull_mode, o, d, lim, any_hit)
    assert not same_walk(res, counts, want, vis, any_hit)


@pytest.mark.parametrize("broken", with_rounds(["no_restart", "no_drain"]))
@pytest.mark.parametrize("any_hit", [False, True], ids=["nearest", "any_hit"])
def test_a_broken_ring_protocol_fails(broken, any_hit, monkeypatch):
    """A model that does not restart the page's box stream after a visited
    or served cluster (its next box comes from the rows' slots), or that
    begins a visit's or a serve's rows with the page's boxes still in
    flight, disagrees with the plain walk: the test above would catch
    either in the kernels' walk."""
    broken, together = split_case(broken)
    scene = scene_of("dragon_two_pages", monkeypatch)
    o, d, lim = rays_of(scene, "dragon_two_pages", any_hit)
    tables = kt.kernel_tables(scene)
    res, counts, _, _ = walk_model(tables, scene.krn_cull_mode, o, d, lim, any_hit,
                                   restart=broken != "no_restart", drain=broken != "no_drain",
                                   together=together)
    want, vis = plain_walk(tables, scene.krn_cull_mode, o, d, lim, any_hit)
    assert not same_walk(res, counts, want, vis, any_hit)


# ---------------------------------------------------------------------------
# The warps' steps.
# ---------------------------------------------------------------------------


def geo_visits(counts, any_hit):
    """The model's per-ray counters [n, 4] as K1 / K2 counters [n, 9], in
    the nearest or the shadow columns."""
    v = np.zeros((counts.shape[0], kt.GEO_VISIT_COLS), np.int64)
    v[:, kt.SHADOW_COLS if any_hit else kt.NEAR_COLS] = counts
    return torch.from_numpy(v)


@pytest.mark.parametrize("any_hit", [False, True], ids=["nearest", "any_hit"])
@pytest.mark.parametrize("name", with_rounds(["mixed56", "dragon_two_pages", "plate"]))
def test_lockstep_steps_between_the_largest_lane_and_the_sum(name, any_hit, monkeypatch):
    """Per warp of the lockstep schedule: its slab steps and filled-row
    steps at most the sum of its lanes' tests (the lanes that test together
    share a step), and at least the largest lane's tests (a served round
    tests up to 32 rows of one lane in a step: at least the warp's rows
    over 32), the bounds the counting instances' warp steps keep however
    the card schedules the lanes; the counts lie within warp_utilisation's
    bounds, for K4's counting form (alone: each lane's turns its steps) or
    K1's and K2's (together: record streams at most the record visits, and
    no more row steps than the lanes testing rows alone take)."""
    name, together = split_case(name)
    scene = scene_of(name, monkeypatch)
    o, d, lim = rays_of(scene, name, any_hit, n=320)
    tables = kt.kernel_tables(scene)
    _, counts, steps, warps = walk_model(tables, scene.krn_cull_mode, o, d, lim, any_hit,
                                         together=together)
    per_lane = counts.reshape(-1, LANES, 4)
    for col, work in ((0, per_lane[:, :, 2]), (1, per_lane[:, :, 3])):
        if not together or col == 0:
            assert (warps[:, col] >= work.max(1)).all()
        else:
            assert (LANES * warps[:, col] >= work.sum(1)).all()
        assert (warps[:, col] <= work.sum(1)).all()
    # Lanes share steps: fewer steps than tests wherever a warp has work.
    assert warps[:, 1].sum() < counts[:, 3].sum()
    if not together:
        tests = counts[:, 2] + counts[:, 3]
        assert (steps >= tests).all()  # a row step on a padding row is no filled row
        u = kt.warp_utilisation(torch.from_numpy(counts), torch.from_numpy(warps.sum(0)))
        assert u["row_steps"] > 0
        return
    visited = per_lane[:, :, 1].sum(1)
    assert (warps[:, 2] <= visited).all() and (visited <= LANES * warps[:, 2]).all()
    u = kt.warp_utilisation(geo_visits(counts, any_hit), torch.from_numpy(warps[:, :3].sum(0)))
    assert u["row_steps"] > 0 and u["visits_per_stream"] >= 1
    _, _, _, alone = walk_model(tables, scene.krn_cull_mode, o, d, lim, any_hit)
    assert warps[:, 1].sum() <= alone[:, 1].sum()


@pytest.mark.parametrize("serve_waiting", [0, 8])
def test_serving_at_other_moments_keeps_the_results(serve_waiting, monkeypatch):
    """The stepping sweep's other moments to serve (once no lane can take
    a box step, or once 8 lanes wait) give the plain walk's results and
    counters too: only the warps' steps depend on when the warp serves."""
    scene = scene_of("dragon_two_pages", monkeypatch)
    for any_hit in (False, True):
        o, d, lim = rays_of(scene, "dragon_two_pages", any_hit)
        tables = kt.kernel_tables(scene)
        res, counts, _, _ = walk_model(tables, scene.krn_cull_mode, o, d, lim, any_hit,
                                       together=True, serve_waiting=serve_waiting)
        want, vis = plain_walk(tables, scene.krn_cull_mode, o, d, lim, any_hit)
        assert same_walk(res, counts, want, vis, any_hit)


# ---------------------------------------------------------------------------
# The stepping sweep's rewrite of the walk.
# ---------------------------------------------------------------------------


def test_the_shipped_source_is_a_stepping_value():
    """The shipped cluster_traverse.cuh is the sweep's SHIPPED value: both
    walks together, served at the first post."""
    from cpupathtrace_tpu_torch.experiments import walk_stepping as ws

    text = (ws._build.CSRC / "cluster_traverse.cuh").read_text()
    for shipped, _ in ws.WALKS.values():
        assert text.count(shipped) == 1
    assert (shipped_serve_waiting(), True, True) == ws.STEPPINGS[ws.SHIPPED]


STEPPING_NAMES = ["alone", "all", "first", "w2", "w4", "w8", "w16", "near_only"]


@pytest.mark.parametrize("step", STEPPING_NAMES, ids=[str(i) for i in range(len(STEPPING_NAMES))])
def test_the_stepping_sweep_rewrites_the_shipped_loops(step, tmp_path):
    """experiments/walk_stepping.py's copy of csrc/ serves when `step`'s
    kServeWaiting says, tests the rows of the walks it names together (the
    nearest walk from h.t, the shadow walks from t_lim) and steps the
    others alone: each lane tests its own records' rows."""
    from cpupathtrace_tpu_torch.experiments import walk_stepping as ws

    serve, *together = ws.STEPPINGS[step]
    text = (ws.stepping_csrc(tmp_path / "csrc", step) / "cluster_traverse.cuh").read_text()
    for (shipped, alone), keep in zip(ws.WALKS.values(), together):
        assert text.count(shipped) == int(keep)
        assert text.count(alone) == int(not keep)
    assert ws.SERVE.findall(text) == [str(serve)]
