"""The host side of K4 (the standalone cluster query on refilling persistent
warps, csrc/cluster_query.cu) and K7 (the binned wavefront's
cluster-major intersect, csrc/binned_isect.cu), in what the CPU can check:
K4's resident grid, its block's shared memory (staged tiers, then its own
cp.async rings) and the 227 KB limit, a plain model of its warps' claims,
the bounds of its warp-step counters; K7's work list and the last filled
8-row group of each cluster, against numpy constructions, and its plain
version against the JAX kernel `_isect_call` in interpret mode where rows
meet a ray at equal t. The kernels themselves run on the card
(tests/test_torch_cuda.py, chip_smoke.py).
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cpupathtrace_tpu.accel import pallas_traverse as jpt
from cpupathtrace_tpu_torch.accel import kernel_traverse as kt
from cpupathtrace_tpu_torch.accel import traverse as tt
from cpupathtrace_tpu_torch.models import scenes
from tests.torch_util import CPU

H100_SMS = 132
LANES = 32
# K4's layout as csrc/cluster_query.cu builds it (ptx_walk_layout: 128
# threads, 2 slots of 80 bytes, 64 KB of tiers); tests/test_torch_cuda.py
# holds the built library to it.
K4_BUILT = kt.WalkLayout(threads=128, depth=2, slot_bytes=80, tier_floats=16384)


# ---------------------------------------------------------------------------
# K4: the block's shared memory and the grid.
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def dragon():
    return scenes.bench_dragon_scene(dragon_tris=200000, lean=True, device=CPU)


def test_query_block_on_the_200k_dragon(dragon):
    """The 200k dragon's tiers are staged (9 pages, 4,896 bytes) and its
    block's rings follow them at a 16-byte boundary: 25,376 bytes."""
    pages = dragon.krn_sup_bounds.shape[0]
    tiers = kt.tier_floats(pages, K4_BUILT)
    assert pages == 9 and tiers == 9 * (kt.BND_COLS + kt.GROUP2 * kt.BND_COLS)
    ring = kt.walk_smem_bytes(K4_BUILT)
    assert ring == 2 * 80 * 128
    assert kt.kernel_smem_bytes(0, pages, K4_BUILT) == -(-tiers // 4) * 16 + ring == 25376


@pytest.mark.parametrize("threads,depth,fits", [
    (64, 2, True), (64, 6, True), (128, 4, True), (256, 6, True), (256, 12, False),
    (512, 6, False),
])
def test_query_rings_against_the_limit(threads, depth, fits):
    """The sweep's configurations (depth 2-6, 64 / 128 / 256 threads) fit
    227 KB beside the largest staged tiers; past it the size raises
    instead of launching."""
    layout = K4_BUILT._replace(threads=threads, depth=depth)
    tiers_max = layout.tier_floats // (kt.BND_COLS + kt.GROUP2 * kt.BND_COLS)
    if fits:
        assert kt.kernel_smem_bytes(0, tiers_max, layout) <= kt.SMEM_LIMIT
    else:
        with pytest.raises(ValueError, match="shared memory"):
            kt.kernel_smem_bytes(0, 0, layout)


@pytest.mark.parametrize("n,grid", [
    (1, 1), (31, 1), (129, 2),  # at most one thread per ray
    (65536, 512),  # phase 7's rays: one wave of 8 blocks of 128 a SM holds them
    (262144, H100_SMS * 8),  # the frame's camera rays: the resident blocks
])
def test_query_grid_is_the_resident_blocks(n, grid):
    assert kt.resident_grid(n, 128, 8, H100_SMS) == grid


# ---------------------------------------------------------------------------
# K4's refilling warps, as a plain model of the kernel's loop
# (csrc/cluster_query.cu): each turn of a warp, the lanes without a ray
# (while the counter may still hold rays) take consecutive indices by one
# atomicAdd, in lane order, and a ray may end at once, on the root gate;
# then every lane with a ray runs one test of its walk, and the walk may
# end, freeing the lane. The warp stops when no lane holds a ray and the
# counter is spent (a claim whose rays all end at the root gate does not
# stop it).
# ---------------------------------------------------------------------------


def query_claims(n, warps, seed, gate_p):
    """Every ray index the lanes finish, in order, and the counter's final
    value; warps take turns, a share `gate_p` of the rays end at the root
    gate and the other walks end in a seeded order."""
    rng = np.random.default_rng(seed)
    counter = 0
    rays = np.full((warps, LANES), -1, dtype=np.int64)
    left = np.zeros((warps, LANES), dtype=np.int64)  # tests left in the walk
    more = np.ones(warps, dtype=bool)
    running = list(range(warps))
    done = []
    while running:
        w = running[rng.integers(len(running))]
        free = np.flatnonzero(rays[w] < 0)
        if more[w] and free.size:
            first = counter
            counter += free.size  # the leader's atomicAdd of popc(want)
            j = first + np.arange(free.size)
            got = j < n
            rays[w, free[got]] = j[got]
            left[w, free[got]] = rng.integers(0, 40, int(got.sum()))
            more[w] = first + free.size < n
            gated = free[got][rng.random(int(got.sum())) < gate_p]  # end at the root gate
            done.extend(rays[w, gated].tolist())
            rays[w, gated] = -1
        busy = rays[w] >= 0
        if not busy.any():
            if not more[w]:
                running.remove(w)
            continue
        ends = busy & (left[w] == 0)
        done.extend(rays[w, ends].tolist())
        rays[w, ends] = -1
        left[w, busy & ~ends] -= 1
    return done, counter


@pytest.mark.parametrize("gate_p", [0.0, 0.5, 1.0])
@pytest.mark.parametrize("warps", [132 * 16, 33])
@pytest.mark.parametrize("n", [1, 31, 32 * 33 * 5 + 17, 65536])
def test_query_claims_run_every_ray_exactly_once(n, warps, gate_p):
    """Below, at and past one resident wave, ragged, with no ray, half of
    them or all of them ending at the root gate (as the camera rays of a
    wavefront frame do behind the box's front wall): every index in [0, n)
    is run to its end once, nothing past n, and the counter overshoots by
    less than one claim per warp."""
    done, counter = query_claims(n, warps, 0, gate_p)
    assert sorted(done) == list(range(n))
    assert n <= counter < n + LANES * warps


# ---------------------------------------------------------------------------
# K4's warp steps.
# ---------------------------------------------------------------------------


def _k4_visits(slabs, rows):
    v = torch.zeros((3, kt.WALK_COLS), dtype=torch.int32)
    v[0, 2], v[2, 2] = slabs - slabs // 3, slabs // 3
    v[1, 3], v[2, 3] = rows - rows // 4, rows // 4
    v[:, 0] = 5  # descends and visits do not enter
    return v


@pytest.mark.parametrize("slabs,rows,steps,clusters_per_step", [
    (3200, 640, (100, 20, 20, 640), 1.0),  # one cluster for 32 busy lanes: a packet
    (3200, 640, (100, 20, 640, 640), 32.0),  # every lane its own cluster
    (120, 40, (100, 40, 40, 40), 1.0),  # one lane a step
])
def test_query_warp_steps_accepted(slabs, rows, steps, clusters_per_step):
    u = kt.warp_utilisation(_k4_visits(slabs, rows), torch.tensor(steps))
    assert u["row_steps"] == steps[1] and u["row_tests"] == rows
    assert u["clusters_per_row_step"] == clusters_per_step
    assert u["active_lanes_per_row_step"] == steps[3] / steps[1]


@pytest.mark.parametrize("steps", [
    (100, 20, 19, 640),  # fewer clusters than steps
    (100, 20, 641, 640),  # more clusters than active lanes
    (100, 20, 20, 641),  # more active lanes than 32 a step
    (100, 20, 20, 600),  # fewer active lanes than filled rows tested
    (100, 20, 20),  # K1 / K2's two columns and one more
])
def test_query_warp_steps_rejected(steps):
    with pytest.raises(ValueError):
        kt.warp_utilisation(_k4_visits(3200, 640), torch.tensor(steps))


def test_query_warp_steps_are_counted_on_the_card_only(dragon):
    o = torch.zeros((4, 3))
    d = torch.tensor([[0.0, 0.0, 1.0]] * 4)
    steps = torch.zeros(kt.QUERY_STEP_COLS, dtype=torch.int64)
    with pytest.raises(ValueError):
        kt.cluster_intersect(dragon, o, d, debug_visits=True, warp_steps=steps)
    with pytest.raises(ValueError):
        kt.cluster_intersect(dragon, o, d, warp_steps=steps)


# ---------------------------------------------------------------------------
# K7: the last filled group and the work list.
# ---------------------------------------------------------------------------


def _blocks(prim, seed=0):
    """Cluster blocks [C, L, 16] with the given prim column (-1: padding)
    and seeded small triangles."""
    rng = np.random.default_rng(seed)
    c, l = prim.shape
    v0 = rng.uniform(-1, 1, (c, l, 3))
    v1 = v0 + rng.normal(scale=0.3, size=(c, l, 3))
    v2 = v0 + rng.normal(scale=0.3, size=(c, l, 3))
    return torch.tensor(tt.pack_blocks(v0, v1, v2, rng.random((c, l)) < 0.5, prim))


def _padded_prims(c=6, l=48):
    """Prims with padding groups in the middle and at the tail, a padding
    row inside a filled group, an empty cluster and a full one."""
    prim = np.arange(c * l).reshape(c, l)
    prim[0, 16:32] = -1  # two padding groups in the middle
    prim[0, 40:] = -1  # and one at the tail
    prim[1, 3] = -1  # one padding row in a filled group
    prim[2] = -1  # no filled row
    prim[3, 9:] = -1  # a tail starting inside group 1
    prim[4, 47] = -1  # the last row alone
    return prim


def test_last_filled_groups_against_numpy():
    prim = _padded_prims()
    c, l = prim.shape
    want = [max([g + 1 for g in range(l // 8) if (prim[k, 8 * g:8 * g + 8] >= 0).any()],
                default=0) for k in range(c)]
    got = tt.last_filled_groups(_blocks(prim))
    assert got.dtype == torch.int32 and got.tolist() == want == [5, 6, 0, 2, 6, 6]


def test_filled_groups_is_kept_while_the_blocks_are_unchanged():
    blocks = _blocks(_padded_prims())
    first = tt.filled_groups(blocks)
    assert tt.filled_groups(blocks) is first
    blocks[2, 0, tt.C_PRIM] = 7.0  # a filled row in the empty cluster
    again = tt.filled_groups(blocks)
    assert again is not first and again.tolist()[2] == 1


@pytest.mark.parametrize("counts", [
    [0, 300, 1, 0, 257, 128, 127, 129, 0],  # empty clusters, ragged counts
    [5], [0, 0, 1000], [128] * 7,
])
def test_work_items_against_numpy(counts):
    """chunk_start is the cumulative count of ITEM_PAIRS chunks per
    cluster, the grid bound holds every item, and the kernel's map from
    (item, thread) to pair covers every pair of each cluster once."""
    offs = np.concatenate([[0], np.cumsum(counts)]).astype(np.int32)
    start, n_items = tt.work_items(torch.tensor(offs), int(offs[-1]))
    chunks = [-(-n // tt.ITEM_PAIRS) for n in counts]
    assert start.dtype == torch.int32
    assert start.tolist() == np.concatenate([[0], np.cumsum(chunks)]).tolist()
    assert n_items >= start[-1]
    covered = []
    for item in range(n_items):
        if item >= start[-1]:
            continue  # the kernel's blocks past the last item return
        c = int(np.searchsorted(start.numpy(), item, side="right") - 1)
        first = offs[c] + (item - int(start[c])) * tt.ITEM_PAIRS
        covered += [first + k for k in range(tt.ITEM_PAIRS) if first + k < offs[c + 1]]
    assert sorted(covered) == list(range(offs[-1]))


def test_isect_plain_skips_nothing_that_can_win():
    """The plain version over every row equals it over the rows up to each
    cluster's last filled group (what the kernel tests), on rays that hit
    rows of every filled group."""
    prim = _padded_prims()
    blocks = _blocks(prim, seed=3)
    rng = np.random.default_rng(5)
    n = 600
    o = rng.uniform(-1, 1, (n, 3))
    d = rng.normal(size=(n, 3))
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    rays = torch.tensor(np.ascontiguousarray(np.concatenate([o.T, d.T])), dtype=torch.float32)
    offs = torch.tensor([0, 100, 200, 300, 400, 500, 600], dtype=torch.int32)
    t, p = tt.isect(blocks, rays, offs)
    cut = tt.last_filled_groups(blocks) * tt.GROUP_ROWS
    for k in range(blocks.shape[0]):
        sl = slice(int(offs[k]), int(offs[k + 1]))
        if int(cut[k]) == 0:
            assert (p[sl] == -1).all() and torch.isinf(t[sl]).all()
            continue
        tk, pk = tt.nearest_in_rows(blocks[k:k + 1, :int(cut[k])].expand(100, -1, -1),
                                    rays[0:3, sl].t(), rays[3:6, sl].t())
        assert torch.equal(pk.to(torch.int32), p[sl]) and torch.equal(tk, t[sl])
    assert int((p >= 0).sum()) > 50


# ---------------------------------------------------------------------------
# K7's plain version against the JAX kernel on equal-t rows.
# ---------------------------------------------------------------------------


def _tie_case():
    """Two clusters of 64 rows. Cluster 0: one triangle copied to rows 3
    and 5 (prims 50, 40: one group) and to row 17 (prim 30: a later
    group), a padding group in the middle; cluster 1: the same triangle in
    rows 9 (prim 70) and 60 (prim 60), its tail padding. Every other row is
    a triangle off the rays' path. 40 and 37 rays down through them."""
    c, l = 2, 64
    v0 = np.tile([[5.0, 5.0, 5.0]], (c, l, 1))
    v1 = v0 + [0.1, 0.0, 0.0]
    v2 = v0 + [0.0, 0.1, 0.0]
    prim = np.arange(100, 100 + c * l).reshape(c, l)
    prim[0, 24:32] = -1
    prim[1, 61:] = -1
    for k, row, pr in ((0, 3, 50), (0, 5, 40), (0, 17, 30), (1, 9, 70), (1, 60, 60)):
        v0[k, row], v1[k, row], v2[k, row] = [-1, -1, 0], [3, -1, 0], [-1, 3, 0]
        prim[k, row] = pr
    cull = np.zeros((c, l), bool)
    rng = np.random.default_rng(4)
    counts = np.array([40, 37])
    o = np.concatenate([rng.uniform(-0.5, 0.5, (counts.sum(), 2)),
                        rng.uniform(0.5, 2.0, (counts.sum(), 1))], 1)
    d = np.tile([[0.0, 0.0, -1.0]], (counts.sum(), 1))
    pairs = np.ascontiguousarray(np.concatenate([o.T, d.T]), dtype=np.float32)
    return (v0, v1, v2, cull, prim), pairs, counts


def _jax_isect(comp, pairs, counts):
    """JAX `_isect_call` (interpret mode) on the pairs, from its 128-aligned
    layout, as tests/torch_util.py jax_isect_pairs lays them out."""
    c = counts.shape[0]
    aligned = -(-counts // 128) * 128
    offs_al = np.concatenate([[0], np.cumsum(aligned)[:-1]]).astype(np.int32)
    rays_t = np.zeros((8, int(aligned.sum()) + jpt._GROUP), np.float32)
    rays_t[5] = 1.0
    pos = np.concatenate([offs_al[k] + np.arange(counts[k]) for k in range(c)])
    rays_t[:6, pos] = pairs
    blocks = jpt.pack_blocks_np(*comp)
    t, p = jpt._isect_call(jnp.asarray(offs_al), jnp.asarray(counts.astype(np.int32)),
                           jnp.asarray(blocks), jnp.asarray(rays_t), n_tiles=blocks.shape[1],
                           interpret=True)
    return np.asarray(t)[0, pos], np.asarray(p)[0, pos]


def test_isect_ties_match_the_jax_kernel():
    """Within a group the smallest prim among the rows at the group's
    minimum t (40 of 50 and 40; 60 of 70 and 60 in cluster 1 lies in a
    later group, so 70 stays), a later group at the same t never wins (30
    loses to 40): the plain version's prim equals the JAX kernel's on
    every pair, t to a few ulp (XLA:CPU fuses the sums; rtol 1e-5, as
    tests/test_torch_binned_wavefront.py)."""
    comp, pairs, counts = _tie_case()
    ref_t, ref_p = _jax_isect(comp, pairs, counts)
    offs = torch.tensor(np.concatenate([[0], np.cumsum(counts)]), dtype=torch.int32)
    t, p = tt.isect(torch.tensor(tt.pack_blocks(*comp)), torch.tensor(pairs), offs)
    np.testing.assert_array_equal(p.numpy(), ref_p)
    assert p[:40].tolist() == [40] * 40 and p[40:].tolist() == [70] * 37
    np.testing.assert_allclose(t.numpy(), ref_t, rtol=1e-5, atol=0)
