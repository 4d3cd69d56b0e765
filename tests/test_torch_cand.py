"""K6's split scan (csrc/binned_cand.cu) as a plain model, held bit-equal to
the plain version `candidates_reference` and to the JAX kernel, and the
K6 / K5 wrappers' checks that need no card.

The kernel splits each ray's cluster scan over a group of lanes (lane j
scans the clusters c = j mod group) and merges the lanes' sorted (M+1)-slot
lists in log2(group) shuffle rounds; the wrapper gives a launch 1-32
lanes a ray and a window of few pending rays widens its groups up to a
warp, so every group size 1-32 can run.
`traverse.split_scan_model` does the same on the CPU with the kernel's
merge (`merge_select`: slot k the least of the pairwise maxima). Cluster
ids are distinct, so the (entry, id) order is total and the merged lists
are the serial scan's bit for bit; the broken merges below (an overflow
slot left out of the merge, entry ties broken by lane) must not reproduce
it.

The JAX kernel's outputs are the committed fixture
tests/fixtures/torch_binned.npz (make_torch_binned_fixtures.py): the rays
inside the dragon's region tie at entry 0, and round 2 carries a nonzero
lower bound.
"""
import os

import numpy as np
import pytest
import torch

from cpupathtrace_tpu_torch.accel import traverse as tt
from cpupathtrace_tpu_torch.ops import intersect as oi
from tests.torch_util import CPU, binned_dragon

FIXTURE = os.path.join(os.path.dirname(__file__), "fixtures", "torch_binned.npz")
GROUPS = [1, 2, 4, 8, 16, 32]
H100_SMS = 132


@pytest.fixture(scope="module")
def fixture():
    with np.load(FIXTURE) as f:
        return {k: f[k] for k in f.files if k.startswith("cand_")}


@pytest.fixture(scope="module")
def dragon():
    return binned_dragon("port")


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def _same(a, b):
    """(ids, entries) pairs equal: ids exactly, entries bit for bit."""
    return torch.equal(a[0], b[0]) and a[1].numpy().tobytes() == b[1].numpy().tobytes()


def seeded_case(c: int, n: int, m: int, seed: int):
    """A bounds table of `c` overlapping boxes in [-1, 1]^3 (every 9th
    invalid) and two rounds of K6 rays: half the origins inside the boxes'
    region (entries tie at 0), half outside; a fifth of the best hits
    infinite. Round 2's bound is round 1's last valid slot (a third of the
    rays not pending). Returns (bounds, round-1 rays, round-2 rays)."""
    rng = np.random.default_rng(seed)
    lo = rng.uniform(-1, 0.6, (c, 3))
    b = np.zeros((c, 8), np.float32)
    b[:, :3] = lo
    b[:, 3:6] = lo + rng.uniform(0.1, 0.9, (c, 3))
    b[:, 6] = np.arange(c) % 9 != 8
    o = rng.uniform(-0.5, 0.5, (n, 3))
    o[n // 2:] = rng.uniform(-3, 3, (n - n // 2, 3))
    d = rng.normal(size=(n, 3))
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    d[rng.random(n) < 0.05, rng.integers(0, 3)] = 0.0  # axis-parallel rays
    best = rng.uniform(0.5, 5.0, n)
    best[rng.random(n) < 0.2] = np.inf
    ninf = np.full(n, -np.inf)
    bounds = _t(b)
    rays1 = _t(np.stack([*o.T, *d.T, best, ninf, ninf]).astype(np.float32))
    ids, ent = tt.candidates_reference(bounds, rays1, m)
    valid = ids[:m] >= 0
    last = valid.sum(0).clamp_min(1) - 1
    rays2 = rays1.clone()
    rays2[7] = torch.where(valid[0], ent.gather(0, last[None])[0], float("inf"))
    rays2[8] = torch.where(valid[0], ids.gather(0, last[None])[0].float(), float("inf"))
    rays2[7, ::3] = float("inf")
    return bounds, rays1, rays2


# ---------------------------------------------------------------------------
# The split scan and merge against the serial scan.
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("group", GROUPS)
@pytest.mark.parametrize("rnd", ["round1", "round2"])
@pytest.mark.parametrize("where", ["outside", "inside"])
@pytest.mark.parametrize("m", [1, 4])
def test_split_scan_matches_the_jax_kernel(fixture, dragon, m, where, rnd, group):
    """On the JAX kernel's 8 fixture cases (32 clusters: a group of 32
    lanes scans one cluster a lane), the model at every group size equals
    the JAX kernel's ids, and its entries bit for bit; so does the plain
    version."""
    name = f"cand_{m}_{where}_{rnd}"
    rays = _t(fixture[f"{name}_rays"])
    got = tt.split_scan_model(dragon.trv_bounds, rays, m, group)
    ref_ids, ref_ent = fixture[f"{name}_ids"][: m + 1], fixture[f"{name}_ent"][: m + 1]
    np.testing.assert_array_equal(got[0].numpy(), ref_ids)
    assert got[1].numpy().tobytes() == ref_ent.tobytes()
    assert _same(got, tt.candidates_reference(dragon.trv_bounds, rays, m))
    assert (got[0][0] >= 0).sum() > 10


@pytest.mark.parametrize("group", GROUPS)
@pytest.mark.parametrize("c", [37, 100])
@pytest.mark.parametrize("m", [1, 4, 7])
def test_split_scan_matches_the_plain_version_on_seeded_inputs(m, c, group):
    """Seeded tables of 37 and 100 clusters (not a multiple of most group
    sizes: lanes scan one cluster more or fewer), both rounds: the model
    with the kernel's merge equals `candidates_reference` bit for bit, with
    entry ties at 0, a non-empty overflow row on some rays and rays that
    are not pending."""
    bounds, rays1, rays2 = seeded_case(c, 600, m, seed=c + m)
    ref1 = tt.candidates_reference(bounds, rays1, m)
    for rays, ref in ((rays1, ref1), (rays2, tt.candidates_reference(bounds, rays2, m))):
        assert _same(tt.split_scan_model(bounds, rays, m, group), ref)
    ids1, ent1 = ref1
    assert (ids1[m] >= 0).any(), "no ray fills its overflow row"
    assert ((ent1[:m] == 0) & (ids1[:m] >= 0)).sum() > 1, "no entry ties at 0"
    assert (rays2[7] == float("inf")).any()


def _merge_m_slots(e, cid, pe, pc, m):
    """Broken: the lists' m kept slots merged by insertion (what falls out
    dropped), the overflow slot the lesser of the two lists' own."""
    e, cid = list(e), list(cid)
    for k in range(m):
        ce, ci = pe[k], pc[k]
        for j in range(m):
            less = (ce < e[j]) | ((ce == e[j]) & (ci < cid[j]))
            e[j], ce = torch.where(less, ce, e[j]), torch.where(less, e[j], ce)
            cid[j], ci = torch.where(less, ci, cid[j]), torch.where(less, cid[j], ci)
    less = (pe[m] < e[m]) | ((pe[m] == e[m]) & (pc[m] < cid[m]))
    e[m], cid[m] = torch.where(less, pe[m], e[m]), torch.where(less, pc[m], cid[m])
    return e, cid


def _merge_ties_by_lane(group):
    """Broken: equal entries ordered by the lane that scanned them (id mod
    group), not by id; both partners agree, so the lists stay equal."""
    def lane(x):
        return torch.where(torch.isinf(x), x, torch.remainder(x, group))

    def merge(e, cid, pe, pc, m):
        oe, oc = list(e), list(cid)
        for k in range(m + 1):
            ce, ci = pe[k], pc[k]
            for j in range(m):
                less = (ce < oe[j]) | ((ce == oe[j]) & ((lane(ci) < lane(oc[j])) | (
                    (lane(ci) == lane(oc[j])) & (ci < oc[j]))))
                oe[j], ce = torch.where(less, ce, oe[j]), torch.where(less, oe[j], ce)
                oc[j], ci = torch.where(less, ci, oc[j]), torch.where(less, oc[j], ci)
            less = (ce < oe[m]) | ((ce == oe[m]) & (lane(ci) < lane(oc[m])))
            oe[m], oc[m] = torch.where(less, ce, oe[m]), torch.where(less, ci, oc[m])
        return oe, oc

    return merge


def _reproduces(bounds, rays, m, group, merge):
    ref = tt.candidates_reference(bounds, rays, m)
    try:
        return _same(tt.split_scan_model(bounds, rays, m, group, merge), ref)
    except RuntimeError:  # the lanes ended with different lists
        return False


@pytest.mark.parametrize("group", [2, 4, 8])
def test_broken_merges_do_not_reproduce_the_serial_scan(fixture, dragon, group):
    """The checks above fail on a merge that carries only the m kept slots
    (the overflow slot the lesser of the two lists' own) and on one that
    orders equal entries by lane: each differs from the plain version on
    the fixture's ties at 0 or the seeded overflow rows."""
    inside = _t(fixture["cand_4_inside_round1_rays"])
    assert not _reproduces(dragon.trv_bounds, inside, 4, group, _merge_ties_by_lane(group))
    bounds, rays1, _ = seeded_case(37, 600, 4, seed=41)
    assert not _reproduces(bounds, rays1, 4, group, _merge_m_slots)
    # The kernel's merge does reproduce it on the same inputs.
    assert _reproduces(dragon.trv_bounds, inside, 4, group, tt.merge_select)
    assert _reproduces(bounds, rays1, 4, group, tt.merge_select)


def test_split_scan_model_takes_powers_of_two():
    bounds, rays1, _ = seeded_case(37, 8, 1, seed=1)
    with pytest.raises(ValueError, match="power of two"):
        tt.split_scan_model(bounds, rays1, 1, 3)


# ---------------------------------------------------------------------------
# The wrappers' checks.
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("m", [0, 8, -1])
def test_candidates_refuses_m_outside_one_to_seven(m):
    bounds, rays1, _ = seeded_case(37, 8, 1, seed=2)
    with pytest.raises(ValueError, match=f"m = {m}"):
        tt.candidates(bounds, rays1, m)


@pytest.mark.parametrize("c", [0, tt.MAX_CLUSTERS + 1])
def test_candidates_refuses_a_bounds_table_it_cannot_hold(c):
    """K6 stages the bounds (32 bytes a cluster) in one block's shared
    memory: past MAX_CLUSTERS (or with none) the wrapper raises on either
    device, before the plain version or the kernel runs."""
    calls = tt.candidates_reference.calls
    with pytest.raises(ValueError, match="clusters"):
        tt.candidates(torch.zeros((c, tt.BND_COLS)), torch.zeros((tt.RAY_ROWS, 4)), 4)
    assert tt.candidates_reference.calls == calls


@pytest.mark.parametrize("n,per_sm,threads,grid,lanes", [
    (480000, 6, 256, 792, 1),     # the resident blocks, a lane a ray
    (47999, 6, 256, 750, 4),      # 4 lanes: windows of 64 rays
    (34350, 6, 256, 537, 4),
    (17891, 6, 256, 560, 8),      # 8 lanes: windows of 32 rays
    (5551, 6, 256, 694, 32),      # a warp a ray: windows of 8 rays
    (305, 8, 256, 39, 32),
    (1, 6, 256, 1, 32),
    (100, 3, 128, 25, 32),        # a warp a ray: windows of 4 rays
])
def test_cand_grid_gives_small_launches_more_lanes(n, per_sm, threads, grid, lanes):
    """K6's launch: one lane a ray, doubled up to a warp while the resident
    threads hold every ray, and the resident blocks, at most one a window
    of threads / lanes rays, so that a small launch spreads over the card;
    the kernel takes the lanes as its argument."""
    assert tt.cand_grid(n, (per_sm, threads, 16384), H100_SMS) == (grid, lanes.bit_length() - 1)


@pytest.mark.parametrize("n", [1, 5, 16, 35, 100, 305, 688, 5551, 10251, 17891, 27459, 34350,
                               47999, 480000])
def test_kernel_lanes_agree_with_the_grid(n):
    """The lanes a ray the wrapper passes the kernel and its grid agree:
    the most lanes (up to a warp) at which the resident threads hold every
    ray, and no block without a window (threads / lanes rays) unless the
    grid is the whole resident set."""
    per_sm, threads = 6, 256
    resident = H100_SMS * per_sm * threads
    grid, lg = tt.cand_grid(n, (per_sm, threads, 16384), H100_SMS)
    lanes = 1 << lg
    assert 0 <= lg <= 5
    assert lanes == 32 or n * lanes * 2 > resident
    assert lanes == 1 or n * lanes <= resident
    windows = -(-n // (threads // lanes))
    assert windows >= grid or grid == H100_SMS * per_sm


def test_cand_grid_refuses_an_instance_that_fits_no_sm():
    """A bounds table that leaves no block room on an SM raises (the
    wrapper checks this before every launch)."""
    with pytest.raises(ValueError, match="fits an SM"):
        tt.cand_grid(47999, (0, 256, 131072), H100_SMS)


def test_dense_intersect_returns_int64_prim_and_misses_on_the_cpu():
    """K5's contract on the CPU path: t float32 and prim int64, -1 / -1 on
    a miss (the kernel writes the same dtype on the card)."""
    from cpupathtrace_tpu_torch.models.scenes import bench_box_scene

    scene = bench_box_scene(device=CPU)
    o = torch.tensor([[0.0, 0.0, 0.0], [0.0, 0.0, 50.0]])
    d = torch.tensor([[0.0, 0.0, 1.0], [0.0, 0.0, 1.0]])
    t, p = oi.dense_intersect(scene, o, d)
    assert t.dtype == torch.float32 and p.dtype == torch.int64
    assert p[0] >= 0 and t[0] > 0
    assert p[1] == -1 and t[1] == -1.0
