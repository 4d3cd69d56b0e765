"""K8's compute stage (cpupathtrace_tpu_torch/accel/cluster_major.py) on the
CPU: the plain model of its kernel's split (each pair's rows cut into S
ranges at 8-row group boundaries, the ranges' partials merged by the key
(t, group, prim)) against the plain version `_test_candidates` and against
the JAX kernel's outputs in the committed fixture (the same per-pair
function as `_isect_call`, as test_torch_binned_wavefront.py holds K7's
plain version to it); planted ties that a merge by t alone, or one where a
later range wins a tie, gets wrong; the kernel's work list and launch shape
from the shapes alone; the binning's counts added on the device; the
cluster blocks kept per scene. The kernel itself is held to the plain
version on the card by tests/test_torch_cuda.py and chip_smoke.py.

Bounds: the model and the plain version do the same float32 operations,
so t is equal bit for bit; against the JAX kernel, prim is equal on every
pair and t within rtol 1e-5 (XLA:CPU fuses the Möller-Trumbore sums into
FMAs, torch does not).
"""
import os

import numpy as np
import pytest
import torch

from cpupathtrace_tpu_torch import _build
from cpupathtrace_tpu_torch.accel import binned, cluster_major as cm, traverse as tt
from cpupathtrace_tpu_torch.experiments import cluster_major_sweep as cms
from cpupathtrace_tpu_torch.experiments.query_sweep import variant_csrc
from tests.torch_util import binned_dragon, binned_rays

FIXTURE = os.path.join(os.path.dirname(__file__), "fixtures", "torch_binned.npz")
T_RTOL = 1e-5
SPLITS = (1, 2, 3, 4, 8)


@pytest.fixture(scope="module")
def dragon():
    return binned_dragon("port")


@pytest.fixture(scope="module")
def query(dragon):
    o, d = (torch.from_numpy(a) for a in binned_rays(512, 3))
    ids, _ = binned.generate_candidates(dragon, o, d, 4)
    return o, d, ids


def _bits(t):
    return t.contiguous().view(torch.int32)


def merge_by_t(parts):
    """A wrong merge: the least t, and at equal t the smaller prim whatever
    their groups (the cluster's rows as one group)."""
    t, _, p = parts[0]
    for tj, _, pj in parts[1:]:
        take = (tj < t) | ((tj == t) & (pj < p))
        t, p = torch.where(take, tj, t), torch.where(take, pj, p)
    return t, p


def merge_later_wins(parts):
    """A wrong merge: a later range wins a tie of t."""
    t, _, p = parts[0]
    for tj, _, pj in parts[1:]:
        take = tj <= t
        t, p = torch.where(take, tj, t), torch.where(take, pj, p)
    return t, p


def work_assignments(chunk_start, offs, groups, threads: int, splits: int):
    """The kernel's work list, item by item and warp by warp: [(item, warp,
    cluster, first pair, end pair, first group, end group)] for every warp
    whose slot holds a pair, as csrc/cluster_major.cu derives them from
    `chunk_start`, `offs` and `groups` (lists of ints) in a block of
    `threads`."""
    n_clusters = len(offs) - 1
    per_item = cm.item_pairs(threads, splits)
    out = []
    for item in range(chunk_start[n_clusters]):
        c = max(k for k in range(n_clusters) if chunk_start[k] <= item)
        for warp in range(threads // 32):
            slot, j = divmod(warp, splits)
            first = offs[c] + (item - chunk_start[c]) * per_item + slot * 32
            if first < offs[c + 1]:
                g0, g1 = cm.range_bounds(groups[c], splits, j)
                out.append((item, warp, c, first, min(first + 32, offs[c + 1]), g0, g1))
    return out


# ---------------------------------------------------------------------------
# The split model against the plain version and the JAX kernel.
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("splits", SPLITS)
def test_split_model_matches_the_plain_stage(dragon, query, splits):
    """The model's ranges and merge give the sequential group rule's (t,
    prim) on every slot of a query on the dragon (64-row clusters: 8 groups,
    up to one a range at S = 8)."""
    o, d, ids = query
    blocks = cm.cluster_blocks(dragon)
    tp, pp = cm._test_candidates(blocks, o, d, ids)
    tm, pm = cm.split_stage_model(blocks, o, d, ids, splits)
    assert torch.equal(_bits(tm), _bits(tp)) and torch.equal(pm, pp)
    assert int((pp >= 0).sum()) > 200 and int((ids < 0).sum()) > 0


@pytest.mark.parametrize("splits", SPLITS)
def test_split_model_matches_the_jax_kernel(dragon, splits):
    """The model on the JAX kernel's pairs (one candidate slot a pair,
    its cluster from the bin offsets): prim equal on every pair, t to a few
    ulp where both hit."""
    with np.load(FIXTURE) as f:
        rays, offs = torch.from_numpy(f["isect_rays"]), torch.from_numpy(f["isect_offs"])
        ref_t, ref_p = f["isect_t"], f["isect_prim"]
    cl = tt._pair_clusters(offs, rays.shape[1])
    ids = torch.where(cl < dragon.trv_blocks.shape[0], cl, -1).long()[:, None]
    o, d = rays[0:3].t().contiguous(), rays[3:6].t().contiguous()
    t, p = cm.split_stage_model(dragon.trv_blocks, o, d, ids, splits)
    np.testing.assert_array_equal(p[:, 0].numpy(), ref_p)
    hit = ref_p >= 0
    assert hit.sum() > 100
    np.testing.assert_allclose(t[:, 0].numpy()[hit], ref_t[hit], rtol=T_RTOL, atol=0)
    assert np.isinf(t[:, 0].numpy()[~hit]).all()


# ---------------------------------------------------------------------------
# Planted ties.
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("splits", [2, 4])
def test_planted_ties_follow_the_group_rule(splits):
    """Equal t in groups 1 and 2 (on opposite sides of a range boundary at S
    = 2 and 4): the earlier group's prim (9), though the later's (4) is
    smaller; equal t inside a group: the smallest prim (5)."""
    blocks, o, d, ids, prims = cms.planted_ties("cpu")
    tp, pp = cm._test_candidates(blocks, o, d, ids)
    assert pp.tolist() == prims == [[9, 5], [5, -1]] and tp[0].tolist() == [1.0, 1.0]
    tm, pm = cm.split_stage_model(blocks, o, d, ids, splits)
    assert torch.equal(pm, pp) and torch.equal(_bits(tm), _bits(tp))


@pytest.mark.parametrize("merge", [merge_by_t, merge_later_wins])
@pytest.mark.parametrize("splits", [2, 4])
def test_wrong_merges_fail_on_the_planted_ties(merge, splits):
    """A merge by t alone (ties to the smaller prim) and one where the
    later range wins a tie both report prim 4 for the cross-boundary tie:
    the tests above would catch either in the kernel's model."""
    blocks, o, d, ids, _ = cms.planted_ties("cpu")
    _, pp = cm._test_candidates(blocks, o, d, ids)
    _, pm = cm.split_stage_model(blocks, o, d, ids, splits, merge=merge)
    assert pm[0, 0] == 4 and not torch.equal(pm, pp)


def test_wrong_merges_agree_without_ties(dragon, query):
    """Off the ties the wrong merges give the right answers on the dragon's
    query: the planted ties are what tells them apart."""
    o, d, ids = query
    blocks = cm.cluster_blocks(dragon)
    _, pp = cm._test_candidates(blocks, o, d, ids)
    for merge in (merge_by_t, merge_later_wins):
        _, pm = cm.split_stage_model(blocks, o, d, ids, 4, merge=merge)
        assert float((pm == pp).float().mean()) > 0.99


# ---------------------------------------------------------------------------
# The work list and the launch's shape.
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("threads,splits", [(64, 1), (64, 2), (128, 1), (128, 4), (256, 2),
                                            (256, 8)])
def test_work_list_covers_every_pair_and_range_once(threads, splits):
    """Every (binned pair, filled group) is tested by exactly one warp, every
    pair has one warp of each range and is written by its range-0 warp; the
    items and the grid stay within the bound from the shapes alone."""
    rng = np.random.default_rng(threads + splits)
    c, rows, n_slots = 37, 64, 4000
    counts = rng.integers(0, 90, c)
    counts[::5] = 0
    groups = rng.integers(0, rows // 8 + 1, c)
    groups[1::6] = 0
    offs = np.concatenate([[0], np.cumsum(counts)]).astype(np.int32)
    assert offs[-1] <= n_slots
    per_item = cm.item_pairs(threads, splits)
    chunk_start, bound = tt.work_items(torch.from_numpy(offs), n_slots, per_item)
    work = work_assignments(chunk_start.tolist(), offs.tolist(), groups.tolist(), threads,
                            splits)
    tested = np.zeros((offs[-1], rows // 8), np.int64)
    ranges = np.zeros((offs[-1], splits), np.int64)
    for item, warp, cl, first, end, g0, g1 in work:
        assert offs[cl] <= first < end <= offs[cl + 1] and end - first <= 32
        tested[first:end, g0:g1] += 1
        ranges[first:end, warp % splits] += 1
    pair_groups = np.repeat(groups, counts)
    assert (tested == (np.arange(rows // 8)[None, :] < pair_groups[:, None])).all()
    assert (ranges == 1).all()
    n_items = int(chunk_start[-1])
    assert n_items <= bound == -(-n_slots // per_item) + c
    grid = cm.stage_grid(n_slots, c, per_item, blocks_per_sm=3, sms=4)
    assert 1 <= grid <= min(bound, 12)
    assert cm.stage_grid(n_slots, c, per_item, blocks_per_sm=50, sms=132) == bound
    with pytest.raises(ValueError, match="fits"):
        cm.stage_grid(n_slots, c, per_item, blocks_per_sm=0, sms=132)


def test_launch_shape_from_the_shapes():
    """S doubles while the block's warps hold S ranges of at least
    MIN_RANGE_GROUPS groups: the 200k dragon's 512-row clusters take 4 at
    128 threads, 8 at 256; the test dragon's 64 rows 2."""
    assert cm.MIN_RANGE_GROUPS == 4
    assert [cm.stage_splits(512, th) for th in (64, 128, 256)] == [2, 4, 8]
    assert [cm.stage_splits(64, th) for th in (64, 128, 256)] == [2, 2, 2]
    assert cm.stage_splits(8, 256) == 1 and cm.stage_splits(3584, 256) == 8
    assert [cm.item_pairs(128, s) for s in (1, 2, 4)] == [128, 64, 32]
    # Rows staged in shared memory up to 96 KB of them (1,536 rows).
    assert cm.stage_staged(512) and cm.stage_staged(1536) and not cm.stage_staged(3584)


def test_range_bounds_cut_at_group_boundaries():
    """Range j of S over g groups is [j g / S, (j + 1) g / S): contiguous,
    in order, covering the g groups, sizes within one of each other."""
    for g in range(0, 70):
        for s in (1, 2, 3, 4, 8):
            b = [cm.range_bounds(g, s, j) for j in range(s)]
            assert b[0][0] == 0 and b[-1][1] == g
            assert all(b[j][1] == b[j + 1][0] for j in range(s - 1))
            sizes = [hi - lo for lo, hi in b]
            assert max(sizes) - min(sizes) <= 1


# ---------------------------------------------------------------------------
# The stage's glue: counts on the device, blocks per scene, dispatch.
# ---------------------------------------------------------------------------


def test_binning_matches_bincount():
    """bin_offsets bins with one stable sort and a binary search (no host
    read, no atomics on the card): the offsets are the cumulative counts
    torch.bincount gives, the order is the stable argsort of the keys, and
    bin_candidates' counts and sorted keys follow from them."""
    rng = np.random.default_rng(9)
    ids = torch.from_numpy(rng.integers(-1, 40, (1000, 4)))
    ids[::7] = -1
    ids[:, 3] = 5  # a crowded cluster
    order, sorted_key, offs = binned.bin_offsets(ids, 40)
    flat = ids.reshape(-1)
    key = torch.where(flat >= 0, flat, 40)
    want = torch.bincount(key, minlength=41)
    assert offs.dtype == torch.int32 and offs.shape == (41,)
    assert torch.equal(offs.long(), torch.cat([torch.zeros(1, dtype=torch.int64),
                                               torch.cumsum(want, 0)[:-1]]))
    assert torch.equal(order, torch.argsort(key, stable=True))
    assert torch.equal(sorted_key.long(), key[order])
    o2, k2, c2 = binned.bin_candidates(ids, 40)
    assert torch.equal(o2, order) and torch.equal(c2, want[:40]) and torch.equal(k2, key[order])
    _, _, none = binned.bin_offsets(torch.full((3, 2), -1), 4)
    assert none.tolist() == [0, 0, 0, 0, 0]


def test_cluster_blocks_are_packed_once_per_scene(monkeypatch):
    """A scene without K7's tables (here the dragon built for the sweep) is
    packed at its first call and its blocks kept; a binned build serves its
    own trv_blocks."""
    scene, other = binned_dragon("port", "sweep"), binned_dragon("port", "sweep")
    built = binned_dragon("port")
    calls = []
    pack = tt.pack_blocks
    monkeypatch.setattr(tt, "pack_blocks", lambda *a: calls.append(1) or pack(*a))
    first = cm.cluster_blocks(scene)
    assert cm.cluster_blocks(scene) is first and len(calls) == 1
    assert first.shape == (scene.blk_prim.shape[0], scene.blk_prim.shape[1], tt.BLK_COLS)
    assert cm.cluster_blocks(other) is not first and len(calls) == 2
    assert torch.equal(cm.cluster_blocks(other), first)
    assert cm.cluster_blocks(built) is built.trv_blocks and len(calls) == 2


def test_parent_stage_form_matches_plain(dragon, query):
    """The parent's form of the stage, which the sweep's `k7` and `parent`
    rows time: the binned pairs gathered into K7's ray planes
    (`k7_inputs`), K7's plain version on them, scattered back into slot
    order, gives the plain stage's slots on the CPU."""
    o, d, ids = query
    blocks = cm.cluster_blocks(dragon)
    order, offs, rays = cms.k7_inputs(cm, ids, o, d, blocks.shape[0])
    assert torch.equal(rays[:3, 5], o[order[5] // ids.shape[1]])
    ts, ps = tt.isect_reference(blocks, rays, offs)
    t, p = torch.empty_like(ts), torch.empty_like(ps)
    t[order], p[order] = ts, ps
    tp, pp = cm._test_candidates(blocks, o, d, ids)
    assert torch.equal(_bits(t), _bits(tp.reshape(-1))) and torch.equal(p.long(), pp.reshape(-1))


@pytest.mark.parametrize("source,const,value", [
    ("cluster_major.cu", "kThreads", 64), ("cluster_major.cu", "kThreads", 256),
    ("cluster_major.cu", "kMinWarps", 32), ("exp_supscan.cu", "kRayLanes", 2),
    ("exp_supscan.cu", "kRayLanes", 8)])
def test_sweep_builds_rewrite_one_constant(tmp_path, source, const, value):
    """The sweeps build their other blocks, register caps and lanes a ray
    from a copy of csrc/ with one constant rewritten: the build's own values
    are those the sweeps label it with (K8's 128 threads, uncapped; X1's
    one lane a ray), and the copy differs from csrc/ only there."""
    own = (_build.CSRC / source).read_text()
    assert f"constexpr int kThreads = {cms.BUILD_THREADS};" in _build.CSRC.joinpath(
        "cluster_major.cu").read_text()
    assert "constexpr int kMinWarps = 0;" in own or source != "cluster_major.cu"
    assert "constexpr int kRayLanes = 1;" in own or source != "exp_supscan.cu"
    tree = variant_csrc(tmp_path / "csrc", source, {const: value})
    text = (tree / source).read_text()
    assert f"constexpr int {const} = {value};" in text
    changed = [(a, b) for a, b in zip(own.splitlines(), text.splitlines()) if a != b]
    assert len(changed) == 1 and len(own.splitlines()) == len(text.splitlines())
    assert (tree / "bulk_copy.cuh").read_text() == (_build.CSRC / "bulk_copy.cuh").read_text()


def test_stage_on_the_cpu_runs_the_plain_version(dragon, query):
    """CPU tensors take `_test_candidates` and launch nothing; a device with
    no kernel raises."""
    o, d, ids = query
    blocks = cm.cluster_blocks(dragon)
    calls, launches = cm._test_candidates.calls, cm.test_candidates.launches
    t, p = cm.test_candidates(blocks, o, d, ids)
    assert cm._test_candidates.calls == calls + 1 and cm.test_candidates.launches == launches
    assert t.shape == p.shape == ids.shape and p.dtype == torch.int64
    meta = torch.zeros((4, 3), device="meta")
    with pytest.raises(ValueError, match="no kernel"):
        cm.test_candidates(blocks.to("meta"), meta, meta, torch.zeros((4, 1), dtype=torch.int64,
                                                                         device="meta"))
