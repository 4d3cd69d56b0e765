"""X3's record tests split over the card and X2's layouts, on the CPU.

The X3 kernel (csrc/exp_record_variants.cu) splits the record tests into
chunks, one block a (row, chunk), and folds the partial minima in chunk
order; matmul_extract's row 0 blocks write each test's summary (least t,
one-hot sums at it and over all), and a scan runs the corrections in test
order. Here: the split plan (`block_work`) covers every (ray, record
test) once and its counts are the formula's; the plain model of the split
(`split_model`, with `extract_scan_model` for that row 0) has the plain
version's bits on the script's inputs, the near inputs and a planted
-0.0 / +0.0 pair, which a combine by the floats' bits gets wrong; row 0 of
matmul_extract folded like the others gives another bt, so its
corrections must run in order; the near inputs (`check_inputs`) make the
extraction move row 0, which the script's inputs never do, and their row
0 is too ill-conditioned in float32 for rtol 1e-5, so the card holds its t
to `near_bound` of the float64 plain version and the extraction's sum of
corrections (matmul_extract - matmul) to the plain versions' within
`EXTRACT_ULPS`, a check that passes another formulation of the products
and fails a wrong correction. X2: each layout covers a tile
once, and the bound counts the fold as the function computes it.
"""
import numpy as np
import pytest
import torch

from cpupathtrace_tpu_torch.experiments import cond_fat as cf
from cpupathtrace_tpu_torch.experiments import record_variants as rv

torch.set_num_threads(2)

# The chunk counts the tests split into: one, a few, the wrapper's at 256
# tests on an H100 (264 resident blocks of matmul over 8 rows: 33), and more
# than some of the record counts.
GRIDS = (1, 3, 33, 40, 264)


def _bits(t):
    return t.contiguous().view(torch.int32)


@pytest.fixture(scope="module")
def script():
    tables, rays = rv.inputs()
    return {v: torch.from_numpy(t) for v, t in tables.items()}, torch.from_numpy(rays)


@pytest.fixture(scope="module")
def near():
    tables, rays = rv.check_inputs()
    return {v: torch.from_numpy(t) for v, t in tables.items()}, torch.from_numpy(rays)


@pytest.mark.parametrize("k_iters", [1, 2, 31, 32, 33, 256, 2048])
@pytest.mark.parametrize("variant", rv.VARIANTS)
def test_split_plan_covers_every_test_once(variant, k_iters):
    n = rv.SER_RECS if variant == "serial" else rv.NREC
    for chunks in GRIDS:
        work = rv.block_work(k_iters, chunks)
        assert len(work) == rv.grid_blocks(chunks)
        seen = np.zeros((rv.ROWS * rv.LANES, k_iters), np.int64)
        counts = np.zeros(rv.count_slots(variant), np.int64)
        for first, rays, k0, k1 in work:
            assert 0 <= k0 <= k1 <= k_iters
            seen[first:first + rays, k0:k1] += 1
            for k in range(k0, k1):
                counts[k % n] += rays
        assert (seen == 1).all(), (chunks, np.argwhere(seen != 1)[:3])
        if variant == "matmul_extract":
            counts[rv.NREC] = sum(r * (k1 - k0) for f, r, k0, k1 in work if f < rv.LANES)
        np.testing.assert_array_equal(counts, rv.expected_counts(variant, k_iters))


def test_chunk_bounds_are_contiguous_and_balanced():
    for k_iters in (0, 1, 5, 256, 2048):
        for chunks in GRIDS:
            b = rv.chunk_bounds(k_iters, chunks)
            assert b[0][0] == 0 and b[-1][1] == k_iters
            assert all(b[i][1] == b[i + 1][0] for i in range(chunks - 1))
            sizes = [k1 - k0 for k0, k1 in b]
            assert max(sizes) - min(sizes) <= 1


def test_wrapper_chunks_fill_one_wave():
    for k_iters in (1, 5, 256, 16384):
        for resident in (20, 264, 1848):
            c = rv.chunks_for(k_iters, resident)
            assert 1 <= c <= max(1, k_iters)
            assert rv.grid_blocks(c) <= max(resident, rv.grid_blocks(1))


@pytest.mark.parametrize("variant", rv.VARIANTS)
def test_plain_counts_are_the_formula(script, variant):
    tables, rays = script
    bt, cnt = rv.record_variant(variant, tables[variant], rays, 37, counts=True)
    assert cnt.dtype == torch.int64 and bt.shape == (1024,)
    np.testing.assert_array_equal(cnt.numpy(), rv.expected_counts(variant, 37))
    assert int(cnt[:rv.SER_RECS if variant == "serial" else rv.NREC].sum()) == 37 * 1024
    assert torch.equal(bt, rv.variant_reference(variant, tables[variant], rays, 37))


@pytest.mark.parametrize("inputs", ["script", "near"])
@pytest.mark.parametrize("variant", rv.VARIANTS)
def test_split_model_has_the_plain_versions_bits(script, near, inputs, variant):
    tables, rays = script if inputs == "script" else near
    ref = rv.variant_reference(variant, tables[variant], rays, 9)
    for chunks in (1, 4, 9, 40):
        model = rv.split_model(variant, tables[variant], rays, 9, chunks)
        assert torch.equal(_bits(model), _bits(ref)), chunks


def _plant(tables, rays, rec, tri, ray, v0, e1, e2, o, d):
    """One triangle written into every variant's table (make_tables'
    formulas in float32) and one ray."""
    v0, e1, e2 = (np.float32(x) for x in (v0, e1, e2))
    n = np.cross(e1, e2)
    v0xe2, v0xe1 = np.cross(v0, e2), np.cross(v0, e1)
    d0 = (v0 * n).sum()
    T = rv.T
    pf = tables["matmul"][rec]
    pf[:, [tri, T + tri, 2 * T + tri, 3 * T + tri]] = 0.0
    pf[0:3, tri] = -n
    pf[3:6, T + tri] = e2
    pf[0:3, T + tri] = v0xe2
    pf[3:6, 2 * T + tri] = -e1
    pf[0:3, 2 * T + tri] = -v0xe1
    pf[6:9, 3 * T + tri] = n
    pf[9, 3 * T + tri] = -d0
    tables["outer"][rec, tri] = np.concatenate([-n, e2, v0xe2, -e1, -v0xe1, [d0]])
    if rec < rv.SER_RECS:
        tables["serial"][rec, 0:3, tri], tables["serial"][rec, 3:6, tri] = v0, e1
        tables["serial"][rec, 6:9, tri] = e2
    rays[0:3, ray], rays[3:6, ray] = o, d


def _planted(flip_first):
    """The script's inputs with ray 300 starting on a triangle (t = 0)
    planted in records 0 and 1 with opposite windings: one record gives it
    t = -0.0, the other +0.0 (`flip_first` swaps which)."""
    tables, rays = rv.inputs()
    tables = {v: t.copy() for v, t in tables.items()}
    tables["matmul_extract"] = tables["matmul"]
    rays = rays.copy()
    v0, e1, e2 = (-0.25, -0.25, 0.0), (1.0, 0.0, 0.0), (0.0, 1.0, 0.0)
    for rec, (a, b) in enumerate([(e1, e2), (e2, e1)][::-1 if flip_first else 1]):
        _plant(tables, rays, rec, 5, 300, v0, a, b, (0.0, 0.0, 0.0), (0.0, 0.0, 1.0))
    return {v: torch.from_numpy(t) for v, t in tables.items()}, torch.from_numpy(rays)


def _bits_combine(signed):
    """A combine that orders the floats by their bits, as an integer
    atomicMin would: -0.0 below everything (signed) or +0.0 below -0.0
    (unsigned)."""
    def combine(acc, part):
        a, p = acc.view(torch.int32).to(torch.int64), part.view(torch.int32).to(torch.int64)
        if not signed:
            a, p = a & 0xFFFFFFFF, p & 0xFFFFFFFF
        return torch.where(p < a, part, acc)
    return combine


@pytest.mark.parametrize("variant", ["serial", "outer", "matmul"])
def test_split_model_keeps_signed_zeros_of_a_planted_pair(variant):
    wrong = {True: False, False: False}
    for flip_first in (False, True):
        tables, rays = _planted(flip_first)
        per_record = [rv._run(variant, tables[variant], rays, [k])[300] for k in (0, 1)]
        assert [float(t) for t in per_record] == [0.0, 0.0]
        ref = rv.variant_reference(variant, tables[variant], rays, 2)
        assert float(ref[300]) == 0.0
        for chunks in (1, 2, 3):
            model = rv.split_model(variant, tables[variant], rays, 2, chunks)
            assert torch.equal(_bits(model), _bits(ref)), (flip_first, chunks)
        signs = {bool(torch.signbit(t)) for t in per_record}
        if signs == {True, False}:  # the pair holds both zeros: bits decide
            for signed in (True, False):
                bad = rv.split_model(variant, tables[variant], rays, 2, 2,
                                     combine=_bits_combine(signed))
                wrong[signed] |= not torch.equal(_bits(bad[300]), _bits(ref[300]))
    if variant != "matmul":  # torch.matmul may sum the zero products to +0.0 both times
        assert wrong[True] and wrong[False]


def test_row0_of_extract_must_stay_in_order(near):
    tables, rays = near
    pf = tables["matmul"]
    ref = rv.variant_reference("matmul_extract", pf, rays, 256)
    assert torch.equal(_bits(rv.split_model("matmul_extract", pf, rays, 256, 7)), _bits(ref))
    split = rv.split_model("matmul_extract", pf, rays, 256, 7, row0_split=True)
    assert torch.equal(_bits(split[rv.LANES:]), _bits(ref[rv.LANES:]))
    assert int((split[:rv.LANES] != ref[:rv.LANES]).sum()) >= 32


@pytest.mark.parametrize("k_iters", [1, 33, 64])
@pytest.mark.parametrize("inputs", ["script", "near"])
def test_extract_scan_model_has_the_plain_bits(script, near, inputs, k_iters):
    """Row 0 of matmul_extract from per-test summaries (least t, one-hot
    sums at it and over all, none of them from bt) and the in-order scan:
    the plain version's bits, also where the extraction moves bt."""
    tables, rays = script if inputs == "script" else near
    pf = tables["matmul"]
    ref = rv.variant_reference("matmul_extract", pf, rays, k_iters)[:rv.LANES]
    assert torch.equal(_bits(rv.extract_scan_model(pf, rays, k_iters)), _bits(ref))


def test_near_inputs_show_the_extraction(script, near):
    """On the script's inputs matmul_extract equals matmul bit for bit (the
    old check could not fail); on the near inputs it moves at least 96 of
    row 0's rays (chip_smoke's bound) and none of rows 1-7."""
    for (tables, rays), lo in ((script, 0), (near, 96)):
        pf = tables["matmul"]
        e = rv.variant_reference("matmul_extract", pf, rays, 256)
        m = rv.variant_reference("matmul", pf, rays, 256)
        moved = int((e[:rv.LANES] != m[:rv.LANES]).sum())
        assert torch.equal(_bits(e[rv.LANES:]), _bits(m[rv.LANES:]))
        assert moved >= lo and (lo or moved == 0)
        assert bool((m[:rv.LANES] < rv.START).all()) or not lo


def test_near_inputs_are_the_script_but_row0():
    tables, rays = rv.check_inputs()
    st, sr = rv.inputs()
    for v in rv.VARIANTS:
        np.testing.assert_array_equal(tables[v], st[v])
    np.testing.assert_array_equal(rays[:, rv.LANES:], sr[:, rv.LANES:])
    d = rays[3:6, :rv.LANES]
    np.testing.assert_allclose(np.linalg.norm(d, axis=0), 1.0, rtol=1e-6)


def test_near_row0_needs_the_float64_bound(near):
    """Row 0's t on the near inputs cancels ~1e5-fold: the float32 plain
    version is off the float64 one by far more than rtol 1e-5 (so no
    float32 formulation can be held to another there), yet within
    `near_bound`; a t from another record or triangle is not."""
    tables, rays = near
    pf = tables["matmul"]
    f32 = rv.variant_reference("matmul", pf, rays, 64).double().numpy()
    f64 = rv._run("matmul", pf.double(), rays.double(), range(64)).numpy()
    rel = np.abs(f32 - f64) / f64
    assert rel[:rv.LANES].max() > 1e-3 and rel[rv.LANES:].max() < 1e-5
    bound = rv.near_bound(pf.numpy(), rays.numpy())
    assert (np.abs(f32 - f64)[:rv.LANES] <= bound).all()
    assert (bound < 0.5 * f64[:rv.LANES]).all()
    other = rv.variant_reference("matmul", pf[1:].contiguous(), rays, 31).double().numpy()
    assert not (np.abs(other - f64)[:rv.LANES] <= bound).any()


@pytest.mark.parametrize("threads,ctas", cf.SWEEP_LAYOUTS)
def test_cond_fat_layout_covers_each_element_once(threads, ctas):
    cta, thread, slot = cf.tile_map(threads, ctas)
    assert cta.max() == ctas - 1 and thread.max() == threads - 1
    assert slot.max() == cf.TILE // (threads * ctas) - 1
    keys = (cta * threads + thread) * (slot.max() + 1) + slot
    assert np.array_equal(np.sort(keys), np.arange(cf.TILE))
    # a CTA's threads read neighbouring elements: coalesced
    assert (np.diff(np.arange(cf.TILE)[(cta == 0) & (slot == 0)]) == 1).all()


def test_cond_fat_conditional_layouts_take_one_cta():
    """A conditional's vote is one block barrier: its layouts are the
    sweep's one-CTA ones, which cover a tile; the inline ones take all."""
    assert cf.COND_LAYOUTS == ((128, 1), (256, 1), (512, 1))
    for threads, ctas in cf.COND_LAYOUTS:
        cta, thread, slot = cf.tile_map(threads, ctas)
        assert (cta == 0).all() and (slot.max() + 1) * threads == cf.TILE
    assert set(cf.COND_LAYOUTS) < set(cf.SWEEP_LAYOUTS)


def test_cond_fat_ops_count_the_fold_once():
    """y * 1e-12 once, then n_live adds: n_live + 1 an element and
    iteration, beside 8 updates of 2 (3 with the predicate)."""
    for n_live, use_cond in ((2, True), (19, True), (2, False), (19, False)):
        per_iter = 8 * (3 if use_cond else 2) + n_live + 1
        setup = n_live + 2 * (n_live - 1)
        assert cf.cond_fat_ops(n_live, use_cond, 10) == cf.BLOCKS * cf.TILE * (
            10 * per_iter + setup)
    assert cf.cond_fat_ops(19, True, 1024) < 0.75 * cf.BLOCKS * cf.TILE * 1024 * (24 + 38)


def _extract_variant(fault):
    """A `run` for `rv.extraction`: matmul and matmul_extract with `fault`
    in the extraction (None: the plain versions; "f64_products": both
    variants with the products in float64 rounded to float32, another
    formulation of the same function, as the kernel's 3xTF32 is;
    "uw_only", "scale" (1e-11), "onehot_all" (the sums over every
    triangle), "skipped": wrong)."""
    def run(variant, pf, rays, k_iters):
        if fault is None or (variant == "matmul" and fault != "f64_products"):
            return rv.variant_reference(variant, pf, rays, k_iters)
        ox, oy, oz, dx, dy, dz = (rays[j].reshape(rv.ROWS, rv.LANES) for j in range(6))
        a = torch.stack([dx, dy, dz, oy * dz - oz * dy, oz * dx - ox * dz, ox * dy - oy * dx,
                         ox, oy, oz, torch.ones_like(ox)] + [torch.zeros_like(ox)] * 6, dim=1)
        bt, T = torch.full((rv.ROWS, rv.LANES), rv.START), rv.T
        for k in range(k_iters):
            if fault == "f64_products":
                c = torch.matmul(pf[k % rv.NREC].t().double(), a.double()).float()
            else:
                c = torch.matmul(pf[k % rv.NREC].t(), a)
            key, su, sv, sd = rv._test(c[:, 0:T], c[:, T:2 * T], c[:, 2 * T:3 * T],
                                       c[:, 3 * T:4 * T], bt[:, None])
            tmin = key.amin(1)
            new = torch.minimum(bt, tmin)
            if variant == "matmul":
                bt = new
                continue
            onehot = (key[0] == tmin[0][None]).to(pf.dtype)
            if fault == "onehot_all":
                onehot = torch.ones_like(onehot)
            sdw = (onehot * sd[0]).sum(0)
            uw = (onehot * su[0]).sum(0) / sdw.clamp_min(1e-30)
            vw = (onehot * sv[0]).sum(0) / sdw.clamp_min(1e-30)
            corr = {"uw_only": 1e-12 * uw, "scale": 1e-11 * (uw + vw),
                    "skipped": torch.zeros_like(uw)}.get(fault, 1e-12 * (uw + vw))
            new[0] = new[0] + corr
            bt = new
        return bt.reshape(-1)
    return run


@pytest.mark.parametrize("fault", [None, "f64_products", "uw_only", "scale", "onehot_all",
                                   "skipped"])
def test_extraction_check_holds_the_corrections(near, fault):
    """`rv.extraction` on the near inputs passes the plain version and
    another formulation of its products, with row 0's differences within
    EXTRACT_ULPS of the plain ones, and fails an extraction that adds a
    wrong correction or none."""
    tables, rays = near
    run = _extract_variant(fault)
    if fault in (None, "f64_products"):
        ext = rv.extraction(tables["matmul"], rays, 64, near=True, run=run)
        assert ext["row0_err_ulps"] <= rv.EXTRACT_ULPS and ext["row0_moved"] >= rv.MIN_MOVED
    else:
        with pytest.raises(RuntimeError, match="extraction"):
            rv.extraction(tables["matmul"], rays, 64, near=True, run=run)


def test_extraction_check_on_the_script_inputs(script):
    """On the script's inputs the extraction moves nothing, and the check
    says so (a run that moves row 0 there fails it)."""
    tables, rays = script
    ext = rv.extraction(tables["matmul"], rays, 16, near=False)
    assert ext == dict(row0_moved=0, rest_moved=0, plain_row0_moved=0, row0_err_ulps=0.0)

    def one_ulp(variant, pf, rays, k_iters):
        bt = rv.variant_reference(variant, pf, rays, k_iters)
        if variant == "matmul_extract":
            bt[:rv.LANES] = torch.nextafter(bt[:rv.LANES], torch.tensor(float("inf")))
        return bt

    with pytest.raises(RuntimeError, match="extraction"):
        rv.extraction(tables["matmul"], rays, 16, near=False, run=one_ulp)
