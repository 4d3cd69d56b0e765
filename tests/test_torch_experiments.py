"""The CUDA ports of the TPU microbenchmarks X1-X5
(cpupathtrace_tpu_torch/experiments/): each plain-torch version against the
TPU script's own kernel in Pallas interpret mode, on the script's inputs,
at small iteration counts. The scripts run their sweeps when imported, so
tests/torch_util.py:load_experiment executes only their imports, constants
and function definitions. Bounds: X1 and X5 equal bit for bit (their
outputs are x plus a count or a sum of table entries); X3 within rtol 1e-5
(the same float32 formulas; XLA:CPU may fuse products into FMAs, the plain
version does not, and the matmul variants sum the product in another
order); X2 within rtol 1e-6 (the same float32 updates; XLA:CPU may fuse
them, measured bit-equal) with the per-tile update counts equal, counted
in the script's kernel by a lax.cond that also counts; X4's C within
1e-5 (fma, 3xtf32) or 1e-3 (tf32) of sum_k |B A| (XLA:CPU's float32 dot
sums in its own order; TF32 keeps 10 mantissa bits), R and X exactly the
min and first argmin of each side's own C. The kernels are held against
the plain versions on the card by tests/test_torch_cuda.py and
chip_smoke.py.
"""
import functools
import types

import numpy as np
import pytest
import torch

from cpupathtrace_tpu_torch.experiments import cond_fat as cf
from cpupathtrace_tpu_torch.experiments import dot_formulations as df
from cpupathtrace_tpu_torch.experiments import record_variants as rv
from cpupathtrace_tpu_torch.experiments import smem_tables as smt
from cpupathtrace_tpu_torch.experiments import supscan as ss
from tests.torch_util import load_experiment, pallas_interpret


@pytest.fixture(scope="module")
def x1():
    return load_experiment("microbench_supscan")


@pytest.fixture(scope="module")
def x3():
    return load_experiment("exp_record_variants")


@pytest.fixture(scope="module")
def x5():
    return load_experiment("microbench_smemtables")


def test_loader_runs_no_sweep(x1, x3, x5):
    assert callable(x1["run"]) and x1["BLOCKS"] == ss.BLOCKS
    assert callable(x3["run_variant"]) and x3["NREC"] == rv.NREC and x3["T"] == rv.T
    assert (x5["ROWS"], x5["LANES"], x5["BLOCKS"]) == (smt.ROWS, smt.LANES, smt.BLOCKS)
    assert "rng" not in x3 and "ts" not in x1  # no top-level statement ran


@pytest.mark.parametrize("sp", ss.SWEEP_SP)
@pytest.mark.parametrize("rows", ss.SWEEP_ROWS)
def test_supscan_plain_matches_tpu_kernel(x1, sp, rows):
    import jax.numpy as jnp

    x, sups = ss.script_inputs()
    with pallas_interpret():
        ref = np.asarray(x1["run"](jnp.asarray(sups[sp]), jnp.asarray(x), n_iter=2, sp=sp,
                                   rows=rows))
    xp, port = ss.inputs()
    np.testing.assert_array_equal(xp, x)
    ours = ss.supscan(torch.from_numpy(port[sp]), torch.from_numpy(xp), 2, rows)
    assert ours.shape == (8 * ss.BLOCKS, 128)
    np.testing.assert_array_equal(ours.numpy(), ref)


@pytest.mark.parametrize("sp", ss.SWEEP_SP)
def test_supscan_check_inputs_make_the_output_depend_on_the_slab_tests(x1, sp):
    """On the check inputs the TPU kernel and the plain version agree bit
    for bit with flags that differ by block (even blocks 2, odd 0), and the
    per-ray least entries are a mix of hits at t > 0 and misses; with every
    box invalid, no block counts."""
    import jax.numpy as jnp

    x, bnd = ss.check_inputs(sp)
    sup128 = np.zeros((sp, 128), np.float32)
    sup128[:, :7] = bnd[:, :7]
    with pallas_interpret():
        ref = np.asarray(x1["run"](jnp.asarray(sup128), jnp.asarray(x), n_iter=2, sp=sp,
                                   rows=16))
    xt, bt = torch.from_numpy(x), torch.from_numpy(bnd)
    ours, ent = ss.supscan(bt, xt, 2, 16, entries=True)
    np.testing.assert_array_equal(ours.numpy(), ref)
    acc = (ours.reshape(ss.BLOCKS, 8, 128) - xt.reshape(ss.BLOCKS, 16, 128)[:, :8])[:, 0, 0]
    np.testing.assert_allclose(acc.numpy(), np.tile([2.0, 0.0], ss.BLOCKS // 2), atol=1e-6)
    hit = torch.isfinite(ent).reshape(ss.BLOCKS, -1)
    assert not bool(hit[1::2].any()) and 0.5 < float(hit[0::2].float().mean()) < 0.95
    assert float((ent[torch.isfinite(ent)] > 0).float().mean()) > 0.99
    bt[:, 6] = 0.0
    none, ent0 = ss.supscan(bt, xt, 2, 16, entries=True)
    assert torch.equal(none, xt.reshape(ss.BLOCKS, 16, 128)[:, :8].reshape(-1, 128))
    assert not bool(torch.isfinite(ent0).any())


def test_supscan_bounds_layout():
    _, sups = ss.script_inputs()
    port = ss.to_port_bounds(sups[32])
    assert port.shape == (32, 8)
    np.testing.assert_array_equal(port[:, :7], sups[32][:, :7])
    assert (port[:, 6] == 1.0).all() and (port[:, 7] == 0.0).all()


def _jax_variant(x3, kernel, table, comps, smem, k_iters, **kw):
    """exp_record_variants.py's `go` (:223-234) at `k_iters` record tests."""
    jax, jnp, pl, pltpu = x3["jax"], x3["jnp"], x3["pl"], x3["pltpu"]
    rays = jnp.stack([jnp.asarray(c) for c in comps])
    spec = pl.BlockSpec(memory_space=pltpu.SMEM if smem else pltpu.VMEM)
    with pallas_interpret():
        out = pl.pallas_call(
            functools.partial(kernel, k_iters=k_iters, **kw),
            in_specs=[spec, pl.BlockSpec(memory_space=pltpu.VMEM)],
            out_specs=pl.BlockSpec(memory_space=pltpu.VMEM),
            out_shape=jax.ShapeDtypeStruct((8, 128), jnp.float32),
        )(jnp.asarray(table), rays)
    return np.asarray(out).reshape(-1)


def test_record_tables_are_the_scripts(x3):
    rng = np.random.default_rng(0)
    pf, op, ser, _ = x3["make_tables"](rng, x3["NREC"])
    _, _, comps = x3["make_rays"](rng)
    tables, rays = rv.inputs()
    np.testing.assert_array_equal(tables["matmul"], pf)
    np.testing.assert_array_equal(tables["outer"], op)
    np.testing.assert_array_equal(tables["serial"], ser[:4])
    np.testing.assert_array_equal(rays, np.stack([c.reshape(-1) for c in comps]))


# variant -> (TPU kernel, its keyword arguments, SMEM table, record tests).
X3_CASES = {
    "serial": ("kernel_serial", {}, True, 3),
    "outer": ("kernel_outer", {}, False, 4),
    "matmul": ("kernel_matmul", {"extract": False}, False, 3),
    "matmul_extract": ("kernel_matmul", {"extract": True}, False, 2),
}


@pytest.mark.parametrize("variant", rv.VARIANTS)
def test_record_variant_plain_matches_tpu_kernel(x3, variant):
    name, kw, smem, k = X3_CASES[variant]
    rng = np.random.default_rng(0)
    pf, op, ser, _ = x3["make_tables"](rng, x3["NREC"])
    _, _, comps = x3["make_rays"](rng)
    table = {"serial": ser[:4], "outer": op}.get(variant, pf)
    ref = _jax_variant(x3, x3[name], table, comps, smem, k, **kw)
    tables, rays = rv.inputs()
    ours = rv.record_variant(variant, torch.from_numpy(tables[variant]), torch.from_numpy(rays),
                             k).numpy()
    assert ours.shape == (1024,)
    np.testing.assert_allclose(ours, ref, rtol=1e-5, atol=0)
    assert (ours < 100.0).sum() >= 8  # rays that hit a triangle within k records


@pytest.mark.parametrize("n_tbl,vmem", [(0, False), (6, False), (6, True)])
def test_smem_tables_plain_matches_tpu_kernel(x5, n_tbl, vmem):
    import jax.numpy as jnp

    tbls = [jnp.ones(s, jnp.float32) for s in smt.TABLE_SHAPES]
    vt = jnp.ones(smt.VMEM_SHAPE, jnp.float32)
    x = jnp.ones((smt.ROWS * smt.BLOCKS, smt.LANES), jnp.float32)
    with pallas_interpret():
        ref = np.asarray(x5["run"](tbls, vt, x, n_tbl=n_tbl, vmem_tbl=vmem))
    name = {0: "no_tables", 6: "six_tables"}[n_tbl] + ("_vmem" if vmem else "")
    xp, tables, threads = smt.configurations("cpu")[name]
    assert threads == 1024 and len(tables) == n_tbl + vmem
    np.testing.assert_array_equal(smt.smem_tables(xp, tables, threads).numpy(), ref)


@pytest.mark.parametrize("n_tbl,vmem", [(0, False), (6, False), (6, True)])
def test_smem_tables_check_inputs(x5, n_tbl, vmem):
    """On the seeded check inputs the TPU kernel and the plain version agree
    bit for bit and the tables' sum moves the output; the plain version's
    staged rows are each block's copy of the tables' staged columns."""
    import jax.numpy as jnp

    name = {0: "no_tables", 6: "six_tables"}[n_tbl] + ("_vmem" if vmem else "")
    x, tables, threads = smt.check_configurations("cpu")[name]
    small = [jnp.asarray(t.numpy()) for t, _ in tables[:6]] or [
        jnp.ones(s, jnp.float32) for s in smt.TABLE_SHAPES]
    vt = jnp.asarray(tables[6][0].numpy()) if vmem else jnp.ones(smt.VMEM_SHAPE, jnp.float32)
    with pallas_interpret():
        ref = np.asarray(x5["run"](small, vt, jnp.asarray(x.numpy()), n_tbl=n_tbl,
                                   vmem_tbl=vmem))
    o, staged = smt.smem_tables(x, tables, threads, staged=True)
    np.testing.assert_array_equal(o.numpy(), ref)
    assert float((o != x).float().mean()) > (0.99 if n_tbl else -1.0)
    want = torch.cat([t[:, :c].reshape(-1) for t, c in tables]) if tables else torch.zeros(0)
    assert staged.shape == (smt.BLOCKS, want.numel()) and bool((staged == want).all())


def test_smem_tables_k1_box_configuration():
    x, tables, threads = smt.k1_box_tables("cpu")
    assert x.numel() == smt.K1_RAYS and threads == 256 and len(tables) >= 4
    assert tables[0][1] == 28  # the pair record's used columns
    o = smt.smem_tables(x[:4096], tables, threads)
    acc = sum(float(t[0, 0]) for t, _ in tables)
    assert torch.allclose(o, 1.0 + torch.tensor(acc * 1e-9, dtype=torch.float32))


@pytest.mark.parametrize("blocks", [1, 132, 1056, 16384])
def test_smem_tables_blocks_give_one_staged_row_each(blocks):
    """The plain X5 at any launch shape: the output is the one of K1's shape
    and each launched block has its staged row."""
    x, tables, threads = smt.check_configurations("cpu")["k1_box_tables"]
    x = x[:1_000_003]  # a ragged last tile
    o, staged = smt.smem_tables(x, tables, threads, staged=True, blocks=blocks)
    o1, staged1 = smt.smem_tables(x, tables, threads, staged=True)
    assert torch.equal(o, o1) and staged1.shape[0] == smt.k1_blocks(x.numel(), threads)
    assert staged.shape == (blocks, smt.table_bytes(tables) // 4)
    assert bool((staged == staged1[0]).all())


@pytest.mark.parametrize("n", [1056 * 256 * 4, 4_194_304, 4_194_304 - 5, 1_000_003, 100])
@pytest.mark.parametrize("blocks", [1056, 132])
def test_block_tiles_cover_every_ray_once(n, blocks):
    """The persistent walk (block b takes tiles b, b + blocks, ...) covers
    each ray exactly once, at tile multiples and with a ragged last tile."""
    tile = smt.K1_THREADS
    count = np.zeros(n, np.int32)
    walk = smt.block_tiles(n, tile, blocks)
    assert len(walk) == blocks
    for b, tiles in enumerate(walk):
        assert all(t % blocks == b for t in tiles)
        for t in tiles:
            count[t * tile:min(n, (t + 1) * tile)] += 1
    assert (count == 1).all()
    # K1's shape: one block per tile, each with at most one tile.
    k1 = smt.block_tiles(n, tile, smt.k1_blocks(n, tile))
    assert [list(t) for t in k1] == [[b] for b in range(len(k1))]


def test_smem_tables_refuses_what_the_kernel_does_not_take():
    x, tables, threads = smt.configurations("cpu")["six_tables"]
    with pytest.raises(ValueError, match="staging"):
        smt.smem_tables(x, tables, threads, staging="tma")
    with pytest.raises(ValueError, match="threads"):
        smt.smem_tables(x, tables, 100)
    with pytest.raises(ValueError, match="blocks"):
        smt.smem_tables(x, tables, threads, blocks=0)
    with pytest.raises(ValueError, match="no card"):
        smt.resident_blocks(x, tables, threads)


@pytest.fixture(scope="module")
def x2():
    return load_experiment("microbench_cond_fat")


@pytest.fixture(scope="module")
def x4():
    return load_experiment("exp_dot_formulations")


# X2 against the script's kernel: iterations of the comparisons.
X2_ITERS = 4


def _x2_counted(x2, x, n_iter, n_live):
    """The script's kernel (`make_kernel` with use_cond) in its grid of 64
    tiles, interpret mode, with a lax.cond that also adds its predicate to
    a second output: (o [512, 128], taken [64])."""
    jax, jnp, pl, pltpu = x2["jax"], x2["jnp"], x2["pl"], x2["pltpu"]
    counts = []

    def cond(pred, taken, skipped, y):
        counts[-1][...] += jnp.where(pred, 1.0, 0.0).astype(jnp.float32)
        return jax.lax.cond(pred, taken, skipped, y)

    lax = types.SimpleNamespace(cond=cond, fori_loop=jax.lax.fori_loop)
    make_kernel = types.FunctionType(x2["make_kernel"].__code__,
                                     {**x2, "jax": types.SimpleNamespace(lax=lax)})
    inner = make_kernel(n_iter, n_live, cf.K_CONDS, True)

    def kernel(x_ref, o_ref, c_ref):
        c_ref[...] = jnp.zeros_like(c_ref)
        counts.append(c_ref)
        inner(x_ref, o_ref)

    spec = pl.BlockSpec((cf.ROWS, cf.LANES), lambda i: (i, 0), memory_space=pltpu.VMEM)
    shape = jax.ShapeDtypeStruct((cf.ROWS * cf.BLOCKS, cf.LANES), jnp.float32)
    with pallas_interpret():
        o, c = pl.pallas_call(kernel, grid=(cf.BLOCKS,), in_specs=[spec], out_specs=[spec, spec],
                              out_shape=[shape, shape])(jnp.asarray(x))
    return np.asarray(o), np.asarray(c).reshape(cf.BLOCKS, -1)[:, 0].astype(np.int32)


@pytest.fixture(scope="module")
def x2_counted(x2):
    x = cf.check_inputs()
    return {n: _x2_counted(x2, x, X2_ITERS, n) for n in cf.SWEEP_LIVE}


def _x2_run(x2, x, n_iter, n_live, use_cond):
    import jax.numpy as jnp

    with pallas_interpret():
        return np.asarray(x2["run"](jnp.asarray(x), n_iter=n_iter, n_live=n_live,
                                    k_conds=cf.K_CONDS, use_cond=use_cond))


def test_x2_x4_loaders_run_no_sweep(x2, x4):
    assert (x2["ROWS"], x2["LANES"], x2["BLOCKS"]) == (cf.ROWS, cf.LANES, cf.BLOCKS)
    assert callable(x2["make_kernel"]) and "x" not in x2
    assert callable(x4["run"]) and callable(x4["kernel"]) and "B" not in x4 and "rng" not in x4


@pytest.mark.parametrize("n_live", cf.SWEEP_LIVE)
@pytest.mark.parametrize("use_cond", cf.SWEEP_COND)
def test_cond_fat_plain_matches_tpu_kernel(x2, n_live, use_cond):
    """On the script's input (x = 0.5, every tile takes every update)."""
    x = cf.script_inputs()
    ref = _x2_run(x2, x, X2_ITERS, n_live, use_cond)
    ours, taken = cf.cond_fat(torch.from_numpy(x), X2_ITERS, n_live, use_cond, taken=True)
    assert ours.shape == (cf.ROWS * cf.BLOCKS, cf.LANES)
    np.testing.assert_allclose(ours.numpy(), ref, rtol=1e-6, atol=0)
    assert (taken.numpy() == cf.K_CONDS * X2_ITERS).all()


@pytest.mark.parametrize("n_live", cf.SWEEP_LIVE)
@pytest.mark.parametrize("use_cond", cf.SWEEP_COND)
def test_cond_fat_check_inputs_match_tpu_kernel(x2, x2_counted, n_live, use_cond):
    """On the check inputs: outputs within rtol 1e-6 and the update counts
    equal to the script kernel's (with the predicate) or to 8 per iteration
    (inline); tiles that take and tiles that skip the updates, and tiles
    whose output moves with them (zeros: ~1e-17)."""
    x = cf.check_inputs()
    if use_cond:
        ref, ref_taken = x2_counted[n_live]
    else:
        ref = _x2_run(x2, x, X2_ITERS, n_live, False)
        ref_taken = np.full(cf.BLOCKS, cf.K_CONDS * X2_ITERS, np.int32)
    ours, taken = cf.cond_fat(torch.from_numpy(x), X2_ITERS, n_live, use_cond, taken=True)
    np.testing.assert_allclose(ours.numpy(), ref, rtol=1e-6, atol=0)
    np.testing.assert_array_equal(taken.numpy(), ref_taken)
    np.testing.assert_array_equal(ref_taken, cf.expected_taken(x, X2_ITERS, use_cond))
    if use_cond:
        assert 0 < int((ref_taken > 0).sum()) < cf.BLOCKS
    zeros = ours.numpy().reshape(cf.BLOCKS, -1)[0::8]
    assert (zeros > 1e-18).all() and (zeros < 1e-15).all()


def test_cond_fat_counted_kernel_is_the_scripts(x2, x2_counted):
    """The counting cond adds an output and changes nothing else."""
    ref = _x2_run(x2, cf.check_inputs(), X2_ITERS, 2, True)
    np.testing.assert_array_equal(x2_counted[2][0], ref)


def test_cond_fat_check_fails_without_the_conds(x2_counted):
    """A version with the predicate removed passes on the script's input
    and gives the same output on the tiles of -2 (their updates are below
    float32 resolution), but the update counts of the check inputs
    catch it."""
    x = torch.from_numpy(cf.check_inputs())
    ref, ref_taken = x2_counted[2]
    broken, taken = cf.cond_fat_reference(x, X2_ITERS, 2, False, taken=True)
    minus2 = np.arange(cf.BLOCKS) % 8 == 1
    tiles = broken.numpy().reshape(cf.BLOCKS, -1)
    np.testing.assert_array_equal(tiles[minus2], ref.reshape(cf.BLOCKS, -1)[minus2])
    assert not np.array_equal(taken.numpy(), ref_taken)


def _x4_run(x4, seed):
    b, a, e = df.script_inputs(seed)
    with pallas_interpret():
        c, r, x = map(np.asarray, x4["run"](b, a, e))
    return (b, a, e), (c, r, x)


@pytest.mark.parametrize("seed", [0, 1])
@pytest.mark.parametrize("form", df.FORMS)
def test_dot_formulation_plain_matches_tpu_kernel(x4, seed, form):
    (b, a, e), (c_ref, r_ref, x_ref) = _x4_run(x4, seed)
    bt, at, et = map(torch.from_numpy, (b, a, e))
    c, r, x = df.dot_formulation(form, bt, at, et)
    assert c.shape == (8, 512, 128) and r.shape == (8, 128) and x.shape == (8, 16, 128)
    tol = 1e-3 if form == "tf32" else df.TOL_REL
    err = np.abs(c.numpy().astype(np.float64) - c_ref) / df.magnitude(bt, at).numpy()
    assert err.max() <= tol, err.max()
    assert df.self_check(c, r, x, et)
    # The script's own R and X are the min and first argmin of its C.
    rj, xj = df.extract(torch.from_numpy(c_ref.copy()), et)
    np.testing.assert_array_equal(r_ref, rj.numpy())
    np.testing.assert_array_equal(x_ref, xj.numpy())
    errs = df.script_errors(bt, at, et, c, r, x)
    if form == "tf32":
        assert errs["matmul_rel_err"] < 1e-3, errs  # reported, not held to float32
    else:
        np.testing.assert_array_equal(x.numpy(), x_ref)
        assert errs["matmul_rel_err"] < 1e-6 and errs["reduce_err"] < 1e-4, errs
        assert errs["extract_err"] == 0.0, errs


def test_dot_check_fails_a_first_zero_extraction():
    """An extraction that always takes row 0 fails the check: the seeded
    normals put the minimum of almost every column elsewhere."""
    b, a, e = map(torch.from_numpy, df.script_inputs(0))
    c, r, x = df.dot_formulation("fma", b, a, e)
    wrong = e[:, :1].expand(16, 128)[None].expand(8, 16, 128).contiguous()
    assert df.self_check(c, r, x, e) and not df.self_check(c, r, wrong, e)
    assert df.script_errors(b, a, e, c, r, wrong)["extract_err"] > 1.0


@pytest.fixture(scope="module")
def x4_ties(x4):
    b, a, e = df.tie_inputs()
    with pallas_interpret():
        c, r, x = map(np.asarray, x4["run"](b, a, e))
    return (b, a, e), (c, r, x)


@pytest.mark.parametrize("form", df.FORMS)
def test_dot_tie_inputs_take_the_first_row(x4_ties, form):
    """On the tie inputs each column's minimum sits in two rows (-0.0 and
    +0.0; equal negatives in other warps and in one thread of the kernel):
    the plain version, like the TPU kernel, takes the first."""
    (b, a, e), (c_ref, r_ref, x_ref) = x4_ties
    bt, at, et = map(torch.from_numpy, (b, a, e))
    c, r, x = df.dot_formulation(form, bt, at, et)
    assert df.ties_hold(r, x, et) and df.self_check(c, r, x, et)
    assert df.ties_hold(torch.tensor(r_ref), torch.tensor(x_ref), et)
    for col, (_, rows, value) in df.TIES.items():
        assert (c[:, list(rows), col] == value).all()
        assert (c[:, :df.Q_MIN, col] == value).sum() == 2 * df.J
    # Taking the last of the two rows fails the check.
    wrong = x.clone()
    wrong[:, :, 5] = et[:, df.TIES[5][1][1]]
    assert not df.ties_hold(r, wrong, et) and not df.self_check(c, r, wrong, et)


def test_extract_takes_the_first_of_signed_zeros():
    """-0.0 and +0.0 are one value: the first row holding either wins."""
    c = torch.ones((df.J, df.Q, df.R_COLS))
    c[:, 3, 7], c[:, 70, 7] = -0.0, 0.0
    c[:, 9, 8], c[:, 2, 8] = 0.0, -0.0
    e = torch.arange(df.K * df.R_COLS, dtype=torch.float32).reshape(df.K, df.R_COLS)
    r, x = df.extract(c, e)
    assert (r[:, 7] == 0.0).all() and (r[:, 8] == 0.0).all()
    assert (x[:, :, 7] == e[:, 3]).all() and (x[:, :, 8] == e[:, 2]).all()


def test_tf32_round_matches_the_conversion():
    """cvt.rna.tf32.f32: 10 mantissa bits, to nearest, ties away from zero."""
    ulp = 2.0 ** -10
    x = torch.tensor([1.0, 1.0 + ulp / 2, -(1.0 + ulp / 2), 1.0 + ulp / 2 - 2 ** -23,
                      1.0 + 3 * ulp / 2, 3.0e-3], dtype=torch.float32)
    want = [1.0, 1.0 + ulp, -(1.0 + ulp), 1.0, 1.0 + 2 * ulp]
    np.testing.assert_array_equal(df.tf32_round(x)[:5].numpy(), np.float32(want))
    r = df.tf32_round(x[5:]).view(torch.int32)
    assert int(r) & 0x1FFF == 0 and abs(float(df.tf32_round(x[5:])) - 3.0e-3) <= 3.0e-3 * 2 ** -11


def test_wrappers_refuse_devices_without_a_kernel():
    meta = torch.zeros((16 * 64, 128), device="meta")
    with pytest.raises(ValueError, match="no kernel"):
        ss.supscan(torch.zeros((4, 8), device="meta"), meta, 1, 8)
    with pytest.raises(ValueError, match="no kernel"):
        rv.record_variant("outer", meta, torch.zeros((6, 1024), device="meta"), 1)
    with pytest.raises(ValueError, match="no kernel"):
        smt.smem_tables(meta, [], 1024)
    with pytest.raises(ValueError, match="no kernel"):
        cf.cond_fat(torch.zeros((512, 128), device="meta"), 1, 2, True)
    with pytest.raises(ValueError, match="no kernel"):
        df.dot_formulation("fma", torch.zeros((16, 512), device="meta"),
                           torch.zeros((8, 16, 128), device="meta"),
                           torch.zeros((16, 128), device="meta"))
