"""The CUDA ports of the TPU microbenchmarks X1, X3, X5
(cpupathtrace_tpu_torch/experiments/): each plain-torch version against the
TPU script's own kernel in Pallas interpret mode, on the script's inputs,
at small iteration counts. The scripts run their sweeps when imported, so
tests/torch_util.py:load_experiment executes only their imports, constants
and function definitions. Bounds: X1 and X5 equal bit for bit (their
outputs are x plus a count or a sum of table entries); X3 within rtol 1e-5
(the same float32 formulas; XLA:CPU may fuse products into FMAs, the plain
version does not, and the matmul variants sum the product in another
order). The kernels are held against the plain versions on the card by
tests/test_torch_cuda.py and chip_smoke.py.
"""
import functools

import numpy as np
import pytest
import torch

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


def test_wrappers_refuse_devices_without_a_kernel():
    meta = torch.zeros((16 * 64, 128), device="meta")
    with pytest.raises(ValueError, match="no kernel"):
        ss.supscan(torch.zeros((4, 8), device="meta"), meta, 1, 8)
    with pytest.raises(ValueError, match="no kernel"):
        rv.record_variant("outer", meta, torch.zeros((6, 1024), device="meta"), 1)
    with pytest.raises(ValueError, match="no kernel"):
        smt.smem_tables(meta, [], 1024)
