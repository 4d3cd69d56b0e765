"""The port's sharded renders (cpupathtrace_tpu_torch/parallel/: mesh,
render, train, distributed) on gloo ranks on the CPU, against the JAX
package's parallel/ and the port's own serial oracle.

Host helpers are held to JAX's exactly, live: the mesh shape, the adaptive
sample axis, the rows a rank renders, the pixel grid. One world of 4 gloo
ranks (tests/torch_util.py `parallel_ranks`) renders the box at (dp, sp) =
(2, 1), (1, 2), (2, 2) and (1, 4) and adaptively at (2, 1): each equals
the serial oracle (the same shards with the same `shard_seed` generators,
summed in one process) bit for bit where sp <= 2, and within float32
rounding of the order of four additions at sp = 4. Its frames' mean is
within 4 standard errors of JAX's sharded frames (fixture
tests/fixtures/torch_parallel.npz, make_torch_parallel_fixtures.py), the
standard error from each pixel's variance across the frames. The
training step's loss and gradient at (1, 2) and (2, 1) equal the serial
oracle's; three steps lower the loss.
"""
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from cpupathtrace_tpu_torch.integrator.film import render_chunk, render_chunk_batched, render_tile
from cpupathtrace_tpu_torch.integrator.rng import chunk_seed, shard_seed
from cpupathtrace_tpu_torch.parallel import render as pr
from cpupathtrace_tpu_torch.parallel import train as ptr
from cpupathtrace_tpu_torch.parallel.distributed import host_local_rows, spawn_ranks
from cpupathtrace_tpu_torch.parallel.mesh import mesh_shape
from tests.torch_util import (
    CPU,
    GATHER_H,
    PAR_ADAPTIVE,
    PAR_FIXED,
    PAR_SEED,
    TRAIN_KEY,
    TRAIN_SPP,
    inverse_setup,
    par_box,
    par_options,
    parallel_ranks,
)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FIXTURE = os.path.join(ROOT, "tests", "fixtures", "torch_parallel.npz")
# float32 sums of four terms in another order: a few ulps of the sum.
SP4_RTOL = 4 * 2.0 ** -23
# Gradients summed over ranks against one autograd pass over all shards.
GRAD_ATOL, GRAD_RTOL = 1e-6, 1e-5


def _fixture():
    from tests.fixtures.make_torch_parallel_fixtures import (
        ADAPTIVE_OPTIONS, FIXED_OPTIONS, FRAMES)

    return np.load(FIXTURE), FIXED_OPTIONS, ADAPTIVE_OPTIONS, FRAMES


@pytest.fixture(scope="module")
def ranks():
    _, fixed, adaptive, frames = _fixture()
    return spawn_ranks(parallel_ranks, 4, "gloo", args=(fixed, adaptive, frames),
                       deadline_s=240, timeout_s=60)


# ---------------------------------------------------------------------------
# Host helpers against JAX, live.
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("n", range(1, 17))
@pytest.mark.parametrize("sample_axis", [None, 1, 2, 4])
def test_mesh_shape_matches_jax(monkeypatch, n, sample_axis):
    """make_render_mesh's (dp, sp) is JAX's for 1-16 devices (JAX's Mesh
    is replaced by its shape, so counts past the 8 virtual devices run)."""
    from cpupathtrace_tpu.parallel import mesh as jmesh

    monkeypatch.setattr(jmesh, "Mesh", lambda devices, names: devices.shape)
    try:
        want = jmesh.make_render_mesh(np.arange(n), sample_axis=sample_axis)
    except ValueError as e:
        with pytest.raises(ValueError, match="not divisible"):
            mesh_shape(n, sample_axis)
        assert "not divisible" in str(e)
        return
    assert mesh_shape(n, sample_axis) == want


@pytest.mark.parametrize("opts", [(16, 16, 16, 64, 8), (16, 16, 8, 16, 8), (8, 8, 4, 4, 4),
                                  (8, 8, 2, 10, 4), (8, 8, 16, 18, 4), (8, 8, 1, 1, 4)])
def test_adaptive_sample_axis_matches_jax(opts):
    import cpupathtrace_tpu as ptx
    from cpupathtrace_tpu.parallel.render import adaptive_sample_axis

    w, h, lo, hi, depth = opts
    jo = ptx.RenderOptions(w, h, lo, hi, max_depth=depth)
    for n in range(1, 17):
        assert pr.adaptive_sample_axis(par_options(opts), n) == adaptive_sample_axis(jo, n), n


@pytest.mark.parametrize("height", [13, 16, 1])
def test_host_local_rows_match_jax(monkeypatch, height):
    import jax

    from cpupathtrace_tpu.parallel.distributed import host_local_rows as jrows

    for p in range(1, 5):
        for i in range(p):
            monkeypatch.setattr(jax, "process_count", lambda p=p: p)
            monkeypatch.setattr(jax, "process_index", lambda i=i: i)
            assert host_local_rows(height, i, p) == jrows(height), (p, i)


@pytest.mark.parametrize("dp", [1, 2, 3, 4, 5])
def test_pixel_grid_matches_jax(dp):
    import cpupathtrace_tpu as ptx
    from cpupathtrace_tpu.parallel.train import pixel_grid as jgrid

    jx, jy = jgrid(ptx.RenderOptions(16, 13, 4, 4), dp)
    x, y = ptr.pixel_grid(par_options((16, 13, 4, 4, 6)), dp, device=CPU)
    np.testing.assert_array_equal(x.numpy(), np.asarray(jx))
    np.testing.assert_array_equal(y.numpy(), np.asarray(jy))


def test_shard_seed_folds_twice_and_separates_shards():
    seeds = {(s, a, b): shard_seed(s, a, b) for s in (0, 7, 2**40 + 3)
             for a in range(8) for b in range(8)}
    assert len(set(seeds.values())) == len(seeds)
    assert all(0 <= v < 2**64 for v in seeds.values())
    assert shard_seed(7, 2, 3) == chunk_seed(chunk_seed(7, 2), 3) == shard_seed(7, 2, 3)


def test_image_normalises_as_float64_division_rounded():
    """render.py's `_image` divides on the tensors' device in float32; that
    equals the float64 division rounded to float32 (the host's numpy
    formula) bit for bit, signed zeros and unlit pixels included."""
    rng = np.random.default_rng(0)
    n = 200_000
    s = (rng.standard_normal((n, 4)) * rng.uniform(0, 300, (n, 1))).astype(np.float32)
    s[:7] = -0.0
    c = rng.integers(0, 300, n).astype(np.int32)
    ref = np.where(c[:, None] > 0, s / np.maximum(c, 1)[:, None], 0.0).astype(np.float32)
    img = pr._image(torch.from_numpy(s), torch.from_numpy(c), n - 100, 100, 1999)
    assert img.dtype == np.float32 and img.shape == (100, 1999, 4)
    np.testing.assert_array_equal(img.reshape(-1, 4).view(np.uint32),
                                  ref[:n - 100].view(np.uint32))


def test_render_tile_chunk_fns_default_is_bit_equal():
    """render_tile with chunk_fns set to its own default renderers equals
    render_tile without them (an adaptive tile, so both are called)."""
    box, cam = par_box()
    opts = par_options(PAR_ADAPTIVE)
    x, y, _ = pr.pixel_coords(opts, 1, CPU)

    def single(g, spp):
        return render_chunk(box, cam, opts, x, y, g, spp)

    def batched(g, spp, kb):
        return render_chunk_batched(box, cam, opts, x, y, g, spp, kb)

    out = []
    for fns in (None, (single, batched)):
        g = torch.Generator()
        g.manual_seed(4)
        out.append(render_tile(box, cam, opts, x, y, g, chunk_fns=fns).numpy())
    np.testing.assert_array_equal(out[0], out[1])
    assert out[0][:, :3].mean() > 0.005


# ---------------------------------------------------------------------------
# The world of 4 gloo ranks.
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("shape", [(2, 1), (1, 2), (2, 2)])
def test_sharded_equals_serial_oracle(ranks, shape):
    box, cam = par_box()
    ref = pr.render_serial(box, cam, par_options(PAR_FIXED), shape, seed=PAR_SEED)
    members = [r for r in ranks if shape in r["fixed"]]
    assert len(members) == shape[0] * shape[1]
    for r in members:
        np.testing.assert_array_equal(r["fixed"][shape], ref)
        assert r["k1_twin_calls"][shape] == 1  # each shard's one chunk through K1's twin
    assert ref[..., 3].mean() == 1.0 and ref[..., :3].mean() > 0.005


def test_sharded_sp4_within_rounding_of_the_oracle(ranks):
    """(1, 4): the all_reduce adds four shards in its own order."""
    box, cam = par_box()
    ref = pr.render_serial(box, cam, par_options(PAR_FIXED), (1, 4), seed=PAR_SEED)
    for r in ranks:
        np.testing.assert_allclose(r["fixed"][(1, 4)], ref, rtol=SP4_RTOL, atol=0)
        np.testing.assert_array_equal(r["fixed"][(1, 4)], ranks[0]["fixed"][(1, 4)])


def test_adaptive_sharded_equals_serial_oracle(ranks):
    box, cam = par_box()
    ref = pr.render_serial_adaptive(box, cam, par_options(PAR_ADAPTIVE), (2, 1), seed=3)
    for r in ranks[:2]:
        np.testing.assert_array_equal(r["adaptive"], ref)
    assert ref[..., 3].mean() == 1.0


def _frame_mean_se(frames):
    """Mean of the frames' RGB and its standard error, from each pixel's
    variance across the frames."""
    rgb = frames[..., :3].mean(-1).reshape(frames.shape[0], -1).astype(np.float64)
    f, n = rgb.shape
    return rgb.mean(), np.sqrt(rgb.var(0, ddof=1).sum() / f) / n


@pytest.mark.parametrize("kind", ["fixed", "adaptive"])
def test_frame_mean_within_4se_of_jax(ranks, kind):
    z, *_ = _fixture()
    jax_frames = z[kind]
    ours = ranks[0][f"stat_{kind}"]
    assert ours.shape == jax_frames.shape
    m_a, se_a = _frame_mean_se(ours)
    m_b, se_b = _frame_mean_se(jax_frames)
    se = np.hypot(se_a, se_b)
    assert se > 0 and abs(m_a - m_b) < 4 * se, (m_a, m_b, se)
    np.testing.assert_array_equal(ours[..., 3], jax_frames[..., 3])  # coverage
    for r in ranks[1:]:
        np.testing.assert_array_equal(r[f"stat_{kind}"], ours)


def test_divisibility_errors_are_jax(ranks):
    for r in ranks:
        e = r["errors"]
        assert "pixel count 207 not divisible by dp=2" in e["pixels"]
        assert "spp 3 not divisible by sp=2" in e["spp"]
        assert "stats batch size 3 not divisible by sp=2" in e["stats"]
        assert "not divisible by the sample-parallel axis sp=2" in e["adaptive"]


@pytest.mark.parametrize("p", [2, 3])
def test_gather_image_pads_and_trims(ranks, p):
    rows = np.arange(GATHER_H * 5 * 4, dtype=np.float32).reshape(GATHER_H, 5, 4) + 0.5
    spans = []
    for r in ranks[:p]:
        span, full, full_np = r["gather"][p]
        spans.append(span)
        np.testing.assert_array_equal(full, rows)
        np.testing.assert_array_equal(full_np, rows)
    assert spans[0][0] == 0 and spans[-1][1] == GATHER_H
    assert all(a[1] == b[0] for a, b in zip(spans, spans[1:]))
    assert all(p not in r["gather"] for r in ranks[p:])


@pytest.mark.parametrize("shape", [(1, 2), (2, 1)])
def test_train_gradient_equals_serial_oracle(ranks, shape):
    """The loss and gradient of the sharded step equal the serial oracle's
    (one autograd pass over every shard): the sp axis is counted once."""
    scene, cam, opts, target, init = inverse_setup()
    x, y = ptr.pixel_grid(opts, shape[0], device=CPU)
    leaves = {k: v.clone().requires_grad_(True) for k, v in init.items()}
    loss = ptr.serial_image_loss(leaves, scene, cam, opts, shape, target, x, y, TRAIN_KEY,
                                 TRAIN_SPP)
    loss.backward()
    for r in ranks[:2]:
        got_loss, grads = r["train"][shape]
        assert got_loss == float(loss.detach())
        for k, v in leaves.items():
            np.testing.assert_allclose(grads[k], v.grad.numpy(), rtol=GRAD_RTOL, atol=GRAD_ATOL)
    assert float(leaves["mat_diffuse"].grad.abs().max()) > 1e-4


def test_train_steps_lower_the_loss(ranks):
    for r in ranks[:2]:
        losses, low = r["steps"]
        assert all(b < a for a, b in zip(losses, losses[1:])) and low >= 0.0, losses
        assert r["steps"] == ranks[0]["steps"]


def test_scaling_harness_writes_only_its_out(tmp_path):
    """experiments/bench_scaling.py at a tiny size on CPU gloo ranks: one
    JSON line, written to --out only, the rows of 2 ranks labelled
    shared and their collectives counted."""
    import json

    out = tmp_path / "scaling.json"
    before = os.path.getmtime(os.path.join(ROOT, "EFFICIENCY.json"))
    res = subprocess.run(
        [sys.executable, "-m", "cpupathtrace_tpu_torch.experiments.bench_scaling", "--out",
         str(out), "--device", "cpu", "--ranks", "1,2", "--tile", "8", "--spp", "2",
         "--max-depth", "4", "--iters", "1"],
        cwd=ROOT, capture_output=True, text=True, timeout=180)
    assert res.returncode == 0, res.stderr
    line = json.loads(res.stdout.strip().splitlines()[-1])
    assert json.loads(out.read_text()) == line
    assert line["rows"]["2"]["label"] == "shared" and line["rows"]["1"]["label"] == "scaling"
    assert line["rows"]["2"]["collectives_per_chunk"]["calls"] == 1
    assert line["rows"]["2"]["collectives_per_chunk"]["bytes"] == 8 * 16 * 5 * 4
    assert line["comm_model_1080p"]["dp2xsp1"]["dp_gather_bytes_per_chunk"] == 1920 * 1080 * 20
    assert os.path.getmtime(os.path.join(ROOT, "EFFICIENCY.json")) == before
