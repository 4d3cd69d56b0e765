"""The port's benchmark runner (cpupathtrace_tpu_torch/bench.py) against the
JAX package's bench.py, on the CPU at small sizes: its frames are
render_chunk's, its lines carry bench.py's keys and metric names (read from
bench.py's syntax tree, so JAX never runs), its parity gate passes on the
plain versions and fails when a tracer or the binned query is broken, its
rooflines are the roofline module's on the frame's own counters, and
without a card it refuses to start."""
import argparse
import ast
import json
import os

import numpy as np
import pytest
import torch

from cpupathtrace_tpu_torch import bench
from cpupathtrace_tpu_torch.camera.camera import shoot_rays
from cpupathtrace_tpu_torch.core.config import RenderOptions
from cpupathtrace_tpu_torch.integrator import film
from cpupathtrace_tpu_torch.integrator import sorted_wavefront as sw
from cpupathtrace_tpu_torch.integrator.rng import chunk_seed
from cpupathtrace_tpu_torch.models.scenes import bench_box_scene, bench_camera, bench_dragon_scene
from cpupathtrace_tpu_torch.utils.roofline import dense_frame_roofline, frame_bound
from tests.torch_util import CPU

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
# bench.py's lines that compare with its TPU rounds; the port leaves them out.
TPU_ROUND_KEYS = {"vs_best_round", "regression_suspected"}
DRAGON_TRIS = 3000
SMALL = bench.Sizes(
    box_size=8, box_spp=4, box_spp_chunk=2, box_frames_per_batch=2, dragon_size=8,
    dragon_spp=2, dragon_tris=DRAGON_TRIS, dragon_full_tris=DRAGON_TRIS, max_depth=3, batches=2,
    frames_per_batch=2, grad_size=8, grad_spp=2, grad_max_depth=3, grad_passes=2, grad_warm=1,
    verify_binned_tris=DRAGON_TRIS, verify_binned_rays=1024, verify_tracer_rays=16384,
    verify_seeds=8, verify_max_depth=3)
VERIFY = dict(binned_tris=SMALL.verify_binned_tris, binned_rays=SMALL.verify_binned_rays,
              tracer_rays=SMALL.verify_tracer_rays, n_seeds=SMALL.verify_seeds,
              max_depth=SMALL.verify_max_depth, device=CPU)


@pytest.fixture(scope="module")
def dragon():
    return bench_dragon_scene(dragon_tris=DRAGON_TRIS, accel="binned", device=CPU)


@pytest.fixture(scope="module")
def bench_py():
    with open(os.path.join(ROOT, "bench.py")) as f:
        return ast.parse(f.read())


def _function(tree, name):
    return next(n for n in ast.walk(tree) if isinstance(n, ast.FunctionDef) and n.name == name)


def _keys_of(fn):
    """The keys a bench.py function puts in its result: the `res` dict
    literal's and those set by `res["key"] = ...`."""
    keys = set()
    for node in ast.walk(fn):
        if isinstance(node, ast.Assign):
            for target in node.targets:
                if isinstance(target, ast.Name) and target.id == "res" and isinstance(
                        node.value, ast.Dict):
                    keys |= {k.value for k in node.value.keys}
                if (isinstance(target, ast.Subscript) and isinstance(target.value, ast.Name)
                        and target.value.id == "res" and isinstance(target.slice, ast.Constant)):
                    keys.add(target.slice.value)
    return keys


def _literal(fn, key):
    """The constant a bench.py function's dict literal holds under `key`."""
    return next(v.value for n in ast.walk(fn) if isinstance(n, ast.Dict)
                for k, v in zip(n.keys, n.values) if k.value == key)


def _workload_names(tree):
    """The names bench.py passes to run_workload."""
    return {n.args[0].value for n in ast.walk(tree)
            if isinstance(n, ast.Call) and getattr(n.func, "id", "") == "run_workload"}


def _lines(out):
    return [json.loads(s) for s in out.splitlines() if s.startswith("{")]


def _options(size, spp):
    return RenderOptions(size, size, spp, spp, epsilon=1e-3, max_depth=3)


@pytest.mark.parametrize("pixel_order", [False, True])
def test_frame_is_render_chunk_summed_by_hand(dragon, pixel_order):
    """(a) A frame is bit for bit its chunks through render_chunk, chunk c of
    seed s drawing from a generator seeded with chunk_seed(s, c), with the
    pixels in Morton order or not."""
    size, chunk, n_chunks, seed = 8, 2, 2, 5
    cam, opts = bench_camera(device=CPU), _options(size, chunk * n_chunks)
    frame = bench._frame_fn(dragon, cam, opts, size, size, chunk, n_chunks, CPU, pixel_order)
    total, count = frame(seed)

    xg, yg = np.meshgrid(np.arange(size, dtype=np.float32), np.arange(size, dtype=np.float32))
    x, y = (torch.from_numpy(np.ascontiguousarray(v, np.float32))
            for v in film.pixel_camera_coords(opts, xg.ravel(), yg.ravel()))
    perm = torch.from_numpy(film.morton_perm(xg.ravel(), yg.ravel())) if pixel_order else None
    want_t = torch.zeros((size * size, 4))
    want_c = torch.zeros(size * size, dtype=torch.int32)
    for c in range(n_chunks):
        gen = torch.Generator()
        gen.manual_seed(chunk_seed(seed, c))
        s, n = film.render_chunk(dragon, cam, opts, x, y, gen, chunk, pixel_order=perm)
        want_t, want_c = want_t + s, want_c + n
    assert torch.equal(total, want_t) and torch.equal(count, want_c)
    assert int(count.sum()) == size * size * chunk * n_chunks
    other = bench._frame_fn(dragon, cam, opts, size, size, chunk, n_chunks, CPU,
                            not pixel_order)(seed)[0]
    assert not torch.equal(total, other), "the pixel order changed nothing"


def test_workload_lines_carry_bench_py_keys(bench_py):
    """(b) run_workload and run_box_grad return bench.py's keys (its TPU-round
    comparison aside) and metric names."""
    want = _keys_of(_function(bench_py, "run_workload")) - TPU_ROUND_KEYS
    assert {"metric", "value", "unit", "vs_baseline", "best", "spread_pct",
            "batch_ms_per_frame", "frames_per_batch"} <= want
    scene = bench_box_scene(device=CPU)
    res = bench.run_workload("renderSceneBox", scene, bench_camera(device=CPU), _options(8, 4),
                             8, 8, 4, 2, bench.REFERENCE_CPU_BOX_MRAYS, batches=2,
                             frames_per_batch=2, device=CPU)
    assert want <= set(res) and res["first_frame_s"] > 0
    assert res["metric"] == "renderSceneBox_throughput" and res["unit"] == "Mrays/s"
    assert len(res["batch_ms_per_frame"]) == 2 and res["value"] > 0 and res["best"] >= res["value"]

    grad_fn = _function(bench_py, "run_box_grad")
    want = _keys_of(grad_fn) - TPU_ROUND_KEYS
    res = bench.run_box_grad(batches=2, frames_per_batch=2, size=8, spp=2, max_depth=3, warm=1,
                             device=CPU)
    assert want <= set(res), want - set(res)
    metric, note = (_literal(grad_fn, k) for k in ("metric", "note"))
    assert res["metric"] == metric == "renderSceneBoxGrad_throughput"
    assert res["note"] == note and res["value"] > 0


def test_main_prints_bench_py_lines_box_last(bench_py, tmp_path, capsys):
    """main() at small sizes on the CPU: rc 0, one line per workload with
    bench.py's metric names and keys, the box last, verified, each with a
    positive value and the dragons and the box with their rooflines; the
    7.2M workload's scene through the cache with bench.py's two extra keys
    (a miss, then a hit)."""
    names = _workload_names(bench_py)
    assert names == {"renderSceneDragonBoxFull", "renderSceneDragonBox", "renderSceneBox"}
    keys = _keys_of(_function(bench_py, "run_workload")) - TPU_ROUND_KEYS
    full_keys = _keys_of(_function(bench_py, "run_dragon_full"))
    assert full_keys == {"scene_build_s", "scene_cache_hit", "roofline"}
    assert _keys_of(_function(bench_py, "main")) == {"roofline", "parity_verified", "error",
                                                     "vs_baseline"}

    assert bench.main([], device=CPU, sizes=SMALL, cache_dir=str(tmp_path)) == 0
    lines = _lines(capsys.readouterr().out)
    assert [r["metric"] for r in lines] == [
        "renderSceneDragonBoxFull_throughput", "renderSceneDragonBox_throughput",
        "renderSceneBoxGrad_throughput", "renderSceneBox_throughput"]
    for r in lines:
        assert r["parity_verified"] is True and "error" not in r and r["value"] > 0, r
        assert r["device"] == "cpu"
        if r["metric"] != "renderSceneBoxGrad_throughput":
            assert keys <= set(r) and "roofline" in r, r
    assert full_keys <= set(lines[0]) and lines[0]["scene_cache_hit"] is False
    assert {"bound_ms", "ray_bounces", "frame_over_bound"} <= set(lines[1]["roofline"])
    assert {"executed_bounces", "fp32_frac", "hbm_frac"} <= set(lines[3]["roofline"])
    # The second run finds the scene in the cache.
    assert bench.main(["--no-verify", "--workloads", "dragonfull"], device=CPU, sizes=SMALL,
                      cache_dir=str(tmp_path)) == 0
    (again,) = _lines(capsys.readouterr().out)
    assert again["scene_cache_hit"] is True and "parity_verified" not in again
    assert len(os.listdir(tmp_path)) == 1


def test_verify_passes_on_the_plain_versions():
    """(c) The three checks hold at reduced sizes on the CPU's plain versions."""
    checks = bench.run_verify(**VERIFY)
    assert checks == dict.fromkeys(("binned_vs_sweep", "megakernel_vs_wavefront",
                                    "sorted_vs_megakernel", "coverage", "record_forward",
                                    "replay"), True)


def _zero_wavefront(scene, rays, options, generator=None, differentiable=False):
    n = rays.origin.shape[0]
    return torch.zeros((n, 4)), torch.zeros(n, dtype=torch.bool)


def _shift_one_hit(orig):
    """binned_intersect with its first hit moved to the next primitive, a
    little farther along the ray."""
    def shifted(scene, o, d, *args, **kwargs):
        t, p = orig(scene, o, d, *args, **kwargs)
        i = int(torch.nonzero(p >= 0)[0])
        t, p = t.clone(), p.clone()
        t[i], p[i] = t[i] * (1 + 1e-5), p[i] + 1
        return t, p
    # binned_intersect counts on the module's name, which now is this.
    shifted.host_reads = shifted.rounds = 0
    return shifted


@pytest.mark.parametrize("fault", ["wavefront_zeros", "binned_prim_shifted"])
def test_a_failed_verify_marks_every_line(fault, monkeypatch, capsys):
    """(c) A tracer returning zeros fails the wavefront's check, one shifted
    hit of the binned query fails the binned check; either way main() marks
    every line with the error, zeroes vs_baseline and returns 1."""
    from cpupathtrace_tpu_torch.accel import traverse
    from cpupathtrace_tpu_torch.integrator import wavefront

    if fault == "wavefront_zeros":
        monkeypatch.setattr(wavefront, "trace", _zero_wavefront)
        failing = {"megakernel_vs_wavefront"}
    else:
        monkeypatch.setattr(traverse, "binned_intersect",
                            _shift_one_hit(traverse.binned_intersect))
        failing = {"binned_vs_sweep"}
    seen = []
    run_verify = bench.run_verify
    monkeypatch.setattr(bench, "run_verify", lambda *a, **k: seen.append(run_verify(*a, **k))
                        or seen[-1])
    rc = bench.main(["--workloads", "box,boxgrad"], device=CPU, sizes=SMALL)
    assert len(seen) == 1 and {k for k, ok in seen[0].items() if not ok} == failing, seen
    captured = capsys.readouterr()
    lines = _lines(captured.out)
    assert rc == 1 and len(lines) == 2 and "verify: FAIL" in captured.err
    for r in lines:
        assert r["error"] == "on-chip parity verify FAILED" and r["vs_baseline"] == 0.0
        assert r["parity_verified"] is False


def test_a_failed_workload_fails_the_run_and_keeps_the_others(monkeypatch, capsys):
    def broken(*args, **kwargs):
        raise RuntimeError("launch failed")

    monkeypatch.setattr(bench, "run_box_grad", broken)
    assert bench.main(["--no-verify", "--workloads", "box,boxgrad"], device=CPU,
                      sizes=SMALL) == 1
    captured = capsys.readouterr()
    lines = _lines(captured.out)
    assert [r["metric"] for r in lines] == ["renderSceneBox_throughput"]
    assert "parity_verified" not in lines[0] and "boxgrad FAILED" in captured.err


def test_binned_roofline_is_frame_bound_on_the_frames_own_counters(dragon):
    """(d) The binned roofline is frame_bound over a debug_visits pass of
    the sorted driver on frame `seed`'s rays: the pass's sums are the
    timed frame's."""
    size, spp, seed = 8, 2, 1
    cam, opts = bench_camera(device=CPU), _options(size, spp)
    got = bench.roofline_binned(dragon, cam, opts, size, size, spp, frame_ms=5.0, seed=seed,
                                device=CPU)

    x, y = (torch.from_numpy(np.ascontiguousarray(v, np.float32)) for v in film.pixel_camera_coords(
        opts, *(g.ravel() for g in np.meshgrid(np.arange(size, dtype=np.float32),
                                               np.arange(size, dtype=np.float32)))))
    gen = torch.Generator()
    gen.manual_seed(chunk_seed(seed, 0))
    rays = shoot_rays(cam, x.repeat(spp), y.repeat(spp), 1.0 / size, 1.0 / size, gen)
    kseed = torch.randint(0, 2**31 - 1, (1,), generator=gen, dtype=torch.int32)
    spec, coll, vis = sw.trace_megakernel_sorted(dragon, rays, opts, kseed, debug_visits=True)
    want = frame_bound(vis, size * size * spp, dragon)
    assert want["ray_bounces"] > 0 and want["bound_ms"] > 0
    assert got == dict(want, frame_ms=5.0, frame_over_bound=5.0 / want["bound_ms"])

    sums = torch.where(coll[:, None], spec, 0.0).reshape(spp, size * size, 4).sum(0)
    frame = bench._frame_fn(dragon, cam, opts, size, size, spp, 1, CPU)
    assert torch.equal(sums, frame(seed)[0])


def test_dense_roofline_counts_the_frames_bounces():
    """(d) The box's roofline is dense_frame_roofline with the ray-bounces
    counted on every chunk of frame `seed`'s rays over its paths."""
    size, spp, chunk, seed = 8, 4, 2, 1
    box, cam, opts = bench_box_scene(device=CPU), bench_camera(device=CPU), _options(size, spp)
    got = bench.roofline_dense(box, cam, opts, size, size, spp, chunk, frame_ms=2.0, seed=seed,
                               device=CPU)
    ray_bounces = 0
    for c in range(spp // chunk):
        rays, kseed = bench.frame_rays(box, cam, opts, size, size, chunk, seed, c, CPU)
        st = sw.initial_state(rays.origin, rays.direction, kseed)
        for depth in range(opts.max_depth):
            ray_bounces += int((st[17] > 0.5).sum())
            sw.bounce_reference(box, st, depth, opts)
    n = size * size * spp
    assert n < ray_bounces <= n * opts.max_depth
    want = dense_frame_roofline(frame_s=2e-3, n_rays=n, n_prims=box.n_prims,
                                executed_bounces=ray_bounces / n)
    assert got == dict(want, ray_bounces=ray_bounces, frame_ms=2.0)


def test_main_without_a_card_refuses_and_renders_nothing(monkeypatch, capsys):
    """(e) Without a card main() exits 1 before any work (no CPU fallback)."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present")
    calls = []
    for name in ("run_verify", "run_dragon", "run_box", "run_box_grad", "run_workload"):
        monkeypatch.setattr(bench, name, lambda *a, _n=name, **k: calls.append(_n))
    assert bench.main([]) == 1
    captured = capsys.readouterr()
    assert calls == [] and captured.out == "" and "no CUDA device" in captured.err


def test_options_follow_bench_py(bench_py, monkeypatch, capsys):
    """The command line takes bench.py's options with its defaults; an
    unknown workload is refused."""
    want = {}
    for n in ast.walk(_function(bench_py, "main")):
        if isinstance(n, ast.Call) and getattr(n.func, "attr", "") == "add_argument":
            kw = {k.arg: k.value.value for k in n.keywords if isinstance(k.value, ast.Constant)}
            want[n.args[0].value] = kw.get("default", False if kw.get("action") else None)
    parser = {}
    parse_args = argparse.ArgumentParser.parse_args

    def capture(self, args=None, namespace=None):
        parser.update({a.option_strings[0]: a.default for a in self._actions
                       if a.option_strings and a.dest != "help"})
        return parse_args(self, args, namespace)

    monkeypatch.setattr(argparse.ArgumentParser, "parse_args", capture)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    assert bench.main([]) == 1
    assert parser == want
    with pytest.raises(SystemExit) as e:
        bench.main(["--workloads", "box,teapot"], device=CPU)
    assert e.value.code == 2 and "teapot" in capsys.readouterr().err


@pytest.mark.parametrize("rate, want", [(338.12345, 338.123), (0.0123456, 0.012),
                                        (0.000123456, 0.000123), (0.0, 0.0)])
def test_rates_print_to_three_decimals_and_stay_positive(rate, want):
    """A metric line's rate reads as bench.py's (3 decimals) where that is
    not 0; a slower rate keeps 3 significant digits, so a slow frame on a
    loaded host still prints a positive value."""
    assert bench._mrays(rate) == want
