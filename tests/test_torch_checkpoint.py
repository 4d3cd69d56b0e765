"""The port's checkpoint / resume (cpupathtrace_tpu_torch/integrator/
checkpoint.py) against the JAX package's (tests/test_checkpoint.py's cases
on the inward box, 8x8 @ 16 spp, max_depth 6): resumed renders bit for bit
the uninterrupted ones, the accumulation and chunk schedule equal to JAX's
under one deterministic stub, checkpoint files read across packages, and
mismatched configs and fingerprints refused."""
import dataclasses
import json

import numpy as np
import pytest
import torch

import cpupathtrace_tpu as ptx
import cpupathtrace_tpu_torch as pt
from cpupathtrace_tpu.integrator import checkpoint as jck
from cpupathtrace_tpu_torch.integrator import checkpoint as tck
from cpupathtrace_tpu_torch.integrator.rng import chunk_seed
from cpupathtrace_tpu_torch.models import golden
from cpupathtrace_tpu_torch.scene.scene import TENSOR_FIELDS
from tests.scenes_util import inward_box_scene
from tests.torch_util import CPU

CAM = dict(origin=(0, 0, 0), look_at=(0, 0, 0.9), up=(0, 1, 0))


def _setup(width=8, height=8):
    return (golden.inward_box_scene(device=CPU), pt.make_camera(**CAM, device=CPU),
            pt.RenderOptions(width, height, 16, 16, max_depth=6))


def _jax_setup(width=8, height=8):
    return (inward_box_scene(), ptx.make_camera(**CAM),
            ptx.RenderOptions(width, height, 16, 16, max_depth=6))


def _resumable(*args, **kw):
    return tck.render_resumable(*args, device=CPU, **kw)


class Interrupt(Exception):
    pass


def _bomb_after(n):
    def bomb(done, total):
        if done == n:
            raise Interrupt
    return bomb


def _assert_same_film(a, b):
    np.testing.assert_array_equal(a.pixel_sum, b.pixel_sum)
    np.testing.assert_array_equal(a.sample_count, b.sample_count)
    assert a.pixel_sum.dtype == b.pixel_sum.dtype == np.float64
    assert a.sample_count.dtype == b.sample_count.dtype == np.int64
    for f in ("chunks_done", "spp", "spp_chunk", "seed", "width", "height", "fingerprint"):
        assert getattr(a, f) == getattr(b, f), f


def test_uninterrupted_render():
    scene, cam, opts = _setup()
    state = _resumable(scene, cam, opts, spp=16, spp_chunk=4)
    assert state.chunks_done == 4
    img = state.image()
    assert img.shape == (8, 8, 4) and img.dtype == np.float32
    np.testing.assert_allclose(img[..., 3], 1.0)
    assert img[..., :3].mean() > 0.0


def test_resume_bit_identical(tmp_path):
    """tests/test_checkpoint.py:32: the checkpoint rewound to two chunks
    done (the sums of an 8-spp render) resumes to the full render."""
    scene, cam, opts = _setup()
    ckpt = str(tmp_path / "film.npz")
    full = _resumable(scene, cam, opts, spp=16, spp_chunk=4, checkpoint_path=ckpt)
    half = tck.load_checkpoint(ckpt)
    base = _resumable(scene, cam, opts, spp=8, spp_chunk=4)
    half.pixel_sum, half.sample_count, half.chunks_done = base.pixel_sum, base.sample_count, 2
    tck.save_checkpoint(ckpt, half)
    resumed = _resumable(scene, cam, opts, spp=16, spp_chunk=4, checkpoint_path=ckpt)
    _assert_same_film(resumed, full)


def test_interrupted_render_resumes_only_the_rest(tmp_path, monkeypatch):
    """A render stopped by its progress callback after chunk 2 resumes from
    its file: the resume renders chunks 3 and 4 only and ends bit for bit
    at the uninterrupted render."""
    scene, cam, opts = _setup()
    full = _resumable(scene, cam, opts, spp=16, spp_chunk=4, seed=5)
    ckpt = str(tmp_path / "film.npz")
    with pytest.raises(Interrupt):
        _resumable(scene, cam, opts, spp=16, spp_chunk=4, seed=5, checkpoint_path=ckpt,
                   progress_callback=_bomb_after(2))
    assert tck.load_checkpoint(ckpt).chunks_done == 2
    calls = []
    real = tck.render_chunk

    def counted(*args):
        calls.append(args[-1])
        return real(*args)

    monkeypatch.setattr(tck, "render_chunk", counted)
    resumed = _resumable(scene, cam, opts, spp=16, spp_chunk=4, seed=5, checkpoint_path=ckpt)
    assert calls == [4, 4] and resumed.chunks_done == 4
    np.testing.assert_array_equal(resumed.pixel_sum, full.pixel_sum)
    np.testing.assert_array_equal(resumed.sample_count, full.sample_count)


@pytest.mark.parametrize("field", ["spp_chunk", "spp", "seed", "width", "height"])
def test_mismatched_config_rejected(tmp_path, field):
    """tests/test_checkpoint.py:55, :65: a checkpoint of another width,
    height, spp, spp_chunk or seed is refused, for the port as for JAX."""
    changed = dict(spp_chunk=2, spp=16, seed=1, width=4, height=4)[field]
    for pkg, (scene, cam, opts), render in (
        ("port", _setup(), _resumable), ("jax", _jax_setup(), jck.render_resumable)):
        ckpt = str(tmp_path / f"{pkg}.npz")
        kw = dict(spp=8, spp_chunk=4, seed=0)
        render(scene, cam, opts, checkpoint_path=ckpt, **kw)
        if field in ("width", "height"):
            opts = dataclasses.replace(opts, **{f"image_{field}": changed})
        else:
            kw[field] = changed
        with pytest.raises(ValueError, match="different render config"):
            render(scene, cam, opts, checkpoint_path=ckpt, **kw)


def test_fingerprint_mismatch_rejected(tmp_path):
    """A camera moved by one ulp has another fingerprint: the resume is
    refused."""
    scene, cam, opts = _setup()
    ckpt = str(tmp_path / "film.npz")
    _resumable(scene, cam, opts, spp=8, spp_chunk=4, checkpoint_path=ckpt)
    origin = cam.origin.clone()
    origin[0] = torch.nextafter(origin[0], torch.tensor(1.0))
    moved = dataclasses.replace(cam, origin=origin)
    with pytest.raises(ValueError, match="different scene/camera"):
        _resumable(scene, moved, opts, spp=8, spp_chunk=4, checkpoint_path=ckpt)


def test_last_chunk_is_smaller():
    """spp=10 in chunks of 4: three chunks, the last of 2, and 10 samples
    in every pixel of the closed box, as JAX."""
    scene, cam, opts = _setup()
    state = _resumable(scene, cam, opts, spp=10, spp_chunk=4)
    ref = jck.render_resumable(*_jax_setup(), spp=10, spp_chunk=4)
    assert state.chunks_done == ref.chunks_done == 3
    assert (state.sample_count == 10).all() and (ref.sample_count == 10).all()


def test_chunk_seed_depends_on_seed_and_chunk_alone(monkeypatch):
    """Chunk c's generator is seeded by chunk_seed(seed, c): the same value
    in every process (pinned here), distinct across chunks, and the same
    whatever the spp and the chunks already done."""
    assert [chunk_seed(0, c) for c in range(3)] == [
        12267342907925095776, 12267342910550266904, 12267342910766244310]
    assert chunk_seed(5, 0) == 8252757311214289523
    for seed in (0, 1, 2**40 + 3, -1):
        seeds = [chunk_seed(seed, c) for c in range(1024)]
        assert len(set(seeds)) == len(seeds)
        assert all(0 <= s < 2**64 for s in seeds)
    seen = []
    real = tck.render_chunk

    def spy(scene, camera, options, x_cam, y_cam, generator, spp):
        seen.append((generator.initial_seed(), spp))
        return real(scene, camera, options, x_cam, y_cam, generator, spp)

    monkeypatch.setattr(tck, "render_chunk", spy)
    scene, cam, opts = _setup(4, 4)
    _resumable(scene, cam, opts, spp=16, spp_chunk=4, seed=9)
    long_run = list(seen)
    seen.clear()
    _resumable(scene, cam, opts, spp=10, spp_chunk=4, seed=9)
    assert [s for s, _ in seen] == [s for s, _ in long_run[:3]]
    assert long_run == [(chunk_seed(9, c), 4) for c in range(4)]
    assert seen[-1][1] == 2


def _stub(kind, calls):
    """One deterministic render_chunk for both packages: sums and counts
    made from the call's index and its sample count."""
    def stub(scene, camera, options, x_cam, y_cam, key, spp):
        p = options.image_width * options.image_height
        rng = np.random.default_rng([len(calls), spp])
        calls.append(spp)
        s = (rng.standard_normal((p, 4)) * spp).astype(np.float32)
        cnt = rng.integers(0, spp + 1, p).astype(np.int32)
        return (torch.from_numpy(s), torch.from_numpy(cnt)) if kind == "port" else (s, cnt)
    return stub


def _file(path):
    with np.load(path, allow_pickle=False) as z:
        return {k: z[k] for k in z.files}


@pytest.mark.parametrize("spp,spp_chunk,every", [(16, 4, 1), (10, 4, 2), (7, 7, 1)])
def test_accumulation_matches_jax_under_a_stub(tmp_path, monkeypatch, spp, spp_chunk, every):
    """Both packages' render_chunk replaced by one stub (and the fingerprint
    by a constant): the FilmStates and the checkpoint files are equal bit
    for bit, uninterrupted and interrupted after the first chunk and
    resumed."""
    films = {}
    for pkg, mod, setup in (("port", tck, _setup), ("jax", jck, _jax_setup)):
        calls = []
        monkeypatch.setattr(mod, "render_chunk", _stub(pkg, calls))
        monkeypatch.setattr(mod, "render_fingerprint", lambda scene, camera: "fp")
        render = _resumable if pkg == "port" else jck.render_resumable
        kw = dict(spp=spp, spp_chunk=spp_chunk, seed=3, checkpoint_every=every)
        whole = str(tmp_path / f"{pkg}_whole.npz")
        cut = str(tmp_path / f"{pkg}_cut.npz")
        a = render(*setup(), checkpoint_path=whole, **kw)
        with pytest.raises(Interrupt):
            render(*setup(), checkpoint_path=cut, progress_callback=_bomb_after(1), **kw)
        b = render(*setup(), checkpoint_path=cut, **kw)
        films[pkg] = (a, b, _file(whole), _file(cut), calls)
    (pa, pb, pfa, pfb, pcalls), (ja, jb, jfa, jfb, jcalls) = films["port"], films["jax"]
    assert pcalls == jcalls
    _assert_same_film(pa, ja)
    _assert_same_film(pb, jb)
    for p, j in ((pfa, jfa), (pfb, jfb)):
        assert sorted(p) == sorted(j) == ["meta", "pixel_sum", "sample_count"]
        for k in p:
            assert p[k].dtype == j[k].dtype and np.array_equal(p[k], j[k]), k
    assert json.loads(str(pfa["meta"]))["version"] == 3


@pytest.mark.parametrize("writer", ["jax", "port"])
def test_checkpoint_files_load_across_packages(tmp_path, writer):
    """A FilmState saved by one package loads in the other with equal
    fields."""
    rng = np.random.default_rng(4)
    fields = dict(pixel_sum=rng.standard_normal((12, 4)),
                  sample_count=rng.integers(0, 9, 12).astype(np.int64),
                  chunks_done=2, spp=12, spp_chunk=4, seed=7, width=4, height=3,
                  fingerprint="0123abcd")
    save, load = ((jck.save_checkpoint, tck.load_checkpoint) if writer == "jax"
                  else (tck.save_checkpoint, jck.load_checkpoint))
    path = str(tmp_path / "film.npz")
    save(path, (jck.FilmState if writer == "jax" else tck.FilmState)(**fields))
    back = load(path)
    _assert_same_film(back, tck.FilmState(**fields))
    np.testing.assert_array_equal(back.image(), tck.FilmState(**fields).image())


def test_resume_refuses_the_other_packages_checkpoint(tmp_path):
    """The same config checkpointed by JAX: its fingerprint hashes JAX's
    scene, so the port refuses to resume it."""
    ckpt = str(tmp_path / "film.npz")
    jck.render_resumable(*_jax_setup(), spp=8, spp_chunk=4, checkpoint_path=ckpt)
    with pytest.raises(ValueError, match="different scene/camera"):
        _resumable(*_setup(), spp=8, spp_chunk=4, checkpoint_path=ckpt)


def test_fingerprint_sees_every_tensor_element():
    """Changing any one element of any scene or camera tensor changes the
    fingerprint; an equal copy keeps it."""
    scene, cam, _ = _setup()
    ref = tck.render_fingerprint(scene, cam)
    copy = dataclasses.replace(scene, **{f: getattr(scene, f).clone() for f in TENSOR_FIELDS})
    assert tck.render_fingerprint(copy, cam) == ref

    def bumped(t):
        """`t` with the lowest bit of its last element flipped (one ulp of a
        float, one of an integer, a bool negated)."""
        flat = t.clone().reshape(-1)
        flat.view(torch.uint8)[-t.element_size()] ^= 1
        return flat.reshape(t.shape)

    for name in TENSOR_FIELDS:
        other = dataclasses.replace(scene, **{name: bumped(getattr(scene, name))})
        assert tck.render_fingerprint(other, cam) != ref, name
    for name in tck.CAMERA_FIELDS:
        other = dataclasses.replace(cam, **{name: bumped(getattr(cam, name))})
        assert tck.render_fingerprint(scene, other) != ref, name


def test_mesh_waits_for_the_parallel_port():
    """parallel/ is ported: with a mesh of one rank (a world of one in this
    process) chunk c renders through render_chunk_sharded, from
    shard_seed(chunk_seed(seed, c), 0, 0). (tests/test_torch_failover.py
    runs it on two ranks.)"""
    import torch.distributed as dist

    from cpupathtrace_tpu_torch.integrator.rng import shard_seed
    from cpupathtrace_tpu_torch.parallel.mesh import make_render_mesh

    assert not dist.is_initialized()
    try:
        mesh = make_render_mesh(device_type=CPU)
        scene, cam, opts = _setup()
        state = tck.render_resumable(scene, cam, opts, spp=8, seed=2, spp_chunk=4, mesh=mesh)
        x, y = (torch.from_numpy(np.ascontiguousarray(a, np.float32)) for a in
                tck.pixel_camera_coords(opts, *(g.ravel() for g in np.meshgrid(
                    np.arange(8, dtype=np.float32), np.arange(8, dtype=np.float32)))))
        want = np.zeros((64, 4))
        for c in range(2):
            g = torch.Generator()
            g.manual_seed(shard_seed(chunk_seed(2, c), 0, 0))
            want += tck.render_chunk(scene, cam, opts, x, y, g, 4)[0].numpy().astype(np.float64)
        np.testing.assert_array_equal(state.pixel_sum, want)
        assert state.chunks_done == 2 and (state.sample_count == 8).all()
    finally:
        dist.destroy_process_group()


def test_resumable_image_matches_jax():
    """32x32 @ 64 spp in chunks of 16: the same coverage as JAX's resumable
    render, a mean within 5% (as test_torch_film.py bounds the adaptive
    renders) and within 4 standard errors of the per-pixel differences
    (two independent estimators; at 16x16 @ 16 spp one standard error is
    ~6% of the mean)."""
    ours = _resumable(*_setup(32, 32), spp=64, spp_chunk=16, seed=2).image()
    ref = jck.render_resumable(*_jax_setup(32, 32), spp=64, spp_chunk=16, seed=2).image()
    assert ours.shape == ref.shape == (32, 32, 4)
    np.testing.assert_array_equal(ours[..., 3], ref[..., 3])
    a, b = float(ours[..., :3].mean()), float(ref[..., :3].mean())
    assert abs(a - b) <= 0.05 * b, (a, b)
    diff = ours[..., :3].mean(-1).astype(np.float64) - ref[..., :3].mean(-1)
    assert abs(diff.mean()) <= 4 * diff.std() / np.sqrt(diff.size), (a, b)
