"""The JAX package's environment knobs that the port reads as JAX reads
them, each against the JAX package under the same setting, on the CPU:

  * per build: PTX_KRN_CLUSTER (triangles per in-kernel record) in
    SceneBuilder.build;
  * at import: PTX_SORT_MORTON_BITS and PTX_SORT_MIN_ALIVE
    (integrator/sorted_wavefront.py);
  * per call: PTX_ADAPTIVE_FUSE (integrator/film.py:render_tile).

The import-time knobs are set with monkeypatch.setattr on the module
attributes of both packages; how each is read and clamped at import is
checked on fresh copies of both modules loaded under the environment.
Builds are compared byte for byte (the traversal tiers on the port's kept
columns), sort keys bit for bit. The JAX package's rejected clusterings
(PTX_KRN_SAH, PTX_KRN_SAH_AXES, PTX_KRN_MERGE) are not ported: a build
under any of them raises.
"""
import importlib.util
import math
import sys

import numpy as np
import pytest
import torch

import cpupathtrace_tpu.integrator.film as jax_film
import cpupathtrace_tpu.integrator.sorted_wavefront as jax_sw
from cpupathtrace_tpu_torch.accel import cluster
from cpupathtrace_tpu_torch.core.config import RenderOptions
from cpupathtrace_tpu_torch.core.rays import Rays
from cpupathtrace_tpu_torch.integrator import film
from cpupathtrace_tpu_torch.integrator import sorted_wavefront as sw
from cpupathtrace_tpu_torch.scene.scene import ARRAY_FIELDS, KRN_FIELDS, STATIC_FIELDS
from tests.torch_util import CPU, dragon_scene, sorted_rays

KNOB_TRIS = 3000  # the stand-in dragon of the knob checks (binned)
USED_COLS = dict(zip(KRN_FIELDS, (28, 7, 7, 7)))


def _assert_builds_equal(ours, ref):
    assert ours.accel == ref.accel == "binned"
    for f in ARRAY_FIELDS:
        a, b = getattr(ours, f).numpy(), np.asarray(getattr(ref, f))
        assert a.dtype == b.dtype and a.shape == b.shape and a.tobytes() == b.tobytes(), f
    for f in STATIC_FIELDS:
        assert getattr(ours, f) == getattr(ref, f), f
    for f, used in USED_COLS.items():
        a, b = getattr(ours, f).numpy(), np.asarray(getattr(ref, f))
        assert a.shape[:-1] == b.shape[:-1], (f, a.shape, b.shape)
        assert np.ascontiguousarray(a[..., :used]).tobytes() == \
            np.ascontiguousarray(b[..., :used]).tobytes(), f


@pytest.mark.parametrize("rows", [64, 128])
def test_build_matches_jax(rows, monkeypatch):
    """The stand-in dragon built binned by both packages under the same
    PTX_KRN_CLUSTER: every table equal byte for byte, and the record rows
    follow the knob."""
    monkeypatch.setenv("PTX_KRN_CLUSTER", str(rows))
    ref, ours = dragon_scene("jax", KNOB_TRIS), dragon_scene("port", KNOB_TRIS)
    _assert_builds_equal(ours, ref)
    assert ours.krn_cluster_size == rows and ours.krn_records.shape[1] == rows
    monkeypatch.delenv("PTX_KRN_CLUSTER")
    plain = dragon_scene("port", KNOB_TRIS)
    assert plain.krn_cluster_size == 56 and plain.krn_records.shape != ours.krn_records.shape


@pytest.mark.parametrize("name,value", [("PTX_KRN_SAH", "1"), ("PTX_KRN_SAH_AXES", "3"),
                                        ("PTX_KRN_MERGE", "1")])
def test_rejected_cluster_knobs_raise(name, value, monkeypatch):
    """The JAX package's rejected clusterings are not ported: a binned
    build, and a cluster cut on its own, under any of their knobs raise
    instead of giving other tables than JAX's."""
    monkeypatch.setenv(name, value)
    with pytest.raises(ValueError, match=name):
        dragon_scene("port", KNOB_TRIS)
    lo = np.zeros((10, 3), np.float32)
    with pytest.raises(ValueError, match=name):
        cluster.build_cluster_bvh(lo, lo + 1, cluster_size=8)


def test_rejected_cluster_knobs_at_their_defaults_build(monkeypatch):
    """Set to their defaults, the rejected knobs change nothing: the build
    equals JAX's under the same settings byte for byte."""
    for name, default in cluster.REJECTED_KNOBS.items():
        monkeypatch.setenv(name, default)
    _assert_builds_equal(dragon_scene("port", KNOB_TRIS), dragon_scene("jax", KNOB_TRIS))


@pytest.mark.parametrize("bits", [1, 4, 8])
def test_sort_key_matches_jax_at_morton_bits(bits, monkeypatch):
    """_sort_key at other Morton resolutions, bit-equal to JAX's, on the
    states of one bounce into the 1200-triangle dragon (entering, missing
    and dead rays)."""
    import jax.numpy as jnp

    monkeypatch.setattr(jax_sw, "_MORTON_BITS", bits)
    monkeypatch.setattr(sw, "_MORTON_BITS", bits)
    scene = dragon_scene("port")
    o, d = sorted_rays()
    st = sw.initial_state(torch.from_numpy(o), torch.from_numpy(d), 7)
    sw.bounce_reference(scene, st, 0, RenderOptions(8, 8, 1, 1, max_depth=4))
    planes = [st[i].numpy() for i in (1, 2, 3, 4, 5, 6, 17)]
    lo, hi = scene.root_lo.numpy(), scene.root_hi.numpy()
    ref = np.asarray(jax_sw._sort_key(*map(jnp.asarray, planes), jnp.asarray(lo), jnp.asarray(hi)))
    ours = sw._sort_key(*[st[i] for i in (1, 2, 3, 4, 5, 6, 17)], scene.root_lo, scene.root_hi)
    np.testing.assert_array_equal(ours.numpy(), ref)
    alive = planes[-1] > 0.5
    miss = 1 << (3 * bits + 3)
    keys = ours.numpy()
    assert (keys[~alive] == 2 ** 30).all() and (keys[alive] < 2 ** 30).all()
    entering = keys[alive][keys[alive] < miss]
    assert entering.size and len(np.unique(entering >> 3)) > (1 if bits == 1 else 8)


def _fresh_module(name: str, monkeypatch):
    """A fresh copy of module `name` executed under the current environment
    (its import-time reads), beside the imported one."""
    spec = importlib.util.find_spec(name)
    probe = f"{name}_knob_probe"
    copy = importlib.util.spec_from_file_location(probe, spec.origin)
    mod = importlib.util.module_from_spec(copy)
    monkeypatch.setitem(sys.modules, probe, mod)
    copy.loader.exec_module(mod)
    return mod


@pytest.mark.parametrize("value,want", [("-3", 1), ("0", 1), ("1", 1), ("6", 6), ("8", 8),
                                        ("12", 8), (None, 4)])
def test_morton_bits_read_and_clamped_at_import(value, want, monkeypatch):
    """PTX_SORT_MORTON_BITS is read at import and clamped to [1, 8] in both
    packages; PTX_SORT_MIN_ALIVE beside it."""
    if value is None:
        monkeypatch.delenv("PTX_SORT_MORTON_BITS", raising=False)
    else:
        monkeypatch.setenv("PTX_SORT_MORTON_BITS", value)
    monkeypatch.setenv("PTX_SORT_MIN_ALIVE", "300")
    ours = _fresh_module("cpupathtrace_tpu_torch.integrator.sorted_wavefront", monkeypatch)
    ref = _fresh_module("cpupathtrace_tpu.integrator.sorted_wavefront", monkeypatch)
    assert ours._MORTON_BITS == ref._MORTON_BITS == want
    assert ours._SORT_MIN_ALIVE == ref._SORT_MIN_ALIVE == 300


def test_sort_threshold_follows_the_jax_rule(monkeypatch):
    """The twin driver sorts after a bounce iff the rays alive then number
    at least min(_SORT_MIN_ALIVE, max(rays // 4, 1)) (JAX
    sorted_wavefront.py:480), under two thresholds that sort different
    bounces."""
    scene = dragon_scene("port")
    o, d = sorted_rays()
    rays = Rays(torch.from_numpy(o), torch.from_numpy(d))
    opts = RenderOptions(8, 8, 1, 1, max_depth=12)
    r = o.shape[0]
    sorted_bounces = {}
    for threshold in (1 << 16, 100):
        alive, keys = [], []
        bounce, sort_key = sw.bounce_reference, sw._sort_key

        def counted_bounce(scene, st, *args, **kw):
            bounce(scene, st, *args, **kw)
            alive.append(int((st[17] > 0.5).sum()))

        def counted_key(*args):
            keys.append(int((args[6] > 0.5).sum()))
            return sort_key(*args)

        counted_bounce.calls = 0  # the plain version's call counter
        monkeypatch.setattr(sw, "bounce_reference", counted_bounce)
        monkeypatch.setattr(sw, "_sort_key", counted_key)
        monkeypatch.setattr(sw, "_SORT_MIN_ALIVE", threshold)
        sw.trace_megakernel_sorted(scene, rays, opts, 99)
        monkeypatch.setattr(sw, "bounce_reference", bounce)
        monkeypatch.setattr(sw, "_sort_key", sort_key)
        want = [n for n in alive if n >= min(threshold, max(r // 4, 1))]
        assert keys == want, (threshold, alive, keys)
        sorted_bounces[threshold] = len(keys)
    assert sorted_bounces[100] > sorted_bounces[1 << 16] > 0, sorted_bounces


_RENDER_CHUNK, _RENDER_CHUNK_BATCHED = film.render_chunk, film.render_chunk_batched


def _render_counted(monkeypatch, fuse):
    """render() of the box at 8 x 8, 20 samples a pixel (stats batches of 5:
    four), with the chunk launches counted."""
    from cpupathtrace_tpu_torch.models.scenes import bench_box_scene, bench_camera

    if fuse is None:
        monkeypatch.delenv("PTX_ADAPTIVE_FUSE", raising=False)
    else:
        monkeypatch.setenv("PTX_ADAPTIVE_FUSE", fuse)
    calls = []

    def counted_single(*args, **kw):
        calls.append(1)
        return _RENDER_CHUNK(*args, **kw)

    def counted_batched(*args, **kw):
        calls.append(args[7])
        return _RENDER_CHUNK_BATCHED(*args, **kw)

    monkeypatch.setattr(film, "render_chunk", counted_single)
    monkeypatch.setattr(film, "render_chunk_batched", counted_batched)
    opts = RenderOptions(8, 8, 20, 20, epsilon=1e-3, max_depth=6)
    img = film.render(bench_box_scene(device=CPU), bench_camera(device=CPU), opts, seed=3,
                      device=CPU)
    return img, calls


@pytest.mark.parametrize("fuse", ["1", "2", "3", "4", "0"])
def test_render_tile_launches_follow_adaptive_fuse(fuse, monkeypatch):
    """ceil(n_full / fuse) launches of up to `fuse` stats batches each (a
    fuse below 1 counts as 1, as max(1, ...) in film.py:378), every batch
    rendered once."""
    img, calls = _render_counted(monkeypatch, fuse)
    f = max(1, int(fuse))
    assert len(calls) == math.ceil(4 / f) and sum(calls) == 4 and max(calls) == min(f, 4)
    assert img.shape == (8, 8, 4) and np.isfinite(img).all() and (img[..., 3] == 1.0).all()


def test_adaptive_fuse_default_is_four(monkeypatch):
    """Unset, the fuse is 4: the same launches and the same image bit for
    bit as PTX_ADAPTIVE_FUSE=4; fuse 1 draws another random stream."""
    img, calls = _render_counted(monkeypatch, None)
    img4, calls4 = _render_counted(monkeypatch, "4")
    img1, _ = _render_counted(monkeypatch, "1")
    assert calls == calls4 == [4]
    np.testing.assert_array_equal(img.view(np.int32), img4.view(np.int32))
    assert not np.array_equal(img1, img4)


# An adaptive tile that converges early: 16 pixels, 16-254 samples a pixel
# (stats batches of 4: 63 full batches and a remainder of 2, 7 passes to
# accept, flags from batch 4 on).
EARLY_P = 16
EARLY_OPTS = dict(image_width=4, image_height=4, min_sample_count=16, max_sample_count=254)


class _EarlyFeed:
    """Chunk results in place of the renders: pixel i collects nothing
    before stats batch 2i, then every sample with a constant colour, so it
    is accepted a few batches later and every pixel freezes long before the
    last batch. Records each launch as (kind, batches or samples)."""

    def __init__(self, as_array):
        self.batch, self.calls, self.as_array = 0, [], as_array
        self.colour = (0.25 + 0.05 * np.arange(EARLY_P, dtype=np.float32))[:, None] * \
            np.float32([1.0, 0.5, 0.25, 1.0])

    def _batches(self, kb, spp):
        sums, colls = [], []
        for b in range(self.batch, self.batch + kb):
            coll = np.where(2 * np.arange(EARLY_P) <= b, spp, 0).astype(np.int32)
            sums.append(self.colour * coll[:, None].astype(np.float32))
            colls.append(coll)
        self.batch += kb
        return self.as_array(np.stack(sums)), self.as_array(np.stack(colls))

    def single(self, spp):
        self.calls.append(("single", spp))
        s, c = self._batches(1, spp)
        return s[0], c[0]

    def batched(self, spp, kb):
        self.calls.append(("batched", kb))
        return self._batches(kb, spp)


@pytest.mark.parametrize("fuse", ["1", "2", "4"])
def test_render_tile_early_break_matches_jax(fuse, monkeypatch):
    """render_tile of both packages on the same early-converging chunk
    results (JAX's through its `chunk_fns` hook, the port's with its chunk
    renderers replaced): the same launches, the early break at the same
    launch (the flag lag is 3 launches at fuse 1 and 1 above), the same
    pixels."""
    import jax
    import jax.numpy as jnp
    from cpupathtrace_tpu.core.config import RenderOptions as JaxRenderOptions

    monkeypatch.setenv("PTX_ADAPTIVE_FUSE", fuse)
    jfeed = _EarlyFeed(jnp.asarray)
    ref = jax_film.render_tile(
        None, None, JaxRenderOptions(**EARLY_OPTS), np.zeros(EARLY_P, np.float32),
        np.zeros(EARLY_P, np.float32), jax.random.PRNGKey(0),
        chunk_fns=(lambda k, spp: jfeed.single(spp),
                   lambda k, spp, kb: jfeed.batched(spp, kb)))
    feed = _EarlyFeed(torch.from_numpy)
    monkeypatch.setattr(film, "render_chunk", lambda *a, **kw: feed.single(a[6]))
    monkeypatch.setattr(film, "render_chunk_batched", lambda *a, **kw: feed.batched(a[6], a[7]))
    ours = film.render_tile(None, None, RenderOptions(**EARLY_OPTS), torch.zeros(EARLY_P),
                            torch.zeros(EARLY_P), torch.Generator().manual_seed(0))
    assert feed.calls == jfeed.calls
    full = [c for c in feed.calls if c[0] == "batched" or c[1] == 4]
    assert len(full) < math.ceil(63 / int(fuse)) and feed.calls[-1] == ("single", 2)
    np.testing.assert_allclose(ours.numpy(), np.asarray(ref), rtol=1e-6, atol=0)
    np.testing.assert_allclose(ours.numpy(), feed.colour, rtol=1e-6, atol=0)
