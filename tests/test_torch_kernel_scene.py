"""The kernels' view of a scene (integrator/megakernel.py `KernelScene`,
csrc/scene_args.cuh): the ctypes mirrors against the C structs and entry
points they are passed to, the struct a kernel scene fills, its checks at
build time, and one build a trace call on the CPU."""
import ctypes
import dataclasses
import re
import types

import pytest
import torch

from cpupathtrace_tpu_torch import _build
from cpupathtrace_tpu_torch.accel import kernel_traverse as kt
from cpupathtrace_tpu_torch.core.config import RenderOptions
from cpupathtrace_tpu_torch.core.rays import Rays
from cpupathtrace_tpu_torch.integrator import diff_megakernel as dm
from cpupathtrace_tpu_torch.integrator import megakernel as mk
from cpupathtrace_tpu_torch.integrator import sorted_wavefront as sw
from tests.torch_util import build_scene, dragon_scene, make_rays

# C declarations -> the ctypes type their mirror must use.
_C_TYPES = {
    "const float*": ctypes.c_void_p, "float*": ctypes.c_void_p, "const int*": ctypes.c_void_p,
    "int*": ctypes.c_void_p, "unsigned long long*": ctypes.c_void_p, "void*": ctypes.c_void_p,
    "int": ctypes.c_int, "float": ctypes.c_float, "long long": ctypes.c_longlong,
    "ClusterTables": kt.ClusterTables,
    "const ptx::SceneArgs*": ctypes.POINTER(mk.SceneArgs),
    "const ptx::ClusterTables*": ctypes.POINTER(kt.ClusterTables),
}


def _source(name):
    return re.sub(r"//[^\n]*", "", (_build.CSRC / name).read_text())


def _struct_fields(name, source):
    """[(field, C type)] of `struct name { ... };` in csrc/`source`."""
    body = re.search(rf"struct {name} {{(.*?)\n}};", _source(source), re.S).group(1)
    out = []
    for decl in filter(None, (d.strip() for d in body.split(";"))):
        m = re.fullmatch(r"((?:const )?[\w:]+(?: \w+)*?\s*\*?)\s*(\w+)", " ".join(decl.split()))
        out.append((m.group(2), m.group(1).replace(" *", "*").strip()))
    return out


def _entry_params(name, source):
    """[C type] of the parameters of `extern "C" int name(...)`."""
    params = re.search(rf'extern "C" int {name}\((.*?)\)\s*{{', _source(source), re.S).group(1)
    return [" ".join(p.split()).rsplit(" ", 1)[0].replace(" *", "*")
            for p in params.split(",")]


@pytest.mark.parametrize("mirror,name,source", [
    (mk.SceneArgs, "SceneArgs", "scene_args.cuh"),
    (kt.ClusterTables, "ClusterTables", "cluster_traverse.cuh"),
])
def test_ctypes_mirror_matches_the_c_struct(mirror, name, source):
    """The mirror's fields are the struct's, in order and C type: a field
    added on one side only fails here."""
    c_fields = _struct_fields(name, source)
    assert [(f, _C_TYPES[t]) for f, t in c_fields] == list(mirror._fields_)


@pytest.mark.parametrize("source", ["megakernel.cu", "bounce.cu"])
def test_kernel_params_embed_one_scene(source):
    """K1's and K2's Params hold the scene as one SceneArgs and repeat none
    of its fields."""
    fields = dict(_struct_fields("Params", source))
    assert fields["scene"] == "SceneArgs"
    assert not set(fields) & {f for f, _ in mk.SceneArgs._fields_}


def _launch_fn(getter, monkeypatch, symbol):
    """The ctypes function `getter` declares, on a stand-in library (no
    build: its argtypes are read, never called)."""
    fn = types.SimpleNamespace(argtypes=None, restype=None)
    monkeypatch.setattr(_build, "load", lambda name: types.SimpleNamespace(**{symbol: fn}))
    return getter()


@pytest.mark.parametrize("getter,symbol,source,first", [
    (lambda: mk._library(), "ptx_megakernel_launch", "megakernel.cu", "const ptx::SceneArgs*"),
    (lambda: sw._bounce_fn(), "ptx_bounce_launch", "bounce.cu", "const ptx::SceneArgs*"),
    (lambda: kt._query_fn(), "ptx_cluster_query_launch", "cluster_query.cu",
     "const ptx::ClusterTables*"),
])
def test_entry_point_argtypes_match_the_c_signature(getter, symbol, source, first, monkeypatch):
    """Each launch entry point takes its scene (or tiers) as one struct
    pointer first, at most 16 parameters, and its wrapper declares them
    one for one."""
    params = _entry_params(symbol, source)
    assert params[0] == first and len(params) <= 16
    fn = _launch_fn(getter, monkeypatch, symbol)
    assert fn.restype is ctypes.c_int
    assert list(fn.argtypes) == [_C_TYPES[p] for p in params]


SCENES = {
    "box": lambda: build_scene("bench_box", "port"),              # dense, the pair form
    "sphere": lambda: build_scene("sphere_point_light", "port"),  # dense, the table form
    "dragon": lambda: dragon_scene("port"),                       # binned, 1200 triangles
}


@pytest.mark.parametrize("name", SCENES)
def test_kernel_scene_holds_the_packed_tables(name):
    """The kernel scene's tables are pack_tables', and its struct holds
    their pointers and counts, the pair record's and the tiers'."""
    scene = SCENES[name]()
    ks = mk.kernel_scene(scene)
    for ours, want in zip(ks.tables, mk.pack_tables(scene), strict=True):
        assert torch.equal(ours, want)
    a = ks.args
    tri, sph, mat, lgt, em = ks.tables
    assert (a.sph, a.n_sph, a.mat, a.n_mat) == (sph.data_ptr(), sph.shape[0], mat.data_ptr(),
                                                mat.shape[0])
    assert (a.lgt, a.n_lights, a.em, a.n_em, a.em_k) == (
        lgt.data_ptr(), scene.n_point_lights, em.data_ptr(), scene.n_emissive,
        scene.emissive_sample_count)
    assert a.tri == tri.data_ptr() and a.tier_floats == 0
    if name == "sphere":
        assert ks.rec is None and (a.rec, a.rec_rows, a.rec_stride) == (None, 0, 0)
        assert a.n_tri == tri.shape[0] and a.rec_cull == -1
    else:
        rec = scene.krn_big_pair
        assert ks.rec is rec and a.n_tri == 0
        assert (a.rec, a.rec_rows, a.rec_stride) == (rec.data_ptr(), *rec.shape)
        assert a.rec_cull == scene.krn_big_cull_mode
    assert a.binned == int(name == "dragon") == int(ks.binned)
    cl = a.cl
    if name == "dragon":
        krec, clb, sup, hyp, root = ks.clusters
        for ours, want in zip(ks.clusters, kt.kernel_tables(scene), strict=True):
            assert torch.equal(ours, want)
        assert (cl.rec, cl.n_rec, cl.rec_rows) == (krec.data_ptr(), *krec.shape[:2])
        assert (cl.clb, cl.sup, cl.n_pages, cl.hyp, cl.root) == (
            clb.data_ptr(), sup.data_ptr(), sup.shape[0], hyp.data_ptr(), root.data_ptr())
        assert cl.cull == scene.krn_cull_mode
    else:
        assert ks.clusters is None and (cl.rec, cl.n_pages, cl.cull) == (None, 0, -1)


def _bad_tables(tables, which, how):
    out = list(tables)
    t = out[which]
    out[which] = {"cols": lambda: t[:, :-1].contiguous(), "dtype": lambda: t.double(),
                  "strided": lambda: torch.cat([t, t], 1)[:, ::2]}[how]()
    return out


@pytest.mark.parametrize("how", ["cols", "dtype", "strided"])
@pytest.mark.parametrize("which", range(5))
def test_malformed_table_raises_at_build(which, how):
    """A table without the kernels' layout is refused when the kernel scene
    is built, before any launch."""
    scene = build_scene("bench_box", "port")
    tables = mk.pack_tables(scene)
    name = ("tri", "sph", "mat", "lgt", "em")[which]
    with pytest.raises(ValueError, match=name):
        mk.KernelScene(scene, _bad_tables(tables, which, how))


@pytest.mark.parametrize("field,bad", [
    ("krn_records", lambda t: t[:, :, :-1].contiguous()),
    ("krn_sup_bounds", lambda t: t.double()),
    ("krn_big_pair", lambda t: t.t()),
])
def test_malformed_tiers_or_record_raise_at_build(field, bad):
    """The binned scene's tiers and pair record are checked there too."""
    scene = dragon_scene("port")
    scene = dataclasses.replace(scene, **{field: bad(getattr(scene, field))})
    with pytest.raises(ValueError, match=field):
        mk.kernel_scene(scene)


def _count_packs(monkeypatch):
    calls = []
    pack = mk.pack_tables
    monkeypatch.setattr(mk, "pack_tables", lambda scene: calls.append(1) or pack(scene))
    return calls


def _box_rays(n=256):
    o, d = make_rays("sphere_dirs", n, seed=3)
    return Rays(torch.from_numpy(o), torch.from_numpy(d))


@pytest.mark.parametrize("tracer", ["sorted", "record", "k1"])
def test_a_trace_call_builds_its_tables_once(tracer, monkeypatch):
    """A multi-bounce trace on the CPU packs the tables once and hands the
    one kernel scene to every bounce."""
    scene, rays = build_scene("bench_box", "port"), _box_rays()
    opts = RenderOptions(16, 16, 1, 1, epsilon=1e-3, max_depth=6)
    calls = _count_packs(monkeypatch)
    bounces = sw.bounce_reference.calls
    if tracer == "sorted":
        sw.trace_megakernel_sorted(scene, rays, opts, 7)
    elif tracer == "record":
        assert dm.record_pass(scene, rays, opts, 7)[3] > 1
    else:
        mk.trace_megakernel(scene, rays, opts, 7)
    assert len(calls) == 1
    if tracer != "k1":
        assert sw.bounce_reference.calls - bounces > 1
    # A kernel scene handed in is used as it is.
    ks = mk.kernel_scene(scene)
    {"sorted": sw.trace_megakernel_sorted, "record": dm.record_pass,
     "k1": mk.trace_megakernel}[tracer](scene, rays, opts, 7, ks)
    assert len(calls) == 2
