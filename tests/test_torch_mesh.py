"""The port's OBJ loader and host pipeline (cpupathtrace_tpu_torch/scene/
mesh.py, native/, csrc/mesh_native.cpp) against the JAX package's: load_mesh
bit-equal on every input of tests/test_mesh.py and tests/test_native.py on
both parse routes (forced by NATIVE_PARSE_MIN_BYTES in each module), the C++
mesh pipeline bit-equal to the numpy body and to the JAX native pipeline,
the C++ packer bit-equal to the numpy packer, the stand-in OBJ text
byte-equal, the OBJ route's gap to the arrays route bounded in both
packages, and a failed build raising on every C++ route."""
import numpy as np
import pytest

import cpupathtrace_tpu.scene.mesh as jmesh
from cpupathtrace_tpu.models import scenes as jscenes
from cpupathtrace_tpu.native import get_lib
from cpupathtrace_tpu.native import mesh_pipeline_native as jax_mesh_pipeline_native
from cpupathtrace_tpu_torch import _build, native
from cpupathtrace_tpu_torch.accel import kernel_traverse as kt
from cpupathtrace_tpu_torch.models import scenes as tscenes
import cpupathtrace_tpu_torch.scene.mesh as tmesh

QUAD_OBJ = """
# a unit quad as two triangles
v 0 0 0
v 1 0 0
v 1 1 0
v 0 1 0
f 1 2 3
f 1 3 4
"""
FOLDED = "v 0 0 0\nv 1 0 0\nv 1 1 1\nv 0 1 0\nf 1 2 3\nf 1 3 4\n"
SCALE_SHIFT = np.array([[2.0, 0, 0, 1.0], [0, 2.0, 0, 0], [0, 0, 2.0, 0], [0, 0, 0, 1.0]])
DRAGON_TF = np.array([[0.01, 0, 0, 0], [0, 0.01, 0, -0.5], [0, 0, 0.01, 0], [0, 0, 0, 1.0]])


def _grid_obj(pad: bool) -> str:
    """test_native.py's 60 x 60 grid, padded with comments past 1 MB."""
    n = 60
    rows = [f"v {i*0.1:.6f} {j*0.1:.6f} {((i*j) % 7)*0.05:.6f}"
            for i in range(n) for j in range(n)]
    for i in range(n - 1):
        for j in range(n - 1):
            a = i * n + j + 1
            rows += [f"f {a} {a+1} {a+n}", f"f {a+1} {a+n+1} {a+n}"]
    text = "\n".join(rows) + "\n"
    if pad:
        text += "# pad\n" * (((1 << 20) - len(text)) // 6 + 2)
    return text


# name -> (source, load_mesh keyword arguments): every input of
# tests/test_mesh.py and tests/test_native.py.
CASES = {
    "empty": ("", {}),
    "blank_lines": ("\n\n   \n", {}),
    "comments": ("# comment only\n# another\n", {}),
    "quad": (QUAD_OBJ, {}),
    "face_attributes": ("v 0 0 0\nv 1 0 0\nv 0 1 0\nf 1/2/3 2/1/1 3/9/9\n", {}),
    "out_of_range": ("v 0 0 0\nv 1 0 0\nv 0 1 0\nf 1 2 4\n", {}),
    "duplicate_vertex": ("v 0 0 0\nv 1 0 0\nv 0 1 0\nf 1 1 2\n", {}),
    "collinear": ("v 0 0 0\nv 1 0 0\nv 2 0 0\nf 1 2 3\n", {}),
    "malformed_float": ("v x y z\nv 1 0 0\nv 0 1 0\nf 1 2 3\n", {}),
    "transform": (QUAD_OBJ, {"transformation": SCALE_SHIFT}),
    "quad_smooth": (QUAD_OBJ, {"smooth": True}),
    "folded_smooth": (FOLDED, {"smooth": True}),
    "folded_flat": (FOLDED, {"smooth": False}),
    "huge_index": ("v 0 0 0\nv 1 0 0\nv 0 1 0\nf 99999999999999999999999999 2 3\n", {}),
    "huge_float": ("v 1e99999 0 0\nv 1 0 0\nv 0 1 0\nf 1 2 3\n", {}),
    "huge_float_fast": ("v 1e400 0 0\nv 1 0 0\nv 0 1 0\nv 0 0 1\nf 1 2 3\nf 2 3 4\n", {}),
    "standin_dragon": (jscenes.standin_dragon_obj(20000),
                       {"transformation": DRAGON_TF, "cull_backface": False}),
    "native_records": ("# comment\nv 0 0 0\nv 1 0 0\nv 1 1 0\nv 0 1 0\nvn 0 0 1\nvt 0.5 0.5\n"
                       "f 1/1/1 2/2/1 3/3/1\nf 1 3 4\n", {}),
    "native_tolerant": ("v x y z\nf 1 2\n", {}),
    "grid": (_grid_obj(pad=False), {"smooth": True}),
    "grid_over_1mb": (_grid_obj(pad=True), {"smooth": True}),
}

ROUTES = {"python": 1 << 62, "native": 0}


@pytest.fixture
def route(request, monkeypatch):
    """Force one parse route in both packages."""
    assert get_lib() is not None, "the JAX package's native library did not build"
    for mod in (jmesh, tmesh):
        monkeypatch.setattr(mod, "NATIVE_PARSE_MIN_BYTES", ROUTES[request.param])
    return request.param


def bits(a):
    a = np.asarray(a)
    return a.dtype, a.shape, a.tobytes()


def assert_batches_equal(x, y):
    for f in ("v0", "v1", "v2", "n0", "n1", "n2", "cull", "material"):
        assert bits(getattr(x, f)) == bits(getattr(y, f)), f


def assert_lists_equal(x, y):
    assert len(x) == len(y)
    for s, t in zip(x, y):
        for f in ("a", "b", "c", "na", "nb", "nc"):
            assert bits(getattr(s, f)) == bits(getattr(t, f)), f
        assert (s.cull_backface, s.material) == (t.cull_backface, t.material)


@pytest.mark.parametrize("route", list(ROUTES), indirect=True)
@pytest.mark.parametrize("case", list(CASES))
def test_load_mesh_matches_jax(case, route):
    text, kw = CASES[case]
    runs = native.runs["parse_obj"]
    assert_lists_equal(tmesh.load_mesh(text, **kw), jmesh.load_mesh(text, **kw))
    assert_batches_equal(tmesh.load_mesh(text, as_batch=True, **kw),
                         jmesh.load_mesh(text, as_batch=True, **kw))
    took_native = route == "native" and len(text) > 0
    assert native.runs["parse_obj"] - runs == (2 if took_native else 0)


def test_load_mesh_takes_the_native_parser_above_1mb():
    runs = native.runs["parse_obj"]
    tmesh.load_mesh(_grid_obj(pad=False))
    assert native.runs["parse_obj"] == runs
    tmesh.load_mesh(_grid_obj(pad=True))
    assert native.runs["parse_obj"] == runs + 1


def test_load_mesh_sources(tmp_path):
    """A path, a file object, bytes and text give the same triangles; an
    unreadable path warns and is parsed as text, as in the JAX package."""
    import io

    path = tmp_path / "quad.obj"
    path.write_text(QUAD_OBJ)
    want = tmesh.load_mesh(QUAD_OBJ, as_batch=True)
    assert len(want) == 2
    for src in (str(path), path, io.StringIO(QUAD_OBJ), io.BytesIO(QUAD_OBJ.encode())):
        assert_batches_equal(tmesh.load_mesh(src, as_batch=True), want)
    with pytest.warns(UserWarning, match="not a readable path"):
        assert tmesh.load_mesh(str(tmp_path / "missing.obj")) == []
    bad = b"v 0 0 0\nv 1 0 0\nv 0 1 0\nf 1 2 3\n\xff\xfe\n"
    assert_lists_equal(tmesh.load_mesh(io.BytesIO(bad)), jmesh.load_mesh(io.BytesIO(bad)))


def _planted_arrays(seed=0):
    """The stand-in at ~100k faces with out-of-range, duplicate, collinear
    and NaN faces planted at random places."""
    verts, faces = tscenes.standin_dragon_arrays(100000)
    n_v = verts.shape[0]
    extra = np.array([[0, 0, 0], [1, 0, 0], [2, 0, 0], [np.nan, 0, 0]], np.float64)
    verts = np.concatenate([verts, extra])
    planted = np.array([
        [0, 1, n_v + 4], [-1, 1, 2], [0, 1, 1 << 40],  # out of range
        [5, 5, 6], [7, 8, 7], [9, 10, 10],  # duplicate vertices
        [n_v, n_v + 1, n_v + 2],  # collinear
        [n_v + 3, 1, 2], [3, n_v + 3, 4],  # a NaN vertex
    ], np.int64)
    rng = np.random.default_rng(seed)
    at = np.sort(rng.integers(0, faces.shape[0], planted.shape[0]))
    return verts, np.insert(faces, at, planted, axis=0), planted.shape[0]


@pytest.mark.parametrize("smooth", [True, False])
def test_mesh_pipeline_native_matches_numpy_and_jax(smooth):
    verts, faces, n_planted = _planted_arrays()
    runs = native.runs["mesh_pipeline"]
    got = native.mesh_pipeline_native(verts, faces, smooth)
    assert native.runs["mesh_pipeline"] == runs + 1
    plain = tmesh._mesh_pipeline_numpy(verts, faces, smooth)
    ref = jax_mesh_pipeline_native(verts, faces, smooth)
    clean = tmesh._mesh_pipeline_numpy(*tscenes.standin_dragon_arrays(100000), smooth)
    assert got[0].shape[0] == clean[0].shape[0]  # none of the planted faces kept
    for g, p, r in zip(got, plain, ref):
        assert bits(g) == bits(p) == bits(r)


@pytest.mark.parametrize("smooth", [True, False])
def test_mesh_from_arrays_routes_match_jax(smooth):
    """mesh_from_arrays from 65,536 faces (the C++ pipeline) and below it
    (numpy), each bit-equal to the JAX package's."""
    verts, faces, _ = _planted_arrays(seed=1)
    for n in (tmesh.MESH_NATIVE_MIN_FACES, tmesh.MESH_NATIVE_MIN_FACES - 1):
        runs = native.runs["mesh_pipeline"]
        kw = dict(transformation=DRAGON_TF, cull_backface=False, smooth=smooth, as_batch=True)
        got = tmesh.mesh_from_arrays(verts, faces[:n], **kw)
        assert native.runs["mesh_pipeline"] - runs == (n >= tmesh.MESH_NATIVE_MIN_FACES)
        assert_batches_equal(got, jmesh.mesh_from_arrays(verts, faces[:n], **kw))


def _cluster_arrays(c, l, seed):
    """Random [C, L, ...] cluster arrays: vertices either side of zero and
    a fifth of the slots padding (prim -1), so padding slots' signed zeros
    show."""
    rng = np.random.default_rng(seed)
    v = [rng.uniform(-1, 1, (c, l, 3)).astype(np.float32) for _ in range(3)]
    n = [rng.normal(size=(c, l, 3)).astype(np.float32) for _ in range(3)]
    prim = rng.integers(0, 1 << 20, (c, l)).astype(np.float32)
    prim[rng.random((c, l)) < 0.2] = -1.0
    cull = (rng.random((c, l)) < 0.5) & (prim >= 0)
    mat = rng.integers(0, 5, (c, l)).astype(np.float32)
    return v, n, cull, prim, mat


@pytest.mark.parametrize("c,l", [(1, 8), (37, 56), (1100, 56), (300, 128)])
def test_pack_pair_records_native_matches_numpy(c, l):
    (v0, v1, v2), (n0, n1, n2), cull, prim, mat = _cluster_arrays(c, l, seed=c)
    plain = np.zeros((c, l, kt.REC_COLS), np.float32)
    kt._pack_pair_records_batch(v0, v1, v2, cull.astype(np.float32), prim, n0, n1, n2, mat,
                                out=plain)
    got = np.zeros((c, l, kt.REC_COLS), np.float32)
    runs = native.runs["pack_pair_records"]
    assert native.pack_pair_records_native(v0, v1, v2, cull, prim, mat, n0, n1, n2, out=got)
    assert native.runs["pack_pair_records"] == runs + 1
    assert got.tobytes() == plain.tobytes()
    # Padding slots' v0 . N is a signed zero: some are -0.0.
    col15 = got[..., 15][prim < 0]
    assert (col15 == 0).all()
    if col15.size > 50:
        assert np.signbit(col15).any() and not np.signbit(col15).all()


def test_pack_kernel_tables_packs_through_native():
    """pack_kernel_tables_np's records: the C++ packer on the clusters,
    the padding clusters' prim -1, bit-equal to the numpy packer."""
    c, l = 45, 56
    (v0, v1, v2), (n0, n1, n2), cull, prim, mat = _cluster_arrays(c, l, seed=3)
    lo = np.minimum(np.minimum(v0, v1), v2).min(axis=1)
    hi = np.maximum(np.maximum(v0, v1), v2).max(axis=1)
    runs = native.runs["pack_pair_records"]
    rec, *_ = kt.pack_kernel_tables_np(v0, v1, v2, cull, prim, n0, n1, n2, mat, lo, hi)
    assert native.runs["pack_pair_records"] == runs + 1
    want = np.zeros_like(rec)
    kt._pack_pair_records_batch(v0, v1, v2, cull.astype(np.float32), prim, n0, n1, n2, mat,
                                out=want[:c])
    want[c:, :, kt.C_PRIM] = -1.0
    assert rec.shape == (kt.GROUP * 2, l, kt.REC_COLS)
    assert rec.tobytes() == want.tobytes()


@pytest.mark.parametrize("target,seed", [(3000, 7), (500, 3)])
def test_standin_dragon_obj_is_jax_text(target, seed):
    assert tscenes.standin_dragon_obj(target, seed) == jscenes.standin_dragon_obj(target, seed)


@pytest.mark.parametrize("pkg", ["jax", "port"])
def test_obj_route_gap_to_arrays_route(pkg, monkeypatch):
    """The native OBJ route reads float32 (strtof), the arrays route keeps
    the %.6f values in float64: the same faces, positions within 4 float32
    ulps and normals within 5e-4 (3 ulps and 2.2e-5 measured at 20k faces;
    3 ulps and 3.1e-4 at 200k), and the gap is not zero."""
    mod, sc = (jmesh, jscenes) if pkg == "jax" else (tmesh, tscenes)
    monkeypatch.setattr(mod, "NATIVE_PARSE_MIN_BYTES", 0)
    kw = dict(cull_backface=False, smooth=True, as_batch=True)
    via_text = mod.load_mesh(sc.standin_dragon_obj(20000), DRAGON_TF, **kw)
    verts, faces = sc.standin_dragon_arrays(20000)
    via_arrays = mod.mesh_from_arrays(verts, faces, DRAGON_TF, **kw)
    assert len(via_text) == len(via_arrays) > 19000
    moved = 0
    for f in ("v0", "v1", "v2"):
        a = np.asarray(getattr(via_text, f), np.float32)
        b = np.asarray(getattr(via_arrays, f), np.float32)
        ulps = np.abs(a.astype(np.float64) - b) / np.spacing(np.abs(b))
        assert ulps.max() <= 4, (f, ulps.max())
        moved += int((a != b).sum())
    assert moved > 0
    for f in ("n0", "n1", "n2"):
        assert np.abs(getattr(via_text, f) - getattr(via_arrays, f)).max() <= 5e-4, f


@pytest.fixture(params=["no_compiler", "compile_fails"])
def broken_build(request, monkeypatch, tmp_path):
    """A fresh build directory whose host build fails: g++ missing, or a
    compiler that exits non-zero."""
    monkeypatch.setattr(_build, "BUILD_DIR", tmp_path / "_build")
    monkeypatch.setattr(_build, "_LIBS", {})
    if request.param == "no_compiler":
        def missing():
            raise RuntimeError("g++ not found")
        monkeypatch.setattr(_build, "_gxx", missing)
    else:
        monkeypatch.setattr(_build, "_gxx", lambda: "false")
    return request.param


@pytest.mark.parametrize("call", ["load_mesh", "mesh_from_arrays", "pack_kernel_tables"])
def test_failed_build_raises(call, broken_build):
    """No C++ route falls back to Python: each raises when the library
    cannot be built."""
    runs = dict(native.runs)
    if call == "load_mesh":
        text = _grid_obj(pad=True)
        with pytest.raises(RuntimeError, match="g\\+\\+ not found|build failed"):
            tmesh.load_mesh(text)
    elif call == "mesh_from_arrays":
        verts, faces = tscenes.standin_dragon_arrays(70000)
        n = tmesh.MESH_NATIVE_MIN_FACES
        with pytest.raises(RuntimeError, match="g\\+\\+ not found|build failed"):
            tmesh.mesh_from_arrays(verts, faces[:n], as_batch=True)
    else:
        (v0, v1, v2), (n0, n1, n2), cull, prim, mat = _cluster_arrays(4, 8, seed=0)
        lo, hi = v0.min(axis=1), v0.max(axis=1)
        with pytest.raises(RuntimeError, match="g\\+\\+ not found|build failed"):
            kt.pack_kernel_tables_np(v0, v1, v2, cull, prim, n0, n1, n2, mat, lo, hi)
    assert native.runs == runs
