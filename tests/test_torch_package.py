"""The port stands alone: neither the package nor chip_smoke.py imports jax
or the JAX package (an AST scan; sys.modules cannot tell, since the test
process imports jax anyway)."""
import ast
import os

import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PKG = os.path.join(ROOT, "cpupathtrace_tpu_torch")
FORBIDDEN = ("jax", "jaxlib", "cpupathtrace_tpu")


def _sources():
    out = [os.path.join(ROOT, "chip_smoke.py")]
    for d, _, files in os.walk(PKG):
        out += [os.path.join(d, f) for f in files if f.endswith(".py")]
    return sorted(out)


def _imported_roots(path):
    with open(path) as f:
        tree = ast.parse(f.read(), path)
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for a in node.names:
                yield a.name.split(".")[0]
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            yield node.module.split(".")[0]
        elif isinstance(node, ast.Call) and getattr(node.func, "attr", "") == "import_module":
            for arg in node.args:
                if isinstance(arg, ast.Constant) and isinstance(arg.value, str):
                    yield arg.value.split(".")[0]


def test_sources_found():
    srcs = _sources()
    assert os.path.exists(srcs[0]) and len(srcs) > 15
    # The binned path's modules are among the scanned sources.
    rel = {os.path.relpath(p, PKG) for p in srcs[1:]}
    assert {"accel/build.py", "accel/cluster.py", "accel/kernel_traverse.py",
            "integrator/sorted_wavefront.py", "scene/mesh.py"} <= rel, rel
    # ... and the gradient path's.
    assert {"ops/intersect.py", "ops/surface.py", "bsdf/bsdf.py", "scene/lights.py",
            "core/debug.py", "utils/color.py", "integrator/wavefront.py",
            "integrator/diff_megakernel.py", "diff/render.py"} <= rel, rel
    # ... and the microbenchmarks'.
    assert {"experiments/__init__.py", "experiments/supscan.py",
            "experiments/record_variants.py", "experiments/smem_tables.py",
            "experiments/cond_fat.py", "experiments/dot_formulations.py"} <= rel, rel
    # ... and the sweeps that chose the kernels' shapes.
    assert {"experiments/dense_sweep.py", "experiments/query_sweep.py",
            "experiments/intersect_sweep.py", "experiments/cluster_major_sweep.py"} <= rel, rel
    # ... and K8's stage.
    assert "accel/cluster_major.py" in rel, rel
    # ... and checkpoint / resume and the scene cache.
    assert {"integrator/checkpoint.py", "scene/cache.py"} <= rel, rel
    # ... and the host pipeline, the demo app and the example.
    assert {"native/__init__.py", "demo.py", "examples/inverse_render.py"} <= rel, rel
    # ... and the benchmark runner.
    assert "bench.py" in rel, rel
    # ... and profiling and the roofline.
    assert {"utils/profiling.py", "utils/roofline.py"} <= rel, rel
    # ... and the sharded paths and their scaling harness.
    assert {"parallel/__init__.py", "parallel/mesh.py", "parallel/render.py",
            "parallel/geometry.py", "parallel/train.py", "parallel/distributed.py",
            "parallel/failover.py", "experiments/bench_scaling.py"} <= rel, rel


@pytest.mark.parametrize("path", _sources(), ids=lambda p: os.path.relpath(p, ROOT))
def test_no_jax_imports(path):
    bad = [m for m in _imported_roots(path) if m in FORBIDDEN]
    assert not bad, (path, bad)


def test_top_level_import_leaves_parallel_out():
    """As the JAX package's __init__ does not import parallel/, the port's
    does not: a plain import never loads the sharded paths."""
    import subprocess
    import sys

    code = ("import sys, cpupathtrace_tpu_torch; "
            "print(any(m.startswith('cpupathtrace_tpu_torch.parallel') for m in sys.modules))")
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT, capture_output=True, text=True,
                         timeout=120)
    assert out.returncode == 0 and out.stdout.strip() == "False", out.stderr


def test_public_names_follow_the_jax_package():
    import cpupathtrace_tpu
    import cpupathtrace_tpu_torch

    extra = set(cpupathtrace_tpu_torch.__all__) - set(cpupathtrace_tpu.__all__)
    assert extra == {"scene_from_numpy", "material_params_from_numpy"}
    for name in cpupathtrace_tpu_torch.__all__:
        assert hasattr(cpupathtrace_tpu_torch, name), name


def test_kernel_sources_ship_without_binaries():
    csrc = os.path.join(PKG, "csrc")
    names = os.listdir(csrc)
    assert {"megakernel.cu", "bounce.cu", "bounce_body.cuh", "cluster_query.cu",
            "cluster_traverse.cuh", "bvh_build.cpp", "dense_query.cu", "binned_geo.cuh",
            "exp_supscan.cu", "exp_record_variants.cu", "exp_smem_tables.cu",
            "exp_cond_fat.cu", "exp_dot_formulations.cu", "mma_tf32.cuh",
            "bulk_copy.cuh", "binned_isect.cu", "cluster_major.cu", "mesh_native.cpp"} <= set(names)
    assert not [n for n in names if n.endswith((".so", ".o", ".cubin"))]
