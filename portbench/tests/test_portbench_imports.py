"""No module of the benchmark imports JAX or the JAX package (whole
top-level names), and the plain reference imports nothing of the program."""
from __future__ import annotations

import ast
from pathlib import Path

FORBIDDEN = {"jax", "jaxlib", "flax", "cpupathtrace_tpu"}
BENCH = Path(__file__).resolve().parents[1]


def _imports(path: Path):
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            yield from (a.name.split(".")[0] for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            yield node.module.split(".")[0]


def test_no_module_imports_jax_or_the_jax_package():
    files = list(BENCH.rglob("*.py"))
    assert len(files) > 20
    for f in files:
        assert not set(_imports(f)) & FORBIDDEN, f


def test_the_names_compare_whole():
    assert "cpupathtrace_tpu_torch".split(".")[0] not in FORBIDDEN


def test_reference_imports_nothing_of_the_program():
    for f in (BENCH / "reference").rglob("*.py"):
        assert "cpupathtrace_tpu_torch" not in set(_imports(f)), f
