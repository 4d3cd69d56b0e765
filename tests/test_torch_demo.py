"""The port's demo app and inverse-rendering example
(cpupathtrace_tpu_torch/demo.py, examples/inverse_render.py) against the
JAX package's demo.py and examples/inverse_render.py: the same options
with the same defaults, and small runs on the CPU."""
import argparse
import os
import re
import subprocess
import sys

import numpy as np
import pytest
import torch

from cpupathtrace_tpu_torch import demo
from cpupathtrace_tpu_torch.examples import inverse_render
from cpupathtrace_tpu_torch.utils.image_io import read_rgb_image

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
APPS = {
    "demo": ("demo.py", "cpupathtrace_tpu_torch.demo"),
    "inverse_render": ("examples/inverse_render.py",
                       "cpupathtrace_tpu_torch.examples.inverse_render"),
}


def _usage_options(cmd):
    """The options and positionals of `cmd --help`'s usage block."""
    out = subprocess.run(cmd + ["--help"], cwd=ROOT, capture_output=True, text=True,
                         timeout=120, env=dict(os.environ, JAX_PLATFORMS="cpu"))
    assert out.returncode == 0, out.stderr
    usage = out.stdout.split("\n\n", 1)[0]
    assert usage.startswith("usage:"), out.stdout
    return set(re.findall(r"\[(--?[\w-]+)", usage)), re.findall(r"\[([a-z]\w*)\]", usage)


@pytest.mark.parametrize("app", list(APPS))
def test_help_lists_the_jax_options(app):
    """`--help` of the JAX script (it exits before importing JAX) and of
    the port's module list the same options and positionals."""
    script, module = APPS[app]
    jax_opts = _usage_options([sys.executable, script])
    assert jax_opts == _usage_options([sys.executable, "-m", module])
    assert "--cpu" in jax_opts[0]


class _Parsed(Exception):
    pass


def _parser_of(main, monkeypatch):
    """The ArgumentParser `main` builds, caught at its parse_args."""
    def capture(self, *args, **kwargs):
        raise _Parsed(self)

    monkeypatch.setattr(argparse.ArgumentParser, "parse_args", capture)
    with pytest.raises(_Parsed) as caught:
        main([])
    monkeypatch.undo()
    return {a.dest: (tuple(a.option_strings), a.default, a.type, a.nargs, type(a))
            for a in caught.value.args[0]._actions}


@pytest.mark.parametrize("app", list(APPS))
def test_defaults_follow_the_jax_scripts(app, monkeypatch):
    import importlib.util

    script, _ = APPS[app]
    spec = importlib.util.spec_from_file_location(f"jax_{app}", os.path.join(ROOT, script))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    jax_args = _parser_of(mod.main, monkeypatch)
    port_args = _parser_of(demo.main if app == "demo" else inverse_render.main, monkeypatch)
    if app == "inverse_render":
        # The JAX default is /tmp/inverse_render; the port's is under the
        # temporary directory the environment names.
        for args in (jax_args, port_args):
            opts, default, *rest = args["outdir"]
            args["outdir"] = (opts, os.path.basename(default), *rest)
    assert port_args == jax_args


def test_demo_writes_a_small_png(tmp_path):
    out = tmp_path / "demo.png"
    rc = demo.main([str(out), "--width", "8", "--height", "8", "--spp-min", "2",
                    "--spp-max", "2", "--max-depth", "4", "--no-dragon", "--cpu"])
    assert rc == 0
    img = read_rgb_image(str(out))
    assert img.shape == (8, 8, 4) and np.isfinite(img).all()


def test_demo_sharded_is_refused(tmp_path):
    """--sharded renders now (below); without --cpu it runs on the card,
    and with no card it raises rather than falling back to the CPU."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present")
    with pytest.raises(RuntimeError, match="CUDA"):
        demo.main([str(tmp_path / "x.png"), "--sharded", "--no-dragon", "--width", "8",
                   "--height", "8"])


def test_demo_sharded_renders_a_png_as_a_world_of_one(tmp_path):
    """--sharded without a launcher: a world of one on the CPU (gloo),
    through parallel.render_sharded_adaptive."""
    out = tmp_path / "sharded.png"
    res = subprocess.run(
        [sys.executable, "-m", "cpupathtrace_tpu_torch.demo", str(out), "--width", "8",
         "--height", "8", "--spp-min", "4", "--spp-max", "8", "--max-depth", "4",
         "--no-dragon", "--cpu", "--sharded"],
        cwd=ROOT, capture_output=True, text=True, timeout=180)
    assert res.returncode == 0, res.stderr
    assert "mesh (dp, sp) = (1, 1) over 1 rank(s)" in res.stderr
    img = read_rgb_image(str(out))
    assert img.shape == (8, 8, 4) and np.isfinite(img).all() and img[..., :3].mean() > 0


def test_demo_defaults_to_the_card(tmp_path):
    """Without --cpu the demo runs on the card; without one it raises."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present")
    with pytest.raises(RuntimeError, match="CUDA"):
        demo.main([str(tmp_path / "x.png"), "--no-dragon", "--width", "8", "--height", "8"])


def test_inverse_render_runs_on_the_cpu(tmp_path, capsys):
    rc = inverse_render.main([str(tmp_path), "--size", "8", "--steps", "2", "--spp", "2",
                              "--cpu"])
    out = capsys.readouterr().out
    first, last = map(float, re.search(r"loss: (\S+) -> (\S+)", out).groups())
    assert np.isfinite([first, last]).all() and first > 0
    err = float(re.search(r"max albedo error: (\S+)", out).group(1))
    assert rc == (0 if err < 0.2 else 1)
    for name in ("before.png", "target.png", "after.png"):
        assert read_rgb_image(str(tmp_path / name)).shape == (8, 8, 4)
