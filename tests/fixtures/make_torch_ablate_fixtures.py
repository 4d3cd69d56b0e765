"""Regenerate tests/fixtures/torch_ablate.npz: the JAX package's megakernels
(interpret mode on the CPU) under its ablation switches PTX_ABLATE and
PTX_SKIP_TRAVERSE, which tests/test_torch_ablate.py holds the port's twin
against. The JAX package reads both switches at import and its jit keeps
what it traced, so each setting of tests/torch_util.py ABLATE_SETTINGS runs
in a process of its own with the environment set before JAX is imported:

  * box_<setting>: trace_megakernel on the box (the pair-record form) with
    MEGAKERNEL_CASES["box"]'s 8192 rays, max_depth 3;
  * dragon_<setting>: trace_megakernel in its binned while-loop form on
    `mega_binned_rays` and the ABLATE_TRIS-triangle dragon, max_depth 4;
  * bounce_<setting>_<d>: [2, 18, 1024] the states before and after the
    single-bounce kernel `_bounce_call` at depth d on the 1200-triangle
    dragon: at depth 0 from the fresh state of `sorted_rays`, then at depth
    5 (the roulette on) from the state that bounce left.

    JAX_PLATFORMS=cpu python tests/fixtures/make_torch_ablate_fixtures.py
"""
import os
import subprocess
import sys
import tempfile

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
OUT = os.path.join(os.path.dirname(os.path.abspath(__file__)), "torch_ablate.npz")


def run_setting(setting, out_path):
    """Every output of `setting`, in this process (its environment already
    holds the switches), saved to `out_path`."""
    import jax

    jax.config.update("jax_platforms", "cpu")
    sys.path.insert(0, ROOT)
    import numpy as np

    from tests.torch_util import (
        ABLATE_BOUNCE_DEPTHS,
        ABLATE_CASES,
        ABLATE_TRIS,
        jax_bounce_states,
        jax_megakernel,
        jax_megakernel_binned,
    )

    out = {}
    if setting in ABLATE_CASES["box"]:
        out[f"box_{setting}"] = jax_megakernel("box")
    if setting in ABLATE_CASES["dragon"]:
        out[f"dragon_{setting}"] = jax_megakernel_binned(ABLATE_TRIS)
    if setting in ABLATE_CASES["bounce"]:
        states = jax_bounce_states(depths=ABLATE_BOUNCE_DEPTHS)
        for k, d in enumerate(ABLATE_BOUNCE_DEPTHS):
            out[f"bounce_{setting}_{d}"] = states[k:k + 2]
    for k, v in out.items():
        print(setting, k, v.shape, flush=True)
    np.savez(out_path, **out)


def main():
    sys.path.insert(0, ROOT)
    import numpy as np

    from tests.torch_util import ABLATE_SETTINGS

    out = {}
    with tempfile.TemporaryDirectory() as tmp:
        # Three settings at a time (each interpret-mode process holds a few GB).
        settings = list(ABLATE_SETTINGS.items())
        for wave in (settings[:3], settings[3:]):
            procs = []
            for setting, (ablate, skip) in wave:
                env = dict(os.environ, JAX_PLATFORMS="cpu", PTX_ABLATE=ablate,
                           PTX_SKIP_TRAVERSE=skip)
                path = os.path.join(tmp, f"{setting}.npz")
                procs.append((path, subprocess.Popen(
                    [sys.executable, os.path.abspath(__file__), setting, path], env=env)))
            for path, proc in procs:
                if proc.wait() != 0:
                    raise SystemExit(f"{path}: rc {proc.returncode}")
                out.update(np.load(path))
    np.savez_compressed(OUT, **out)
    print(OUT, sorted(out), flush=True)


if __name__ == "__main__":
    if len(sys.argv) == 3:
        run_setting(sys.argv[1], sys.argv[2])
    else:
        main()
