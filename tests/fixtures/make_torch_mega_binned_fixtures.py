"""Regenerate tests/fixtures/torch_mega_binned.npz: the JAX package's
megakernels (interpret mode on the CPU) on the inputs of tests/torch_util.py,
which tests/test_torch_megakernel_binned.py and tests/test_torch_sorted.py
hold the port against without paying the interpret-mode compiles:

  * mega_binned: trace_megakernel in its binned while-loop form on
    `mega_binned_rays` (512 rays) and the 1200-triangle dragon, max_depth 4;
  * sorted_box: trace_megakernel_sorted on the box (a dense scene) with
    make_rays("sphere_dirs", 1024), max_depth 4, the sort on.

    JAX_PLATFORMS=cpu python tests/fixtures/make_torch_mega_binned_fixtures.py
"""
import os
import sys

import jax

jax.config.update("jax_platforms", "cpu")

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__)))))

import numpy as np  # noqa: E402

from tests.torch_util import jax_megakernel_binned, jax_sorted_box_trace  # noqa: E402

OUT = os.path.join(os.path.dirname(os.path.abspath(__file__)), "torch_mega_binned.npz")


def main():
    out = {"mega_binned": jax_megakernel_binned()}
    print("mega_binned", float(out["mega_binned"][:, :3].mean()), flush=True)
    out["sorted_box"] = jax_sorted_box_trace()
    print("sorted_box", float(out["sorted_box"][:, :3].mean()), flush=True)
    np.savez_compressed(OUT, **out)


if __name__ == "__main__":
    main()
