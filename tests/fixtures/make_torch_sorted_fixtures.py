"""Regenerate tests/fixtures/torch_sorted.npz: the JAX package's Pallas
kernels of the binned path (interpret mode on the CPU) on the inputs of
tests/torch_util.py, which tests/test_torch_traverse.py and
tests/test_torch_sorted.py hold the port against without paying the
interpret-mode compiles (~1-2 minutes in all):

  * query_<case>_t / _p: cluster_intersect_kernel on QUERY_CASES;
  * bounce_states: [5, 18, 1024] states of four `_bounce_call`s from the
    fresh state of `sorted_rays` on the 1200-triangle dragon;
  * trace: trace_megakernel_sorted(sort=False), max_depth 4, same rays.

    JAX_PLATFORMS=cpu python tests/fixtures/make_torch_sorted_fixtures.py
"""
import os
import sys

import jax

jax.config.update("jax_platforms", "cpu")

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__)))))

import numpy as np  # noqa: E402

from tests.torch_util import (  # noqa: E402
    QUERY_CASES,
    jax_bounce_states,
    jax_cluster_query,
    jax_sorted_trace,
)

OUT = os.path.join(os.path.dirname(os.path.abspath(__file__)), "torch_sorted.npz")


def main():
    out = {}
    for case in QUERY_CASES:
        out[f"query_{case}_t"], out[f"query_{case}_p"] = jax_cluster_query(case)
        print(case, int((out[f"query_{case}_p"] >= 0).sum()), "hits", flush=True)
    out["bounce_states"] = jax_bounce_states()
    print("bounce_states", out["bounce_states"].shape, flush=True)
    out["trace"] = jax_sorted_trace()
    print("trace", float(out["trace"][:, :3].mean()), flush=True)
    np.savez_compressed(OUT, **out)


if __name__ == "__main__":
    main()
