"""Regenerate tests/fixtures/torch_diff.npz: the JAX package's record-and-
replay forward (`trace_megakernel_diff`, its single-bounce Pallas kernel in
interpret mode on the CPU) and its replays, on the inputs of
tests/torch_util.py's DIFF_CASES, which tests/test_torch_diff.py holds the
port against without paying the interpret-mode compiles:

  * <case>_spec [n, 4], <case>_recs [D, n, n_drec]: the forward;
  * <case>_replay, <case>_fast [n, 3]: replay_spectrum and replay_fast of
    those records.

    JAX_PLATFORMS=cpu python tests/fixtures/make_torch_diff_fixtures.py
"""
import os
import sys

import jax

jax.config.update("jax_platforms", "cpu")

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__)))))

import numpy as np  # noqa: E402

from tests.torch_util import DIFF_CASES, jax_diff_records  # noqa: E402

OUT = os.path.join(os.path.dirname(os.path.abspath(__file__)), "torch_diff.npz")


def main():
    out = {}
    for case in DIFF_CASES:
        spec, recs, ref, fast = jax_diff_records(case)
        out.update({f"{case}_spec": spec, f"{case}_recs": recs,
                    f"{case}_replay": ref, f"{case}_fast": fast})
        print(case, recs.shape, float(spec[:, :3].mean()), flush=True)
    np.savez_compressed(OUT, **out)


if __name__ == "__main__":
    main()
