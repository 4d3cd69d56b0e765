"""Regenerate tests/fixtures/torch_megakernel.npz: the JAX megakernel's
spectra (interpret mode on the CPU) for the kernel-parity cases of
tests/torch_util.py:MEGAKERNEL_CASES, which tests/test_torch_megakernel.py
holds the torch twin against without paying ~35 s of interpret-mode
compile per case.

    JAX_PLATFORMS=cpu python tests/fixtures/make_torch_megakernel_fixtures.py
"""
import os
import sys

import jax

jax.config.update("jax_platforms", "cpu")

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__)))))

import numpy as np  # noqa: E402

from tests.torch_util import MEGAKERNEL_CASES, jax_megakernel  # noqa: E402

OUT = os.path.join(os.path.dirname(os.path.abspath(__file__)), "torch_megakernel.npz")


def main():
    spectra = {case: jax_megakernel(case) for case in MEGAKERNEL_CASES}
    np.savez_compressed(OUT, **spectra)
    for case, s in spectra.items():
        print(case, s.shape, float(s[:, :3].mean()))


if __name__ == "__main__":
    main()
