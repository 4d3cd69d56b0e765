"""The port's post-processing (cpupathtrace_tpu_torch/post.py): golden
parity with the compiled C++ reference at tests/test_post.py's tolerances,
and agreement with the JAX package's post_process on random images."""
import os
import struct

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cpupathtrace_tpu import post as jpost
from cpupathtrace_tpu_torch import post as tpost
from tests import torch_util  # noqa: F401  (caps torch threads)

GOLDEN_DIR = os.path.join(os.path.dirname(__file__), "golden")


def _read(name):
    with open(os.path.join(GOLDEN_DIR, name), "rb") as f:
        w, h = struct.unpack("ii", f.read(8))
        return np.frombuffer(f.read(), np.float32).reshape(h, w, 4)


def test_tone_map_and_post_process_match_reference_goldens():
    inp = _read("post_input_64x48.raw")
    np.testing.assert_allclose(
        tpost.tone_map(inp).numpy(), _read("post_tonemap_64x48.raw"),
        rtol=1e-4, atol=1e-5,
    )
    np.testing.assert_allclose(
        tpost.post_process(inp).numpy(), _read("post_processed_64x48.raw"),
        rtol=1e-4, atol=1e-5,
    )


def _random_image(h, w, seed):
    rng = np.random.default_rng(seed)
    img = rng.gamma(0.6, 0.4, size=(h, w, 4)).astype(np.float32)
    img[..., 3] = (rng.random((h, w)) > 0.1).astype(np.float32)
    img[: h // 4, : w // 4, :3] = 0.0  # black region: gamma must keep it black
    return img


@pytest.mark.parametrize("h,w,seed", [(48, 64, 0), (37, 53, 1), (8, 8, 2), (130, 70, 3)])
def test_post_process_matches_jax(h, w, seed):
    img = _random_image(h, w, seed)
    np.testing.assert_allclose(
        tpost.tone_map(img).numpy(), np.asarray(jpost.tone_map(jnp.asarray(img))),
        rtol=1e-5, atol=1e-6,
    )
    ours = tpost.post_process(torch.from_numpy(img)).numpy()
    ref = np.asarray(jpost.post_process(jnp.asarray(img)))
    np.testing.assert_allclose(ours, ref, rtol=1e-5, atol=1e-6)
    assert np.isfinite(ours).all()


def test_gamma_correct_matches_jax_and_keeps_black():
    img = _random_image(16, 16, 5)
    for gamma in (1.0, 1.8, 2.2):
        np.testing.assert_allclose(
            tpost.gamma_correct(img, gamma).numpy(),
            np.asarray(jpost.gamma_correct(jnp.asarray(img), gamma)),
            rtol=1e-6, atol=1e-7,
        )
    black = tpost.gamma_correct(np.zeros((4, 4, 4), np.float32)).numpy()
    assert np.all(black == 0.0)


def test_ceiling_recurrence_is_sorted_and_in_range():
    for pc in (64, 1000, 3072, 65536):
        n_seg = min(1024, pc)
        src = tpost._ceiling_sources(tpost._segment_weights(n_seg), pc)
        assert src.shape == (n_seg - 1,)
        assert np.all(np.diff(src) >= 0) and src.max() < pc
