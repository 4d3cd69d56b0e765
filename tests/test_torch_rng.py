"""The port's megakernel random stream (cpupathtrace_tpu_torch/integrator/
rng.py) is bit-equal to the JAX kernel's `_seed_rng` / `_next_u01`
(pallas_megakernel.py:96-138), including seeds where seed + pid * 1000003
overflows int32."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cpupathtrace_tpu.integrator.pallas_megakernel import _next_u01, _seed_rng
from cpupathtrace_tpu_torch.integrator import rng as trng
from tests import torch_util  # noqa: F401  (caps torch threads)


def _jax_block_state(seed: int, pid: int):
    """The TPU kernel's per-lane state of program `pid`: the int32 sum
    seed + pid * 1000003 wraps, then seeds the (64, 128) block."""
    s = jnp.int32(seed) + jnp.int32(pid) * jnp.int32(trng.PID_STRIDE)
    return np.asarray(_seed_rng(s, (trng.BLOCK_ROWS, trng.LANES))).reshape(-1)


@pytest.mark.parametrize(
    "seed,pid",
    [(0, 0), (1234, 0), (1234, 3), (2**31 - 2, 1), (2**31 - 1, 2147), (77, 9000)],
)
def test_seed_matches_jax(seed, pid):
    idx = torch.arange(pid * trng.BLOCK_RAYS, (pid + 1) * trng.BLOCK_RAYS)
    ours = trng.seed_rng(seed, idx).numpy().astype(np.uint32)
    np.testing.assert_array_equal(ours, _jax_block_state(seed, pid))


def test_seed_accepts_device_tensor():
    idx = torch.arange(trng.BLOCK_RAYS)
    a = trng.seed_rng(99, idx)
    b = trng.seed_rng(torch.tensor([99], dtype=torch.int32), idx)
    assert torch.equal(a, b)


@pytest.mark.parametrize("seed,pid", [(5, 0), (2**31 - 1, 7)])
def test_stream_matches_jax(seed, pid):
    idx = torch.arange(pid * trng.BLOCK_RAYS, (pid + 1) * trng.BLOCK_RAYS)
    st_t = trng.seed_rng(seed, idx)
    st_j = jnp.asarray(_jax_block_state(seed, pid))
    for _ in range(50):
        st_t, u_t = trng.next_u01(st_t)
        st_j, u_j = _next_u01(st_j)
        np.testing.assert_array_equal(st_t.numpy().astype(np.uint32), np.asarray(st_j))
        np.testing.assert_array_equal(u_t.numpy(), np.asarray(u_j))
    assert u_t.dtype == torch.float32
    assert 0.0 <= float(u_t.min()) and float(u_t.max()) < 1.0


def test_mul32_wraps_like_uint32():
    rng = np.random.default_rng(0)
    a = rng.integers(0, 2**32, 10000, dtype=np.uint64)
    for b in (0x85EBCA6B, 0xC2B2AE35, 2654435761):
        want = ((a * np.uint64(b)) & np.uint64(0xFFFFFFFF)).astype(np.int64)
        got = trng.mul32(torch.from_numpy(a.astype(np.int64)), b).numpy()
        np.testing.assert_array_equal(got, want)
