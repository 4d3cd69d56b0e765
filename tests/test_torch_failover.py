"""The port's sharded resume and failover (integrator/checkpoint.py
`render_resumable(mesh=)`, parallel/failover.py) on gloo ranks on the CPU:
the JAX package's tests/test_checkpoint.py:80-162 with ranks in place of
meshes (tests/torch_util.py `failover_ranks`, a world of 2): a sharded
render interrupted after chunk 1 and resumed on the same mesh is bit-equal
to an uninterrupted one; a bad spp_chunk raises; in the elastic render
rank 1 loses its device after chunk 2, rank 0 fails over to the mesh of
itself alone, pings and resumes, without rendering a finished chunk again,
and the film has exactly spp samples in every pixel. `ping_mesh` returns
(False, t <= deadline + 1 s) when a peer never joins (`ping_ranks`). Both
refuse a mesh with an NCCL group of several ranks, where a lost peer would
block the collective instead of raising.
"""
import numpy as np
import pytest

from cpupathtrace_tpu_torch.parallel.distributed import spawn_ranks
from tests.torch_util import failover_ranks, ping_ranks

PING_DEADLINE_S = 2.0


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    return spawn_ranks(failover_ranks, 2, "gloo", args=(str(tmp_path_factory.mktemp("ck")),),
                       deadline_s=240, timeout_s=30)


def test_sharded_resume_bit_identical(ranks):
    for r in ranks:
        assert r["interrupted"]
        full_sum, full_count, sum_, count, chunks = r["resume"]
        assert chunks == 3
        np.testing.assert_array_equal(full_sum, sum_)
        np.testing.assert_array_equal(full_count, count)
        assert (count == 12).all() and full_sum[:, :3].mean() > 0.01
        np.testing.assert_array_equal(sum_, ranks[0]["resume"][2])


def test_sharded_resume_rejects_bad_chunk_divisibility(ranks):
    for r in ranks:
        assert "not divisible by the mesh's sample-parallel axis sp=2" in r["bad_chunk"]


def test_ping_healthy_mesh(ranks):
    for r in ranks:
        ok, dt = r["ping"]
        assert ok and dt < 5.0


def test_elastic_failover_resumes_on_smaller_mesh(ranks):
    survivor, lost = ranks
    kind, chunks, count, img = survivor["elastic"]
    assert kind == "done" and chunks == 4
    assert (count == 16).all()
    assert np.isfinite(img).all() and img[..., :3].mean() > 0.01
    # Rank 0 failed over from mesh 0 once (its peer left mid-chunk 3).
    assert [mi for mi, _ in survivor["failovers"]] == [0]
    # Chunks 1-2 on both ranks, chunk 3 interrupted, chunks 3-4 alone: no
    # finished chunk was rendered again.
    assert survivor["elastic_calls"] == 5
    assert lost["elastic"][0] == "exhausted" and "simulated device loss" in lost["elastic"][1]
    assert lost["elastic_calls"] == 2 and [mi for mi, _ in lost["failovers"]] == [0]


def test_ping_times_out_when_a_peer_never_joins(tmp_path):
    ok, dt = spawn_ranks(ping_ranks, 2, "gloo", args=(str(tmp_path), PING_DEADLINE_S),
                         deadline_s=120, timeout_s=30)[0]
    assert not ok and PING_DEADLINE_S <= dt <= PING_DEADLINE_S + 1.0


class _NcclMesh:
    """A (dp, sp) mesh whose sp group has two ranks on NCCL, as far as
    failover.py can see (this CPU build has no NCCL)."""
    mesh_dim_names = ("dp", "sp")

    def get_group(self, name):
        return name

    def get_coordinate(self):
        return [0, 0]


@pytest.mark.parametrize("entry", ["ping_mesh", "render_resumable_elastic"])
def test_failover_refuses_an_nccl_group(entry, monkeypatch):
    from cpupathtrace_tpu_torch.parallel import failover as pf

    monkeypatch.setattr(pf, "group_size", lambda group: 2 if group == "sp" else 1)
    monkeypatch.setattr(pf.dist, "get_backend", lambda group=None: "nccl")
    calls = []
    monkeypatch.setattr("cpupathtrace_tpu_torch.integrator.checkpoint.render_resumable",
                        lambda *a, **k: calls.append(a))
    with pytest.raises(ValueError, match="mesh dimension 'sp' runs nccl; failover needs gloo"):
        if entry == "ping_mesh":
            pf.ping_mesh(_NcclMesh(), timeout_s=1.0)
        else:
            pf.render_resumable_elastic(None, None, None, 4, "unused.ckpt", [_NcclMesh()])
    assert calls == []
