"""The cornell configuration's reference on the CPU (where the program's
kernels are their plain twins), at a small size: 16x16 frames of its own
traffic (16-64 spp, allow_bias) over a 6,000-triangle stand-in dragon. A
sound run is correct and gives the program's pixels; the reference's lens
gives the program's camera rays and its sphere the twin's hits; the
bfloat16 control, the fault of no candidates, a pinhole in place of the
lens and the reference without its sphere are not correct."""
from __future__ import annotations

import numpy as np
import pytest
import torch

from portbench import control, entries, faults, run
from portbench.reference import film
from portbench.reference.lens import ThinLens
from portbench.reference.sphere import SphereGeometry
from portbench.tests.cells import manifest

SMALL_TRIS = 6000
SEED = 3_000_000_789


def small_cornell(cache_dir) -> run.Cell:
    cell = run.Cell(manifest(), "cornell-demo")
    cell.traffic.update({"width": 16, "height": 16, "check_pixels": 256})
    cell.config["scene"]["dragon"]["tris"] = SMALL_TRIS
    cell.cache_dir = cache_dir
    return cell


def _within(numbers, limits):
    return all(v <= limits[k] for k, v in numbers.items())


@pytest.fixture(scope="module")
def program_frames(tmp_path_factory):
    """Two frames of the program at the small size, and their entry."""
    e = entries.RenderEntry(small_cornell(tmp_path_factory.mktemp("cache")), SEED, "cpu")
    e.setup()
    e.step(0)
    e.step(1)
    e.release()
    return e


def test_the_small_cell_is_its_own_traffic():
    cell = small_cornell(None)
    tr = cell.traffic
    assert (tr["min_spp"], tr["max_spp"], tr["allow_bias"], tr["max_depth"]) == (16, 64, True, 40)
    assert cell.config["camera"]["aperture"] == "circular"


def test_a_sound_run_is_correct(tmp_path):
    out = run.run_cell(small_cornell(tmp_path), 3_000_000_123, 0.2, False, device="cpu")
    assert out["correct"], out["checks"]
    assert all(c["value"] < 1e-5 for c in out["checks"].values()), out["checks"]


def test_the_reference_gives_the_programs_pixels(program_frames):
    """Every pixel of both frames within 1e-5 of the program's: the lens,
    the sphere, the glass dragon, the stopping rule and the candidates."""
    e = program_frames
    for f, ref in zip((0, 1), e.reference_frames([0, 1], np.arange(e.width * e.height))):
        prog = e.outputs[f].reshape(-1, 4)[:, :3].astype(np.float64)
        assert float(entries.pixel_gaps(prog, ref).max()) < 1e-5


def test_the_lens_gives_the_programs_rays(tmp_path):
    from cpupathtrace_tpu_torch.camera.camera import shoot_rays
    from cpupathtrace_tpu_torch.models.scenes import cornell_demo_camera

    cfg = small_cornell(tmp_path).config
    x, y = (torch.as_tensor(v).repeat(3) for v in film.pixel_coords(16, 16))
    n = x.shape[0]
    gens = [torch.Generator().manual_seed(11) for _ in range(2)]
    rays = shoot_rays(cornell_demo_camera(256, 256, device="cpu"), x, y, 1 / 16, 1 / 16, gens[0])
    o, d = ThinLens(cfg["camera"])(gens[1], n, torch.arange(n), x, y, 16, 16)
    assert torch.equal(o, rays.origin) and torch.equal(d, rays.direction)
    assert float((o - o[0]).abs().max()) > 1e-3  # the aperture moves the origins
    assert torch.equal(torch.rand(4, generator=gens[0]), torch.rand(4, generator=gens[1]))


def test_the_reference_sphere_hits_as_the_twin(program_frames):
    """Random rays in the room: the nearest hit of the reference's
    triangles and sphere against the twin's binned geometry (spheres, the
    big pair record, the cluster walk): the same t, the sphere's rays the
    same shading normal and material."""
    from cpupathtrace_tpu_torch.integrator import megakernel as mk
    from cpupathtrace_tpu_torch.models.scenes import cornell_full_scene

    e = program_frames
    scene, hit = cornell_full_scene(e.cell.cache_dir, SMALL_TRIS, device="cpu")
    assert hit
    ctx = mk._Ctx(scene, mk.pack_tables(scene), e.options, torch.device("cpu"))
    g = torch.Generator().manual_seed(5)
    n = 4096
    o = torch.rand((n, 3), generator=g) * 1.8 - 0.9
    d = torch.randn((n, 3), generator=g)
    d = d / torch.sqrt(d[:, 0] * d[:, 0] + d[:, 1] * d[:, 1] + d[:, 2] * d[:, 2])[:, None]
    t_p, p_p, nx, ny, nz, mid = mk._nearest(ctx, *o.unbind(1), *d.unbind(1))
    ref = e.cell.module.reference_scene(e.cfg, "cpu")
    geo = SphereGeometry(ref)
    t_r, p_r, _, _ = geo.nearest(o, d)
    assert torch.equal(torch.isfinite(t_p), p_r >= 0)
    assert torch.allclose(t_p[p_r >= 0], t_r[p_r >= 0], rtol=1e-6, atol=0)
    on_sphere = p_r >= ref.tris.n_tri
    assert 200 < int(on_sphere.sum()) < n // 2
    assert torch.equal(mid[on_sphere], torch.full_like(mid[on_sphere], ref.material))
    assert torch.equal(t_p[on_sphere], t_r[on_sphere])
    h = geo.hit_vector[on_sphere]
    normal = h * torch.rsqrt(h[:, 0] * h[:, 0] + h[:, 1] * h[:, 1] + h[:, 2] * h[:, 2]
                             + 1e-30)[:, None]
    assert torch.equal(normal, torch.stack([nx, ny, nz], 1)[on_sphere])


def test_the_bfloat16_control_fails(tmp_path):
    cell = small_cornell(tmp_path)
    nums = control.render_control(cell, 2_900_000_001, "cpu")
    assert not _within(nums, cell.traffic["limits"]), nums


def test_no_candidates_is_not_correct(tmp_path, monkeypatch):
    faults.FAULTS["no_candidates"](monkeypatch.setattr)
    out = run.run_cell(small_cornell(tmp_path), 3_000_000_321, 0.2, False, device="cpu")
    assert not out["correct"], out["checks"]


def _reference_numbers(e, frames=(0, 1)):
    """The window's frames checked against the reference as it stands."""
    frames, pixels = list(frames), np.arange(e.width * e.height)
    prog = [e.outputs[f].reshape(-1, 4)[pixels, :3].astype(np.float64) for f in frames]
    return entries.render_numbers(prog, e.reference_frames(frames, pixels))


def test_a_pinhole_in_place_of_the_lens_is_not_correct(program_frames, monkeypatch):
    e = program_frames
    monkeypatch.setattr(e.cell.module, "reference_camera", lambda cfg: film.Pinhole(cfg["camera"]))
    assert not _within(_reference_numbers(e), e.tr["limits"])


def test_the_reference_without_its_sphere_is_not_correct(program_frames, monkeypatch):
    e = program_frames
    monkeypatch.setattr(e.cell.module, "reference_tracer",
                        lambda cfg, scene, dtype: film.triangle_tracer(scene.tris, dtype))
    monkeypatch.setattr(e, "_ref", None)
    assert not _within(_reference_numbers(e), e.tr["limits"])
