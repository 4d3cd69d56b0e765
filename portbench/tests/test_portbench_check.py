"""The comparison that decides `correct`, run through the harness on the
CPU (where the program's kernels are their plain twins) at small sizes: a
sound run is correct; the control (the reference in bfloat16 in the
program's place) and each fault planted in the timed path are not."""
from __future__ import annotations

import pytest
import torch

from portbench import control, run
from portbench.tests.cells import SMALL, manifest, small_cell

CELLS = list(SMALL)


def _within(numbers, limits):
    return all(v <= limits[k] for k, v in numbers.items())


@pytest.mark.parametrize("name", CELLS)
def test_sound_run_is_correct(name, tmp_path):
    cell = small_cell(name, tmp_path)
    out = run.run_cell(cell, 3_000_000_123, 0.3, False, device="cpu")
    assert out["correct"], out["checks"]
    assert all(c["value"] < 1e-5 for c in out["checks"].values()), out["checks"]
    assert list(out)[-1] == "checks"


@pytest.mark.parametrize("name", CELLS)
def test_bfloat16_control_fails(name, tmp_path):
    cell = small_cell(name, tmp_path)
    if cell.traffic["entry"] == "render":
        nums = control.render_control(cell, 2_900_000_001, "cpu")
    else:
        nums = control.grad_control_bf16(cell, 2_900_000_001, "cpu")
    assert not _within(nums, cell.traffic["limits"]), nums


def _state_unchanged(monkeypatch):
    """The bounce returns the path state as it found it, rays all alive."""
    from cpupathtrace_tpu_torch.integrator import megakernel, sorted_wavefront

    def frozen(ctx, depth, s, rec=None):
        n = s["ox"].shape[0]
        if rec is not None:
            z = torch.zeros(n)
            rec.extend([torch.full((n,), -1.0), z, z] + [z] * ctx.nee_lights
                       + [z, z] * ctx.nee_draws)
        return torch.ones(n, dtype=torch.bool)

    monkeypatch.setattr(megakernel, "_bounce", frozen)
    monkeypatch.setattr(sorted_wavefront, "_bounce", frozen)


def _wrap_trace(monkeypatch, change):
    from cpupathtrace_tpu_torch.integrator import film

    real = film._dispatch_trace

    def traced(*a, **k):
        spectrum, collected = real(*a, **k)
        return change(spectrum, collected)

    monkeypatch.setattr(film, "_dispatch_trace", traced)


def _half_left_out(monkeypatch):
    """The second half of every launch's samples is dropped; the pixels'
    means are taken over the rest."""
    def change(spectrum, collected):
        keep = torch.arange(collected.shape[0]) < collected.shape[0] // 2
        return torch.where(keep[:, None], spectrum, 0.0), collected & keep

    _wrap_trace(monkeypatch, change)


def _answer_altered(monkeypatch):
    """Each path's radiance comes out 1% high where the tracer makes it."""
    def change(spectrum, collected):
        return torch.cat([spectrum[:, :3] * 1.01, spectrum[:, 3:]], 1), collected

    _wrap_trace(monkeypatch, change)


FAULTS = {"state_unchanged": _state_unchanged, "half_left_out": _half_left_out,
          "answer_altered": _answer_altered}


@pytest.mark.parametrize("fault", list(FAULTS))
@pytest.mark.parametrize("name", CELLS)
def test_planted_fault_is_not_correct(name, fault, tmp_path, monkeypatch):
    cell = small_cell(name, tmp_path)
    FAULTS[fault](monkeypatch)
    out = run.run_cell(cell, 3_000_000_321, 0.2, False, device="cpu")
    assert not out["correct"], out["checks"]


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return "cuda"


@pytest.mark.cuda
def test_tf32_control_fails_on_the_card(card, tmp_path):
    """At the cell's own size: TF32's error in the replay's products grows
    with the pass (1.2e-5 at 64x64x16, 1.3e-3 at 512x512x16)."""
    cell = run.Cell(manifest(), "box-grad")
    cell.cache_dir = tmp_path
    nums = control.grad_program(cell, 2_900_000_002, card, tf32=True)
    assert not _within(nums, cell.traffic["limits"]), nums
    assert _within(control.grad_program(cell, 2_900_000_002, card, tf32=False),
                   cell.traffic["limits"])


@pytest.mark.cuda
@pytest.mark.parametrize("name", CELLS)
def test_sound_run_is_correct_on_the_card(name, card, tmp_path):
    cell = small_cell(name, tmp_path)
    assert run.run_cell(cell, 3_000_000_555, 0.5, False, device=card)["correct"]
