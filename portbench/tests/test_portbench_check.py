"""The comparison that decides `correct`, run through the harness on the
CPU (where the program's kernels are their plain twins) at small sizes: a
sound run is correct; the control (the reference in bfloat16 in the
program's place) and each fault planted in the timed path are not."""
from __future__ import annotations

import numpy as np
import pytest
import torch

from portbench import control, entries, faults, run
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


def _adaptive_cell(tmp_path, allow_bias):
    cell = small_cell("box-adaptive", tmp_path)
    cell.traffic["allow_bias"] = allow_bias
    return cell


@pytest.mark.parametrize("allow_bias", [False, True])
def test_adaptive_reference_gives_the_programs_pixels(allow_bias, tmp_path):
    """16x16 at 16-64 spp: every pixel of two frames, the stopping rule's
    frozen pixels and (with allow_bias) the candidates' values, as the
    program gives them."""
    cell = _adaptive_cell(tmp_path, allow_bias)
    e = entries.RenderEntry(cell, 3_000_000_789, "cpu")
    e.setup()
    e.step(0)
    e.step(1)
    e.release()
    pixels = np.arange(e.width * e.height)
    for f, ref in zip((0, 1), e.reference_frames([0, 1], pixels)):
        prog = e.outputs[f].reshape(-1, 4)[:, :3].astype(np.float64)
        assert float(entries.pixel_gaps(prog, ref).max()) < 1e-5


def test_adaptive_frames_freeze_some_pixels_and_not_others(tmp_path, monkeypatch):
    """The small adaptive cell exercises both sides of the stopping rule,
    so that each adaptive fault below has pixels to change."""
    from portbench.reference import film

    e = entries.RenderEntry(_adaptive_cell(tmp_path, False), 3_000_000_789, "cpu")
    seen = []
    real = film.fold_batch

    def fold(st, *a):
        real(st, *a)
        seen.append(int(st["frozen"].sum()))

    monkeypatch.setattr(film, "fold_batch", fold)
    e.reference_frames([0], np.arange(e.width * e.height))
    assert 0 < seen[-1] < e.width * e.height, seen


ADAPTIVE_FAULTS = [("frozen_at_min", False), ("never_frozen", False), ("never_frozen", True),
                   ("no_candidates", True)]


@pytest.mark.parametrize("fault,allow_bias", ADAPTIVE_FAULTS)
def test_adaptive_fault_is_not_correct(fault, allow_bias, tmp_path, monkeypatch):
    cell = _adaptive_cell(tmp_path, allow_bias)
    faults.FAULTS[fault](monkeypatch.setattr)
    out = run.run_cell(cell, 3_000_000_321, 0.2, False, device="cpu")
    assert not out["correct"], out["checks"]


@pytest.mark.parametrize("fault", ["frozen_at_min", "never_frozen"])
def test_adaptive_fault_planted_for_the_card_controls_is_undone(fault, tmp_path):
    """`faults.planted`, as control.py plants a fault on the card: frames
    inside fail, the program is whole again after."""
    cell = _adaptive_cell(tmp_path, False)
    with faults.planted(fault):
        assert not _within(control.render_sound(cell, 11, "cpu"), cell.traffic["limits"])
    assert _within(control.render_sound(cell, 11, "cpu"), cell.traffic["limits"])


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return "cuda"


@pytest.mark.cuda
def test_gradient_controls_fail_on_the_card(card, tmp_path):
    """At the cell's own size: the pass with its gradients rounded to
    bfloat16 fails grad_gap, the sound pass does not. (The control with
    TF32 on went with the replay's matrix products: the vjp kernel runs
    none.)"""
    cell = run.Cell(manifest(), "box-grad")
    cell.cache_dir = tmp_path
    nums = control.grad_program(cell, 2_900_000_002, card, round_bf16=True)
    assert nums["grad_gap"] > cell.traffic["limits"]["grad_gap"], nums
    assert _within(control.grad_program(cell, 2_900_000_002, card), cell.traffic["limits"])


@pytest.mark.cuda
@pytest.mark.parametrize("name", CELLS)
def test_sound_run_is_correct_on_the_card(name, card, tmp_path):
    cell = small_cell(name, tmp_path)
    assert run.run_cell(cell, 3_000_000_555, 0.5, False, device=card)["correct"]
