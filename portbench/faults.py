"""Faults planted in the program's adaptive film, for the controls of the
adaptive cells: each must make `correct` false where the cell's frames
freeze pixels (or, with `allow_bias`, select candidates).

    with planted("frozen_at_min"):
        ...  # the program's frames now carry the fault

`control.py` reads them on the card at a cell's own size; the CPU tests
plant them through pytest's monkeypatch (`FAULTS[name](monkeypatch.setattr)`).
"""
from __future__ import annotations

import contextlib


def _fold(patch, change):
    """Wraps the film's fold of stats batches: `change(state, min_sc)`
    returns (frozen, accepted) from the state the fold returned and the one
    it was given; the all-frozen flag follows them."""
    from cpupathtrace_tpu_torch.integrator import film

    real = film._apply_stats_batches

    def fold(s_b, coll_b, c0, pixel_sum, n_collected, frozen, accepted, remaining, stats_means,
             stats_valid, kb, min_sc, check):
        out = list(real(s_b, coll_b, c0, pixel_sum, n_collected, frozen, accepted, remaining,
                        stats_means, stats_valid, kb=kb, min_sc=min_sc, check=check))
        out[2], out[3] = change(out, (frozen, accepted), min_sc)
        out[7] = (out[2] | out[3]).all()
        return tuple(out)

    patch(film, "_apply_stats_batches", fold)


def frozen_at_min(patch):
    """Every pixel freezes once it holds min_spp samples, at the end of the
    launch that brings it there."""
    _fold(patch, lambda out, given, min_sc: (out[2] | (out[1] >= min_sc), out[3]))


def never_frozen(patch):
    """No pixel is ever accepted or frozen: every pixel takes max_spp."""
    _fold(patch, lambda out, given, min_sc: given)


def no_candidates(patch):
    """With `allow_bias`, the candidate selection is skipped: a pixel not
    accepted keeps its plain mean."""
    from cpupathtrace_tpu_torch.integrator import film

    patch(film, "_candidate_select", lambda means, valid, cbc, fallback, min_count: fallback)


FAULTS = {"frozen_at_min": frozen_at_min, "never_frozen": never_frozen,
          "no_candidates": no_candidates}


@contextlib.contextmanager
def planted(name: str):
    """The program with fault `name` planted, restored on exit."""
    saved = []

    def patch(obj, attr, value):
        saved.append((obj, attr, getattr(obj, attr)))
        setattr(obj, attr, value)

    try:
        FAULTS[name](patch)
        yield
    finally:
        for obj, attr, value in reversed(saved):
            setattr(obj, attr, value)
