"""The plain reference's outputs for the fixed-count cells at their small
sizes (cells.py), held bit for bit to those that the reference gave before
it took adaptive frames and a configuration's own camera and tracer
(fixtures/reference_fixed.npz, written by make_reference_fixture.py from
that reference)."""
from __future__ import annotations

from pathlib import Path

import numpy as np
import pytest

from portbench.tests import make_reference_fixture as mk

FIXTURE = Path(__file__).resolve().parent / "fixtures" / "reference_fixed.npz"


@pytest.mark.parametrize("name", mk.CELLS)
def test_reference_reproduces_the_frozen_outputs(name, tmp_path):
    want = np.load(FIXTURE)
    got = mk.reference_outputs(name, tmp_path)
    assert set(got) == {k for k in want.files if k.startswith(name + "/")}
    for k, v in got.items():
        assert np.array_equal(np.asarray(v), want[k]), k
