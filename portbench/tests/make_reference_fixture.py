"""Writes the plain reference's outputs for the benchmark's fixed-count cells
at their small sizes (cells.py) on the CPU, so that a change to the
reference can be held to them bit for bit
(test_portbench_reference_fixture.py).

    python3 -m portbench.tests.make_reference_fixture OUT.npz

from the root of a checkout. Render cells: the reference's pixels and
entering counts of two frames at the pixels a check draws; box-grad: the
loss, the gradients and the entering counts of pass 0.
"""
from __future__ import annotations

import sys
import tempfile

import numpy as np

from portbench.entries import GradEntry, RenderEntry
from portbench.tests.cells import small_cell

SEED = 2**31 + 4077
CELLS = ("box-final", "dragonbox-final", "box-grad")


def reference_outputs(name: str, cache_dir) -> dict:
    """The reference's outputs of cell `name` at its small size, by key."""
    cell = small_cell(name, cache_dir)
    if cell.traffic["entry"] == "render":
        e = RenderEntry(cell, SEED, "cpu")
        e.outputs = [None] * 10
        frames, pixels = e.sample()
        vals = e.reference_frames(frames, pixels)
        out = {f"{name}/pixels": pixels, f"{name}/frames": np.asarray(frames)}
        for f, v in zip(frames, vals):
            out[f"{name}/frame{f}"] = v.numpy()
        out[f"{name}/entering"] = np.asarray(e.ref_entering, np.int64)
        return out
    e = GradEntry(cell, SEED, "cpu")
    e.setup()
    e.release()
    loss, grads = e.reference_pass(0)
    out = {f"{name}/loss": np.float64(loss), f"{name}/entering": np.asarray(e.ref_entering)}
    for k, g in grads.items():
        out[f"{name}/grad/{k}"] = g.numpy()
    return out


def main(argv=None) -> int:
    argv = sys.argv[1:] if argv is None else argv
    out = {}
    with tempfile.TemporaryDirectory() as tmp:
        for name in CELLS:
            out.update(reference_outputs(name, tmp))
    np.savez_compressed(argv[0], **out)
    return 0


if __name__ == "__main__":
    sys.exit(main())
