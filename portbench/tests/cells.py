"""Small versions of the benchmark's cells for the CPU tests: the same
configurations, traffic and metrics, at sizes a test run holds."""
from __future__ import annotations

import json
from pathlib import Path

from portbench import run

REPO = Path(__file__).resolve().parents[2]
SMALL = {
    "box-final": ({"width": 16, "height": 16, "spp": 64, "check_pixels": 64}, None),
    "dragonbox-final": ({"width": 16, "height": 16, "spp": 8, "check_pixels": 64}, 20000),
    "box-grad": ({"width": 16, "height": 16, "spp": 4}, None),
    "box-upstream": ({"width": 16, "height": 16, "spp": 32, "check_pixels": 64}, None),
    "box-adaptive": ({"width": 16, "height": 16, "check_pixels": 256}, None),
}


def manifest() -> dict:
    with open(REPO / "BENCHMARK.json") as f:
        return json.load(f)


def small_cell(name: str, cache_dir, manifest_=None, root=None) -> run.Cell:
    cell = run.Cell(manifest_ or manifest(), name, **({"root": root} if root else {}))
    traffic, tris = SMALL.get(name, SMALL["box-final"])
    cell.traffic.update(traffic)
    if tris is not None:
        cell.config["scene"]["dragon"]["tris"] = tris
    cell.cache_dir = Path(cache_dir)
    return cell
