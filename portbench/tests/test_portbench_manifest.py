"""BENCHMARK.json against the benchmark's contract, and the discovery of
configurations, traffic and metrics by name, a throwaway one included."""
from __future__ import annotations

import json
import re
import shutil

import pytest

from portbench import run

from .cells import REPO, manifest, small_cell

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
LAYERS = {"film and dispatch", "gradient driver", "tracer drivers", "kernels", "device"}


def test_manifest_keys_names_and_units():
    m = manifest()
    assert set(m) == {"command", "paths", "run_seconds", "configs", "workloads", "end_to_end",
                      "per_layer"}
    assert m["paths"] == ["portbench"] and m["command"][-1] == "portbench.run"
    assert 1 <= m["run_seconds"] <= 51
    names = [x["name"] for k in ("configs", "workloads", "end_to_end", "per_layer") for x in m[k]]
    assert len(names) == len(set(names))
    for n in names:
        assert NAME.match(n), n
    for x in m["end_to_end"] + m["per_layer"]:
        assert UNIT.match(x["unit"]) and x["better"] in ("lower", "higher"), x
    e2e = {x["name"] for x in m["end_to_end"]}
    assert "setup_s" in e2e and all(0.01 <= x["bound"] <= 0.25 for x in m["end_to_end"])
    for x in m["per_layer"]:
        assert x["layer"] in LAYERS and x["moves"] in e2e, x
        assert set(x) <= {"name", "unit", "better", "source", "layer", "moves", "workloads"}
    for c in m["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert c["file"].startswith("portbench/configs/") and len(c["why"]) <= 200
    for w in m["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"} and len(w["why"]) <= 200
        assert w["chips"] == 1 and NAME.match(w["traffic"])


@pytest.mark.parametrize("name", [w["name"] for w in manifest()["workloads"]])
def test_each_cell_found_by_name_reports_its_metrics(name):
    cell = run.Cell(manifest(), name)
    e2e = {m["name"] for m in cell.end_to_end}
    assert "setup_s" in e2e and len(e2e) >= 2 and cell.per_layer
    assert set(cell.readers) == e2e | {m["name"] for m in cell.per_layer}
    assert all(callable(r.read) for r in cell.readers.values())
    assert cell.traffic["entry"] in ("render", "grad")
    assert set(cell.traffic["limits"]) and all(v > 0 for v in cell.traffic["limits"].values())


OWN_REFERENCE = '''"""A throwaway configuration whose module gives the reference its own
camera and tracer: the frozen ones, counted, the radiance times SCALE."""
from portbench.reference import film
from portbench.reference.scene import from_config

SCALE = {scale}
CALLS = {{"camera": 0, "tracer": 0}}


def program_scene(cfg, device, cache_dir):
    from cpupathtrace_tpu_torch.models.scenes import bench_box_scene, bench_camera

    return bench_box_scene(device=device), bench_camera(device=device)


def reference_scene(cfg, device):
    return from_config(cfg, device)


def reference_camera(cfg):
    pinhole = film.Pinhole(cfg["camera"])

    def camera(*args):
        CALLS["camera"] += 1
        return pinhole(*args)

    return camera


def reference_tracer(cfg, scene, dtype):
    tracer = film.triangle_tracer(scene, dtype)

    def run(origin, direction, state, max_depth, eps, params=None):
        CALLS["tracer"] += 1
        out, collected, entering = tracer(origin, direction, state, max_depth, eps, params)
        return out * SCALE, collected, entering

    return run
'''


@pytest.mark.parametrize("case", ["plain", "own_reference", "faulty_tracer"])
def test_a_cell_config_and_metric_added_as_files_only(case, tmp_path):
    """A later change adds a configuration, a traffic mix and a metric as new
    files and manifest entries; no file the benchmark has is edited. With
    "own_reference" the configuration's module gives its own reference
    camera and tracer and the traffic is adaptive (min_spp < max_spp); with
    "faulty_tracer" that tracer's radiance is 1% high, and the run is not
    correct."""
    root = tmp_path / "portbench"
    for d in ("configs", "traffic", "metrics"):
        shutil.copytree(REPO / "portbench" / d, root / d)
    cfg = json.loads((root / "configs" / "box.json").read_text())
    cfg["name"] = "box2"
    (root / "configs" / "box2.json").write_text(json.dumps(cfg))
    traffic = json.loads((root / "traffic" / "box-final.json").read_text())
    if case == "plain":
        shutil.copy(root / "configs" / "box.py", root / "configs" / "box2.py")
    else:
        (root / "configs" / "box2.py").write_text(
            OWN_REFERENCE.format(scale=1.0 if case == "own_reference" else 1.01))
        del traffic["spp"]
        traffic.update(min_spp=16, max_spp=64)
    (root / "traffic" / "box2-final.json").write_text(json.dumps(traffic))
    (root / "metrics" / "frames_in_window.py").write_text(
        '"""frames_in_window: frames the window completed."""\n\n\n'
        "def read(run):\n    return run.steps\n")
    m = manifest()
    m["configs"].append({**m["configs"][0], "name": "box2", "file": "portbench/configs/box2.json"})
    m["workloads"].append({"name": "box2-final", "config": "box2", "traffic": "box2-final",
                           "chips": 1, "why": "a throwaway cell"})
    m["end_to_end"].append({"name": "frames_in_window", "unit": "frames", "better": "higher",
                            "bound": 0.05, "source": "host_clock", "workloads": ["box2-final"]})
    cell = small_cell("box2-final", tmp_path / "cache", m, root)
    if case != "plain":
        cell.traffic.pop("spp")
    out = run.run_cell(cell, 5, 0.2, False, device="cpu")
    assert out["correct"] == (case != "faulty_tracer"), out["checks"]
    assert out["metrics"]["frames_in_window"]["value"] == out["attempted"] > 0
    assert set(out["metrics"]) == {"setup_s", "frames_in_window"}
    if case != "plain":
        calls = cell.module.CALLS
        # A camera call a launch, 4 launches a checked frame.
        frames = min(cell.traffic["check_frames"], out["attempted"])
        assert calls["camera"] == 4 * frames and calls["tracer"] >= 4 * frames, calls
