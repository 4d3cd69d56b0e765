"""renderSceneBox: the program's scene and camera, and the reference's."""
from __future__ import annotations

from portbench.reference.scene import from_config


def program_scene(cfg: dict, device, cache_dir):
    from cpupathtrace_tpu_torch.models.scenes import bench_box_scene, bench_camera

    return bench_box_scene(device=device), bench_camera(device=device)


def reference_scene(cfg: dict, device):
    return from_config(cfg, device)
