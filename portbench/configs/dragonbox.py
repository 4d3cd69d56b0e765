"""renderSceneDragonBox at the upstream dragon's triangle count: the
program's scene (through its scene cache under `cache_dir`) and camera, and
the reference's."""
from __future__ import annotations

from portbench.reference.scene import from_config


def program_scene(cfg: dict, device, cache_dir):
    from cpupathtrace_tpu_torch.models.scenes import bench_camera, dragon_full_scene

    scene, _ = dragon_full_scene(cache_dir, dragon_tris=cfg["scene"]["dragon"]["tris"],
                                 device=device)
    return scene, bench_camera(device=device)


def reference_scene(cfg: dict, device):
    return from_config(cfg, device)
