"""Built-in scenes: the dense ones of `cpupathtrace_tpu/models/scenes.py`.

  * cornell_demo_scene(include_dragon=False): the demo app's Cornell-box
    scene without its glass dragon: coloured walls, emissive ceiling panel,
    blue mirror sphere, rotated stretched white box (ref: demo/main.cpp:36-205)
  * bench_box_scene: the closed 2x2x2 box of the reference's renderSceneBox
    benchmark, 12 wall triangles + 2 emissive ceiling triangles
    (ref: benchmark/main.cpp:34-57)

The dragon scenes are binned: ROADMAP.md Queue 1 slice 2.
"""
from __future__ import annotations

import math

import numpy as np

from ..camera.camera import APERTURE_CIRCULAR, Camera, make_camera
from ..core.config import RenderOptions
from ..scene.geometry import make_box, make_plane, transform_triangles
from ..scene.scene import BSDF_MIRROR, SceneBuilder, SceneData


def cornell_demo_camera(width: int = 256, height: int = 256, device="cpu") -> Camera:
    """The demo camera: thin lens, circular aperture 0.05, focal plane 3.5,
    negative aspect ratio (ref: demo/main.cpp:36-48)."""
    return make_camera(
        origin=(0.0, 0.0, -3.0),
        look_at=(0.0, 0.0, 0.0),
        up=(0.0, 1.0, 0.0),
        focal_length=1.0,
        height=1.0,
        aspect_ratio=-(width / height),
        aperture_width=0.05,
        aperture_height=0.05,
        aperture=APERTURE_CIRCULAR,
        focal_plane_dist=3.5,
        device=device,
    )


def cornell_demo_scene(
    dragon_obj: str | None = None,
    dragon_tris: int = 20000,
    include_dragon: bool = True,
    device="cpu",
) -> SceneData:
    """The demo scene (ref: demo/main.cpp:50-205). Only
    `include_dragon=False` builds in the port: the dragon makes the scene
    binned."""
    if include_dragon:
        raise NotImplementedError(
            "the demo's dragon makes the scene binned: ROADMAP.md Queue 1 "
            "slice 2 (items 9-12); use include_dragon=False"
        )
    b = SceneBuilder()
    epsilon = 1e-3
    light_intensity = 1.0
    ground_y, ceiling_y = -1.0, 1.0
    walls_x, walls_z = 1.0, 1.0

    white = b.add_material(diffuse=(1, 1, 1, 1))
    blue = b.add_material(diffuse=(0, 0, 1, 1))
    red = b.add_material(diffuse=(1, 0, 0, 1))
    green = b.add_material(diffuse=(0, 1, 0, 1))
    light = b.add_material(
        diffuse=(1, 1, 1, 1),
        emission=(light_intensity, light_intensity, light_intensity, 1.0),
    )

    b.add_triangles(make_plane((20, ground_y, -20), (-20, ground_y, 20), True), white)
    b.add_triangles(make_plane((-20, ceiling_y, -20), (20, ceiling_y, 20), True), white)
    b.add_triangles(
        make_plane((-0.25, ceiling_y - epsilon, -0.25), (0.25, ceiling_y - epsilon, 0.25), True),
        light,
    )
    b.add_triangles(make_plane((-walls_x, ground_y, -walls_z), (walls_x, ceiling_y, -walls_z), True), blue)
    b.add_triangles(make_plane((-walls_x, ground_y, -walls_z), (-walls_x, ceiling_y, walls_z), True), red)
    b.add_triangles(make_plane((walls_x, ground_y, walls_z), (-walls_x, ceiling_y, walls_z), True), white)
    b.add_triangles(make_plane((walls_x, ground_y, walls_z), (walls_x, ceiling_y, -walls_z), True), green)

    # Blue mirror sphere (ref: demo/main.cpp:168-177).
    mirror_blue = b.add_material(diffuse=(0, 0, 1, 1), bsdf=BSDF_MIRROR)
    b.add_sphere((0.5, -0.5, 0.5), 0.5, mirror_blue)

    # Rotated, vertically stretched white box (ref: demo/main.cpp:179-203).
    rot_y = 0.25
    c, s = math.cos(rot_y), math.sin(rot_y)
    transform = np.array(
        [
            [c, 0, s, -0.5],
            [0, 3.0, 0, -0.25],
            [-s, 0, c, 0.5],
            [0, 0, 0, 1.0],
        ]
    )
    box = transform_triangles(make_box((-0.3, -0.3, -0.3), (0.3, 0.3, 0.3)), transform)
    b.add_triangles(box, white)
    return b.build(device=device)


def cornell_demo_options(width: int = 256, height: int = 256, **kw) -> RenderOptions:
    defaults = dict(
        image_width=width, image_height=height,
        min_sample_count=16, max_sample_count=64,
        epsilon=1e-3, allow_bias=True,
    )
    defaults.update(kw)
    return RenderOptions(**defaults)


def bench_box_scene(device="cpu") -> SceneData:
    """Closed Cornell box benchmark scene (ref: benchmark/main.cpp:34-57)."""
    b = SceneBuilder()
    white = b.add_material(diffuse=(1, 1, 1, 1))
    light = b.add_material(diffuse=(1, 1, 1, 1), emission=(1, 1, 1, 1))
    b.add_triangles(make_box((-1, -1, -1), (1, 1, 1)), white)
    b.add_triangles(make_plane((-0.25, 1.0 - 0.01, -0.25), (0.25, 1.0 - 0.01, 0.25)), light)
    return b.build(device=device)


def bench_camera(device="cpu") -> Camera:
    """Pinhole benchmark camera with aspect -1 (ref: benchmark/main.cpp:35,60)."""
    return make_camera(
        origin=(0, 0, -3), look_at=(0, 0, 0), up=(0, 1, 0),
        focal_length=1.0, height=1.0, aspect_ratio=-1.0, device=device,
    )

