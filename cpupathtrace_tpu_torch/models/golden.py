"""The golden-image scenes of tests/golden/ (rendered by the compiled C++
reference, 32x32, raw float32 RGBA before post-processing), built with the
port's builder, with the distribution checks tests/test_parity.py applies.

  * golden_box_32.raw: inward-wound Cornell box, camera (0,0,0)->(0,0,0.9)
  * golden_specular_32.raw: the same box with a tinted mirror sphere and a
    glass sphere
  * golden_sphere_32.raw: one sphere under one point light

The reference does not match itself pointwise at these sample counts, so
parity is on pixel quantiles and the alpha coverage mask.
"""
from __future__ import annotations

import os
import struct

import numpy as np

from ..camera.camera import make_camera
from ..scene.geometry import make_plane
from ..scene.scene import BSDF_GLASS, BSDF_MIRROR, SceneBuilder

GOLDEN_DIR = os.path.join(
    os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__)))),
    "tests", "golden",
)


def read_golden(name: str) -> np.ndarray:
    """A golden image as [h, w, 4] float32."""
    with open(os.path.join(GOLDEN_DIR, name), "rb") as f:
        w, h = struct.unpack("ii", f.read(8))
        return np.frombuffer(f.read(), np.float32).reshape(h, w, 4)


def _inward_box(b: SceneBuilder):
    """Closed 2x2x2 box, walls wound inward, emissive ceiling panel
    (tests/scenes_util.py; ref: demo/main.cpp:66-135)."""
    white = b.add_material(diffuse=(1, 1, 1, 1))
    light = b.add_material(diffuse=(1, 1, 1, 1), emission=(1.0, 1.0, 1.0, 1.0))
    b.add_triangles(make_plane((1, -1, -1), (-1, -1, 1), True), white)
    b.add_triangles(make_plane((-1, 1, -1), (1, 1, 1), True), white)
    b.add_triangles(make_plane((-0.25, 0.99, -0.25), (0.25, 0.99, 0.25), True), light)
    b.add_triangles(make_plane((-1, -1, -1), (1, 1, -1), True), white)
    b.add_triangles(make_plane((-1, -1, -1), (-1, 1, 1), True), white)
    b.add_triangles(make_plane((1, -1, 1), (-1, 1, 1), True), white)
    b.add_triangles(make_plane((1, -1, 1), (1, 1, -1), True), white)
    return b


def inward_box_scene(device=None):
    return _inward_box(SceneBuilder()).build(device=device)


def specular_box_scene(point_light: bool = False, device=None):
    """inward_box_scene plus a tinted mirror sphere and a glass sphere
    (tests/scenes_util.py:specular_box_scene); `point_light` adds one point
    light inside the box."""
    b = _inward_box(SceneBuilder())
    mirror = b.add_material(
        diffuse=(0, 0, 1, 1), specular=(0.2, 0.4, 0.9, 1.0), bsdf=BSDF_MIRROR
    )
    glass = b.add_material(
        diffuse=(1, 1, 1, 1), specular=(0.9, 0.6, 0.3, 1.0), ior=1.5, bsdf=BSDF_GLASS
    )
    b.add_sphere((-0.4, -0.3, 0.5), 0.4, mirror)
    b.add_sphere((0.45, -0.35, 0.45), 0.35, glass)
    if point_light:
        b.add_point_light((0.0, 0.5, 0.2), (0.6, 0.6, 0.6, 1.0))
    return b.build(device=device)


def sphere_point_light_scene(device=None):
    """One sphere lit by one point light, no triangles (the table form)."""
    b = SceneBuilder()
    b.add_point_light((0.0, 1.0, 0.0), (1.0, 1.0, 1.0, 1.0))
    b.add_sphere((0.0, 0.0, 0.6), 0.5)
    return b.build(device=device)


def box_camera(device=None):
    return make_camera((0, 0, 0), (0, 0, 0.9), (0, 1, 0), 1.0, 1.0, 1.0, device=device)


def sphere_camera(device=None):
    return make_camera((0, 0, 0), (0, 0, 1), (0, 1, 0), 0.1, 1.0, 1.0, device=device)


# name -> (golden file, scene, camera, spp, seed) as in tests/test_parity.py.
GOLDEN_CASES = {
    "box": ("golden_box_32.raw", inward_box_scene, box_camera, 512, 3),
    "specular": ("golden_specular_32.raw", specular_box_scene, box_camera, 512, 7),
    "sphere": ("golden_sphere_32.raw", sphere_point_light_scene, sphere_camera, 256, 0),
}


def quantile_gaps(ours, golden, qs):
    """Relative gap |a - b| / max(|b|, 1e-3) of each RGB quantile."""
    gaps = []
    for q in qs:
        a = float(np.quantile(ours[..., :3], q))
        b = float(np.quantile(golden[..., :3], q))
        gaps.append(abs(a - b) / max(abs(b), 1e-3))
    return gaps


def check_golden(name: str, ours: np.ndarray, golden: np.ndarray) -> dict:
    """The checks of tests/test_parity.py for golden `name`; returns the
    measured figures with "ok" (bool)."""
    if name == "sphere":
        cover = float((ours[..., 3] != golden[..., 3]).mean())
        mask = (ours[..., 3] > 0) & (golden[..., 3] > 0)
        a = float(ours[..., :3][mask].mean())
        g = float(golden[..., :3][mask].mean())
        rel = abs(a - g) / g
        return {"alpha_mismatch": cover, "lit_mean_rel": rel,
                "ok": cover < 0.02 and rel <= 0.1}
    central_tol, tail_tol = (0.08, 0.12) if name == "box" else (0.10, 0.25)
    central = quantile_gaps(ours, golden, (0.25, 0.5, 0.75))
    tail = quantile_gaps(ours, golden, (0.95,))
    alpha_equal = bool(np.array_equal(ours[..., 3], golden[..., 3]))
    return {"alpha_equal": alpha_equal, "central_rel": central, "q95_rel": tail,
            "ok": alpha_equal and max(central) <= central_tol and max(tail) <= tail_tol}
