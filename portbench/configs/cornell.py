"""The upstream demo scene (PathTraceDemo) at the upstream dragon's
triangle count: the program's scene (through its scene cache under
`cache_dir`) and lens camera, and the reference's scene (the triangles and
the sphere), thin-lens camera and tracer over both."""
from __future__ import annotations

import math

import numpy as np
import torch

from portbench.reference.lens import ThinLens
from portbench.reference.scene import (build, flat_triangles, make_box, make_plane,
                                       mesh_triangles, standin_dragon)
from portbench.reference.sphere import SphereScene, sphere_tracer


def program_scene(cfg: dict, device, cache_dir):
    from cpupathtrace_tpu_torch.models.scenes import cornell_demo_camera, cornell_full_scene

    scene, _ = cornell_full_scene(cache_dir, dragon_tris=cfg["scene"]["dragon"]["tris"],
                                  device=device)
    return scene, cornell_demo_camera(256, 256, device=device)


def box_transform(box: dict) -> np.ndarray:
    """The demo's box matrix: a rotation of `rotate_y` about y, y
    stretched by `scale_y`, then the offset (demo/main.cpp:179-203)."""
    c, s = math.cos(box["rotate_y"]), math.sin(box["rotate_y"])
    (ox, oy, oz), k = box["offset"], box["scale_y"]
    return np.array([[c, 0, s, ox], [0, k, 0, oy], [-s, 0, c, oz], [0, 0, 0, 1.0]])


def transformed_box(box: dict):
    """make_box's triangles moved by `box_transform`, per vertex with the
    perspective divide, and their face normals carried through the
    inverse transpose and renormalised: a frozen copy of
    cpupathtrace_tpu_torch/scene/geometry.py `transform_triangles` on a
    list of triangles, each face normal taken as HostTriangle takes it."""
    mat4 = box_transform(box)
    nmat = np.linalg.inv(mat4[:3, :3]).T

    def tp(p):
        h = mat4 @ np.array([p[0], p[1], p[2], 1.0])
        return h[:3] / h[3]

    def tn(n):
        n = nmat @ np.asarray(n, np.float64)
        norm = np.linalg.norm(n)
        return n / norm if norm > 0 else n

    def face(a, b, c):
        n = np.cross(b - a, c - a)
        norm = np.linalg.norm(n)
        return n / norm if norm > 0 else n

    tris = make_box(box["lo"], box["hi"], box["cull"])
    moved = [np.array([tp(t[k]) for t in tris]) for k in range(3)]
    normals = np.array([tn(face(*t[:3])) for t in tris])
    return (*moved, normals, normals, normals, np.array([t[3] for t in tris], bool))


def reference_scene(cfg: dict, device) -> SphereScene:
    sc = cfg["scene"]
    parts = [(flat_triangles(make_plane(p["a"], p["b"], p["cull"])), p["material"])
             for p in sc["planes"]]
    dr = sc["dragon"]
    if dr["mesh"] != "standin":
        raise ValueError(f"unknown dragon mesh {dr['mesh']!r}")
    verts, faces = standin_dragon(dr["tris"], dr["seed"])
    parts.append((mesh_triangles(verts, faces, dr["transform"], dr["cull"], dr["smooth"]),
                  dr["material"]))
    parts.append((transformed_box(sc["box"]), sc["box"]["material"]))
    sp = sc["sphere"]
    return SphereScene(build(parts, cfg["materials"], device),
                       torch.tensor(sp["center"], dtype=torch.float32, device=device),
                       torch.tensor(sp["radius"], dtype=torch.float32, device=device),
                       sp["material"])


def reference_camera(cfg: dict):
    return ThinLens(cfg["camera"])


def reference_tracer(cfg: dict, scene: SphereScene, dtype):
    return sphere_tracer(scene, dtype)
