"""cpupathtrace_tpu_torch: the path tracer of `cpupathtrace_tpu`, ported to
PyTorch with hand-written CUDA kernels for an NVIDIA H100 (sm_90a).

This slice covers the dense-scene render path: scene build, camera, the
path-trace megakernel (csrc/megakernel.cu, with a plain-torch twin for the
CPU), the adaptive film, tone mapping and PNG output. Names are spelled as in
the JAX package's `__all__`. The package imports torch and numpy, never jax.
"""
from .core.config import RenderOptions
from .core.rays import Rays
from .camera.camera import (
    APERTURE_CIRCULAR,
    APERTURE_HEXAGONAL,
    APERTURE_NONE,
    Camera,
    make_camera,
    shoot_rays,
)
from .scene.scene import (
    BSDF_GLASS,
    BSDF_LAMBERTIAN,
    BSDF_MIRROR,
    Material,
    SceneBuilder,
    SceneData,
    scene_from_numpy,
)
from .scene.geometry import (
    HostTriangle,
    TriangleBatch,
    make_box,
    make_plane,
    transform_triangles,
)
from .integrator.film import render, render_chunk, render_tile
from .post import gamma_correct, post_process, tone_map
from .utils.image_io import read_rgb_image, write_rgb_image

__version__ = "0.1.0"

__all__ = [
    "RenderOptions", "Rays", "Camera", "make_camera", "shoot_rays",
    "APERTURE_NONE", "APERTURE_CIRCULAR", "APERTURE_HEXAGONAL",
    "Material", "SceneBuilder", "SceneData", "scene_from_numpy",
    "BSDF_LAMBERTIAN", "BSDF_GLASS", "BSDF_MIRROR",
    "HostTriangle", "TriangleBatch", "make_plane", "make_box",
    "transform_triangles",
    "render", "render_chunk", "render_tile",
    "tone_map", "gamma_correct", "post_process",
    "read_rgb_image", "write_rgb_image",
]
