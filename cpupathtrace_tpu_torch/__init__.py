"""cpupathtrace_tpu_torch: the path tracer of `cpupathtrace_tpu`, ported to
PyTorch with hand-written CUDA kernels for an NVIDIA H100 (sm_90a).

Ported so far: the scene build (dense and binned scenes), camera, the
render path through the megakernel (K1), the sorted driver with its bounce
kernel (K2) and cluster traversal (K3, K4), the wavefront fallback with its
dense query kernel (K5), differentiable rendering (`diff`: K2's record form
and a torch replay for the backward), the adaptive film, checkpoint /
resume (`render_resumable`), the scene cache (`scene/cache.py`), tone
mapping and PNG output. Every kernel has a plain-torch version that CPU
tensors take.
Entry points that build tensors run on the CUDA card unless the caller
passes device="cpu". Names are spelled as in the JAX package's `__all__`.
The package imports torch and numpy, never jax.
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
from .integrator.checkpoint import render_resumable
from .integrator.wavefront import trace
from .diff.render import material_params_from_numpy
from .post import gamma_correct, post_process, tone_map
from .utils.image_io import read_rgb_image, write_rgb_image

__version__ = "0.1.0"

__all__ = [
    "RenderOptions", "Rays", "Camera", "make_camera", "shoot_rays",
    "APERTURE_NONE", "APERTURE_CIRCULAR", "APERTURE_HEXAGONAL",
    "Material", "SceneBuilder", "SceneData", "scene_from_numpy",
    "material_params_from_numpy",
    "BSDF_LAMBERTIAN", "BSDF_GLASS", "BSDF_MIRROR",
    "HostTriangle", "TriangleBatch", "make_plane", "make_box",
    "transform_triangles",
    "render", "render_chunk", "render_tile", "trace",
    "tone_map", "gamma_correct", "post_process",
    "read_rgb_image", "write_rgb_image",
    "render_resumable",
]
