"""Differentiable rendering (port of `cpupathtrace_tpu/diff/render.py`).

Every sampling decision of the estimator (ray directions, reflect or
refract, roulette, light selection) is detached, while the radiance side
(the material table's diffuse / specular albedo and emission) keeps its
graph. For parameters that move no discrete decision boundary this gives
unbiased pixel gradients that match finite differences under common random
numbers. Past depth 4 the roulette probability depends on the path
throughput and so on the albedo (ref: worker.cpp:67-70); it is detached, so
finite differences see O(eps) threshold crossings there and agree with the
analytic gradient in expectation; at max_depth <= 4 they agree exactly.

A `key` is what a JAX key is to the JAX package: an int seed (every use
starts the same stream), a torch.Generator (used as it stands), or a
RecordedDraws of the JAX package's draws (integrator/rng.py). Parameters
are a dict of tensors; `loss_and_grad` and `inverse_render` make their
own leaves.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from ..camera.camera import Camera
from ..core.config import RenderOptions, resolve_device
from ..integrator.film import pixel_camera_coords, render_chunk
from ..integrator.rng import draw_source
from ..scene.scene import SceneData
from ..utils.profiling import trace_annotation

#: The differentiable fields of a scene (ref Material fields:
#: include/PathTrace/scene/material.h:12-77).
DIFFERENTIABLE_FIELDS = ("mat_diffuse", "mat_specular", "mat_emission")


def get_material_params(scene: SceneData, fields=DIFFERENTIABLE_FIELDS) -> dict:
    """The differentiable material table columns as a params dict."""
    return {f: getattr(scene, f) for f in fields}


def material_params_from_numpy(params: dict, device=None) -> dict:
    """The JAX package's get_material_params output, as numpy arrays, as
    the port's params: float32 leaf tensors with requires_grad, on
    `device` (default: the CUDA card)."""
    dev = resolve_device(device)
    return {f: torch.tensor(np.asarray(v), dtype=torch.float32, device=dev).requires_grad_(True)
            for f, v in params.items()}


def apply_material_params(scene: SceneData, params: dict) -> SceneData:
    """The scene with its material fields replaced by `params`. The
    emissive CDF stays: it is a sampling distribution, so the estimator
    stays unbiased for any emission; only its variance changes."""
    return dataclasses.replace(scene, **params)


def _render(scene, camera, options, source, spp):
    w, h = options.image_width, options.image_height
    dev = scene.device
    xg, yg = np.meshgrid(np.arange(w, dtype=np.float32), np.arange(h, dtype=np.float32))
    x_cam, y_cam = pixel_camera_coords(options, xg.ravel(), yg.ravel())
    s, c = render_chunk(
        scene, camera.to(dev), options,
        torch.from_numpy(np.ascontiguousarray(x_cam, np.float32)).to(dev),
        torch.from_numpy(np.ascontiguousarray(y_cam, np.float32)).to(dev),
        source, spp, differentiable=True,
    )
    return s / c.clamp_min(1)[:, None]


def render_image_diff(scene: SceneData, camera: Camera, options: RenderOptions, key,
                      spp: int) -> torch.Tensor:
    """Differentiable fixed-spp mean image [H*W, 4] on the scene's device."""
    return _render(scene, camera, options, draw_source(key, scene.device), spp)


def image_loss(params: dict, scene: SceneData, camera: Camera, options: RenderOptions,
               target: torch.Tensor, key, spp: int) -> torch.Tensor:
    """Mean squared error of the rendered RGB against `target` [H*W, 4].
    With a Monte Carlo render X, E[(X-t)^2] = (E[X]-t)^2 + Var[X]: the
    variance biases plain L2 toward dark parameters, so optimise
    `image_loss_unbiased`; this one is the object of FD checks."""
    img = render_image_diff(apply_material_params(scene, params), camera, options, key, spp)
    diff = img[:, :3] - target[:, :3]
    return (diff * diff).mean()


def image_loss_unbiased(params: dict, scene: SceneData, camera: Camera,
                        options: RenderOptions, target: torch.Tensor, key,
                        spp: int) -> torch.Tensor:
    """Unbiased squared error from two independent renders A, B of one
    stream: E[(A-t)(B-t)] = (E[X]-t)^2, with no Var[X] term."""
    s = apply_material_params(scene, params)
    source = draw_source(key, s.device)
    a = _render(s, camera, options, source, spp)
    b = _render(s, camera, options, source, spp)
    return ((a[:, :3] - target[:, :3]) * (b[:, :3] - target[:, :3])).mean()


def loss_and_grad(params: dict, scene: SceneData, camera: Camera, options: RenderOptions,
                  target: torch.Tensor, key, spp: int):
    """(image_loss, {field: d loss / d params[field]}), as the JAX
    package's jax.value_and_grad(image_loss)."""
    with trace_annotation("diff.loss_and_grad"):
        leaves = {f: v.detach().requires_grad_(True) for f, v in params.items()}
        loss = image_loss(leaves, scene, camera, options, target, key, spp)
        with trace_annotation("diff.grad"):
            grads = torch.autograd.grad(loss, list(leaves.values()), allow_unused=True)
        return loss.detach(), {
            f: torch.zeros_like(v) if g is None else g
            for (f, v), g in zip(leaves.items(), grads)
        }


def finite_difference_grad(params: dict, scene: SceneData, camera: Camera,
                           options: RenderOptions, target, key, spp: int, field: str,
                           index: tuple, eps: float = 1e-3) -> float:
    """Central finite difference of `image_loss` in one parameter entry,
    with common random numbers (the same key on both sides)."""
    def at(delta):
        p = {f: v.detach() for f, v in params.items()}
        p[field] = p[field].clone()
        p[field][index] += delta
        with torch.no_grad():
            return float(image_loss(p, scene, camera, options, target, key, spp))

    return (at(eps) - at(-eps)) / (2.0 * eps)


def inverse_render(scene: SceneData, camera: Camera, options: RenderOptions,
                   target: torch.Tensor, init_params: dict, steps: int = 100,
                   learning_rate: float = 0.05, spp: int = 16, seed: int = 0,
                   callback=None):
    """Recover material parameters by Adam on `image_loss_unbiased` (the
    inverse-rendering demo, BASELINE.json config[3]). Each step clips the
    gradient to global norm 1 (NEE's 1/r^2 singularity gives heavy-tailed
    spikes that would steer Adam's moments for many steps), then projects
    onto non-negative values. torch's clip divides by (norm + 1e-6) where
    optax divides by norm; Adam's defaults are optax's. Returns (params,
    losses [steps])."""
    params = {f: v.detach().clone().requires_grad_(True) for f, v in init_params.items()}
    opt = torch.optim.Adam(list(params.values()), lr=learning_rate)
    gen = torch.Generator(device=scene.device)
    gen.manual_seed(int(seed))
    losses = []
    for i in range(steps):
        loss = image_loss_unbiased(params, scene, camera, options, target, gen, spp)
        opt.zero_grad()
        loss.backward()
        torch.nn.utils.clip_grad_norm_(list(params.values()), 1.0)
        opt.step()
        with torch.no_grad():
            for v in params.values():
                v.clamp_(min=0.0)
        losses.append(float(loss.detach()))
        if callback is not None:
            callback(i, losses[-1], params)
    return {f: v.detach() for f, v in params.items()}, np.asarray(losses)
