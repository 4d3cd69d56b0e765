"""The sharded differentiable-rendering training step.

Port of `cpupathtrace_tpu/parallel/train.py`: a forward render sharded over
the (dp, sp) mesh, the image loss against a target, the gradient with
respect to the replicated material table, then an SGD step kept >= 0.

Each rank keeps the graph of its own samples only (parallel/render.py):
the chunk's value is the all-reduced total, so every rank computes the
same loss of the whole image, and its backward gives that rank's share of
the gradient. The shares are summed by one all_reduce over the mesh's dp
group and one over its sp group; each sample's contribution is counted
once. (A differentiable all_reduce of the sums, whose backward is an
all_reduce of the gradients, followed by a sum of the parameter gradients
over the mesh, would count the sp axis sp times.) The gradient is that of
the loss on the full image, JAX's (train.py:23-40).
"""
from __future__ import annotations

import torch

from ..camera.camera import Camera
from ..core.config import RenderOptions, resolve_device
from ..diff.render import apply_material_params
from ..scene.scene import SceneData
from .distributed import all_reduce
from .render import pixel_coords, render_chunk_serial, render_chunk_sharded


def sharded_image_loss(params: dict, scene: SceneData, camera: Camera,
                       options: RenderOptions, mesh, target: torch.Tensor,
                       x_cam: torch.Tensor, y_cam: torch.Tensor, key: int,
                       spp: int) -> torch.Tensor:
    """Mean squared RGB error of the sharded render with material `params`
    against `target` [P, 4] (P padded to dp); the same value on every rank,
    the graph of this rank's samples."""
    s = apply_material_params(scene, params)
    sums, counts = render_chunk_sharded(s, camera, options, mesh, x_cam, y_cam, key, spp,
                                        differentiable=True)
    img = sums / counts.clamp_min(1)[:, None]
    diff = img[:, :3] - target[:, :3]
    return (diff * diff).mean()


def sharded_loss_and_grad(params: dict, scene: SceneData, camera: Camera,
                          options: RenderOptions, mesh, target: torch.Tensor,
                          x_cam: torch.Tensor, y_cam: torch.Tensor, key: int, spp: int):
    """(loss, grads) of `sharded_image_loss`: every rank's share of the
    gradient summed over the mesh (dp, then sp), the same on every rank."""
    leaves = {k: v.detach().requires_grad_(True) for k, v in params.items()}
    loss = sharded_image_loss(leaves, scene, camera, options, mesh, target, x_cam, y_cam,
                              key, spp)
    grads = torch.autograd.grad(loss, list(leaves.values()), allow_unused=True)
    flat = torch.cat([(torch.zeros_like(v) if g is None else g).reshape(-1)
                      for v, g in zip(leaves.values(), grads)])
    for name in mesh.mesh_dim_names:
        all_reduce(flat, "sum", mesh.get_group(name))
    out, at = {}, 0
    for k, v in leaves.items():
        out[k] = flat[at:at + v.numel()].reshape(v.shape)
        at += v.numel()
    return loss.detach(), out


def train_step_sharded(params: dict, scene: SceneData, camera: Camera,
                       options: RenderOptions, mesh, target: torch.Tensor,
                       x_cam: torch.Tensor, y_cam: torch.Tensor, key: int, spp: int,
                       lr: float = 0.05):
    """One SGD step of sharded inverse rendering; returns (params, loss):
    the new params as leaf tensors, clamped >= 0, and the loss before the
    step, the same on every rank."""
    loss, grads = sharded_loss_and_grad(params, scene, camera, options, mesh, target, x_cam,
                                        y_cam, key, spp)
    return ({k: (v.detach() - lr * grads[k]).clamp_min(0.0).requires_grad_(True)
             for k, v in params.items()}, loss)


def pixel_grid(options: RenderOptions, dp: int, device=None):
    """(x_cam, y_cam) [P] float32 of every pixel, sample-major, padded
    with zeros to a multiple of dp, on `device` (default: the CUDA card)."""
    x, y, _ = pixel_coords(options, dp, resolve_device(device))
    return x, y


def serial_image_loss(params: dict, scene: SceneData, camera: Camera,
                      options: RenderOptions, shape, target: torch.Tensor,
                      x_cam: torch.Tensor, y_cam: torch.Tensor, key: int,
                      spp: int) -> torch.Tensor:
    """The serial oracle of `sharded_image_loss` for a (dp, sp) = `shape`
    mesh: the same shards in one process, the graph of all of them."""
    s = apply_material_params(scene, params)
    sums, counts = render_chunk_serial(s, camera, options, shape, x_cam, y_cam, key, spp,
                                       differentiable=True)
    img = sums / counts.clamp_min(1)[:, None]
    diff = img[:, :3] - target[:, :3]
    return (diff * diff).mean()

