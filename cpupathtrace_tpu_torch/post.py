"""Post-processing: global tone mapping + gamma correction, in torch.

Port of `cpupathtrace_tpu/post.py` (ref: src/post_processing.cpp):
  * tone_map: brightness heuristic a*((r+g+b)/3 + max(r,g,b))/2, full sort,
    1024 gaussian-weighted segments, piecewise-linear remap (:32-162)
  * gamma_correct: RGB times brightness^(1/gamma - 1), default 1.8 (:165-177)
  * post_process = gamma_correct(tone_map(img)) (:179-182)

The segment-ceiling recurrence (a 1023-step loop with a carried missed
contribution, :105-128) depends only on the segment weights and the pixel
count, not on the image, so it runs on the host in float32 numpy scalars,
step for step as the JAX scan does, and yields the sorted-brightness index
each ceiling reads.
"""
from __future__ import annotations

import numpy as np
import torch

from .utils.math import PI

_FLT_MIN = 1.1754943508222875e-38
_SEGMENTS = 1024


def _brightness(img):
    """max(r,g,b) (ref: post_processing.cpp:22-24)."""
    return img[..., :3].amax(dim=-1)


def _brightness_heuristic(img):
    """a * ((r+g+b)/3 + max(r,g,b)) / 2 (ref: post_processing.cpp:27-30)."""
    mean = (img[..., 0] + img[..., 1] + img[..., 2]) / 3.0
    return img[..., 3] * (mean + _brightness(img)) / 2.0


def _segment_weights(n_seg: int) -> torch.Tensor:
    """0.1 + N(x; 0, 0.3) at the segment centres, x in [-1, 1] (float32)."""
    x = (torch.arange(n_seg, dtype=torch.float32) + 0.5) / n_seg
    x = 2.0 * (x - 0.5)
    fac = 1.0 / torch.sqrt(torch.tensor(2.0 * PI, dtype=torch.float32))
    e = (x - 0.0) / 0.3
    return 0.1 + fac * torch.exp(-(e * e) / 2.0) / 0.3


def _ceiling_sources(seg_w: torch.Tensor, pixel_count: int) -> np.ndarray:
    """For each of the first n_seg - 1 segments, the sorted-brightness
    index its ceiling takes (-1: the minimum brightness, before any
    segment held an item). The recurrence of post_processing.cpp:105-128."""
    total_w = seg_w.sum()
    share = (seg_w * float(pixel_count) / total_w).numpy()  # float32
    src = np.full(share.shape[0] - 1, -1, np.int64)
    prev_index = 0
    missed = np.float32(0.0)
    last = -1
    for i, q in enumerate(share[:-1]):
        items = int(np.round(q + missed))  # round half to even, as jnp.round
        if items > 0:
            last = max(min(prev_index + items - 1, pixel_count - 1), 0)
            prev_index += items
            missed = np.float32(0.0)
        else:
            missed = np.float32(missed + q)
        src[i] = last
    return src


def _as_tensor(image) -> torch.Tensor:
    if isinstance(image, np.ndarray):
        return torch.from_numpy(np.array(image, np.float32))
    return torch.as_tensor(image, dtype=torch.float32)


def tone_map(image) -> torch.Tensor:
    """image: [H, W, 4] -> tone-mapped [H, W, 4] (alpha untouched)."""
    image = _as_tensor(image)
    h, w = image.shape[0], image.shape[1]
    pixel_count = h * w
    flat = image.reshape(pixel_count, 4)

    bh = _brightness_heuristic(flat)
    min_b = torch.clamp_max(bh.min(), 0.0)
    max_b = torch.clamp_min(bh.max(), 1e-4)
    sorted_b = torch.sort(bh).values

    n_seg = min(_SEGMENTS, pixel_count)
    src = torch.from_numpy(_ceiling_sources(_segment_weights(n_seg), pixel_count))
    src = src.to(image.device)
    ceilings = torch.where(src >= 0, sorted_b[src.clamp_min(0)], min_b)
    ceilings = torch.cat([ceilings, max_b[None]])

    # Per-pixel piecewise-linear remap (ref: post_processing.cpp:130-162).
    b = _brightness(flat).clamp_min(_FLT_MIN)
    seg_idx = torch.searchsorted(ceilings, bh.contiguous(), right=False).clamp(0, n_seg - 1)
    upper = ceilings[seg_idx]
    lower = torch.where(seg_idx > 0, ceilings[(seg_idx - 1).clamp_min(0)], min_b)
    span = (upper - lower).clamp_min(_FLT_MIN)
    seg_val = (bh - lower) / span
    mapped = (seg_idx + seg_val) / n_seg
    factor = mapped / b
    out = torch.cat([flat[:, :3] * factor[:, None], flat[:, 3:4]], dim=-1)
    return out.reshape(h, w, 4)


def gamma_correct(image, gamma: float = 1.8) -> torch.Tensor:
    """RGB times brightness^(1/gamma - 1) (ref: post_processing.cpp:165-177);
    black stays black (zero brightness is clamped to FLT_MIN)."""
    image = _as_tensor(image)
    b = _brightness(image).clamp_min(_FLT_MIN)
    factor = torch.pow(b, 1.0 / gamma - 1.0)
    return torch.cat([image[..., :3] * factor[..., None], image[..., 3:]], dim=-1)


def post_process(image, gamma: float = 1.8) -> torch.Tensor:
    """tone_map then gamma_correct (ref: post_processing.cpp:179-182)."""
    return gamma_correct(tone_map(image), gamma)
