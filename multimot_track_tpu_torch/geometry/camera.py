"""Pinhole camera projection / unprojection on batched torch tensors.

Port of ``multimot_track_tpu.geometry.camera`` (the functions the pair
path uses).
"""

from __future__ import annotations

from typing import Tuple

import torch


def backproject(uv: torch.Tensor, depth: torch.Tensor, fx, fy, cx, cy) -> torch.Tensor:
    """Pixels (..., 2) + depth (...,) -> camera-frame 3D (..., 3)."""
    x = (uv[..., 0] - cx) * depth / fx
    y = (uv[..., 1] - cy) * depth / fy
    return torch.stack([x, y, depth], -1)


def project(xyz: torch.Tensor, fx, fy, cx, cy, eps: float = 1e-9) -> torch.Tensor:
    """Camera-frame 3D (..., 3) -> pixels (..., 2)."""
    inv_z = 1.0 / (xyz[..., 2] + eps)
    u = fx * xyz[..., 0] * inv_z + cx
    v = fy * xyz[..., 1] * inv_z + cy
    return torch.stack([u, v], -1)


def disparity_png_to_depth(raw: torch.Tensor, bf: float) -> torch.Tensor:
    """KITTI disparity png values -> metric depth (+inf where disparity 0)."""
    disp = raw.to(torch.float32) / 256.0
    return torch.where(disp > 0, bf / torch.clamp(disp, min=1e-12),
                       torch.full_like(disp, float("inf")))


def gather_pixels(img: torch.Tensor, yi: torch.Tensor, xi: torch.Tensor) -> torch.Tensor:
    """img (B, H, W[, C]) at integer (B, ...) row/col indices -> (B, ...[, C]).

    Indices must already lie inside the image: unlike XLA's gather, torch
    indexing does not clamp."""
    B = img.shape[0]
    b = torch.arange(B, device=img.device).view((B,) + (1,) * (yi.dim() - 1))
    return img[b, yi, xi]


def nearest_sample(img: torch.Tensor, uv: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Round-to-nearest sample of img (B, H, W) at uv (B, N, 2) with the
    reference's strict in-bounds test.  ``torch.round`` rounds half to even,
    as ``jnp.round`` does.  Returns (values, in_bounds_mask)."""
    H, W = img.shape[1], img.shape[2]
    u = torch.round(uv[..., 0]).to(torch.int64)
    v = torch.round(uv[..., 1]).to(torch.int64)
    inb = (u > 0) & (u < W) & (v > 0) & (v < H)
    return gather_pixels(img, v.clamp(0, H - 1), u.clamp(0, W - 1)), inb
