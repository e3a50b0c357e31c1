"""Photometric verification of flow correspondences (patch ZNCC).

Port of ``multimot_track_tpu.ops.photometric`` (``extract_patches`` and
``zncc``; ``refine_position`` is not on the pair path and is not ported yet).
"""

from __future__ import annotations

import torch

from multimot_track_tpu_torch.geometry.camera import gather_pixels


def extract_patches(gray: torch.Tensor, uv: torch.Tensor, radius: int) -> torch.Tensor:
    """(B, ..., (2r+1)^2) bilinear intensity patches of gray (B, H, W)
    centred at uv (B, ..., 2).

    Each point reads its (2r+2)^2 support window, clamped as a whole inside
    the image like the JAX package's ``dynamic_slice`` form, and blends it
    bilinearly."""
    H, W = gray.shape[-2], gray.shape[-1]
    S = 2 * radius + 2
    x = torch.clamp(uv[..., 0], 0.0, W - 1.001)
    y = torch.clamp(uv[..., 1], 0.0, H - 1.001)
    xb = torch.floor(x)
    yb = torch.floor(y)
    fx = (x - xb)[..., None, None]
    fy = (y - yb)[..., None, None]
    x0 = torch.clamp(xb.to(torch.int64) - radius, 0, W - S)
    y0 = torch.clamp(yb.to(torch.int64) - radius, 0, H - S)
    off = torch.arange(S, device=gray.device)
    rows = y0[..., None, None] + off[:, None]                    # (..., S, 1)
    cols = x0[..., None, None] + off[None, :]                    # (..., 1, S)
    rows, cols = torch.broadcast_tensors(rows, cols)
    G = gather_pixels(gray, rows, cols)                          # (B, ..., S, S)
    hx = G[..., :, :-1] * (1.0 - fx) + G[..., :, 1:] * fx
    v = hx[..., :-1, :] * (1.0 - fy) + hx[..., 1:, :] * fy
    return v.reshape(uv.shape[:-1] + ((2 * radius + 1) ** 2,))


def zncc(patch_a: torch.Tensor, patch_b: torch.Tensor) -> torch.Tensor:
    """Zero-normalised cross-correlation along the last axis, in [-1, 1];
    textureless patches score ~0."""
    a = patch_a - patch_a.mean(-1, keepdim=True)
    b = patch_b - patch_b.mean(-1, keepdim=True)
    num = (a * b).sum(-1)
    den = torch.sqrt((a * a).sum(-1) * (b * b).sum(-1)) + 1e-6
    return num / den
