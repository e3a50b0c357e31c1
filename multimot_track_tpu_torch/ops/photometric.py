"""Photometric verification of flow correspondences (patch ZNCC).

Port of ``multimot_track_tpu.ops.photometric``: ``extract_patches``,
``zncc`` and the KLT-style ``refine_position``.
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


def refine_position(gray: torch.Tensor, uv: torch.Tensor, patch_ref: torch.Tensor, radius: int,
                    search_radius: int = 2, step: float = 1.0):
    """Local re-centering on one (H, W) image: ZNCC of ``patch_ref`` (N, P)
    against the patches on a (2s+1)^2 grid of offsets around each predicted
    position uv (N, 2); the best cell (first maximum on ties) plus a
    separable parabola through its neighbours, kept integer on the grid's
    border.  Returns (refined uv (N, 2), best zncc (N,))."""
    s = search_radius
    k = 2 * s + 1
    r = torch.arange(-s, s + 1, device=uv.device)
    dy, dx = torch.meshgrid(r, r, indexing="ij")
    offs = torch.stack([dx.reshape(-1), dy.reshape(-1)], -1).to(uv.dtype) * step   # (C, 2)
    p = extract_patches(gray[None], (uv[None] + offs[:, None])[None], radius)[0]    # (C, N, P)
    scores = zncc(patch_ref[None], p)                                                 # (C, N)
    best = torch.argmax(scores, 0)
    grid = scores.reshape(k, k, -1)
    by = torch.div(best, k, rounding_mode="floor")
    bx = best % k
    n = torch.arange(uv.shape[0], device=uv.device)

    def parab(sm, s0, sp):
        den = sm - 2.0 * s0 + sp
        d = torch.where(den.abs() > 1e-9, 0.5 * (sm - sp) / den, torch.zeros_like(den))
        return torch.clamp(d, -0.5, 0.5)

    bxc = torch.clamp(bx, 1, k - 2)
    byc = torch.clamp(by, 1, k - 2)
    dxs = parab(grid[byc, bxc - 1, n], grid[byc, bxc, n], grid[byc, bxc + 1, n])
    dys = parab(grid[byc - 1, bxc, n], grid[byc, bxc, n], grid[byc + 1, bxc, n])
    dxs = torch.where((bx >= 1) & (bx <= k - 2), dxs, torch.zeros_like(dxs))
    dys = torch.where((by >= 1) & (by <= k - 2), dys, torch.zeros_like(dys))
    sub = torch.stack([dxs, dys], -1) * step
    return uv + offs[best] + sub, scores.max(0).values
