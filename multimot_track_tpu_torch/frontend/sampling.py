"""Feature sampling: dense object grids and static sparse points, batched.

Port of ``multimot_track_tpu.frontend.sampling`` on (B, ...) stacks.  Valid
entries are compacted into fixed-capacity padded tensors in row-major
order, so index i of a frame's samples names the same physical point in
the next pair.
"""

from __future__ import annotations

from typing import NamedTuple

import torch
import torch.nn.functional as Fnn

from multimot_track_tpu_torch.geometry.camera import gather_pixels
from multimot_track_tpu_torch.ops import photometric


class ObjSamples(NamedTuple):
    """Semi-dense points on instance masks, (B, N, ...)."""

    uv: torch.Tensor      # (B, N, 2) float32 pixel positions (x, y)
    depth: torch.Tensor   # (B, N) float32 metric depth at uv
    label: torch.Tensor   # (B, N) int32 semantic instance label
    flow: torch.Tensor    # (B, N, 2) float32 flow to next frame
    corres: torch.Tensor  # (B, N, 2) float32 uv + flow
    valid: torch.Tensor   # (B, N) bool
    patch: torch.Tensor   # (B, N, P) intensity patch at uv


class StaticSamples(NamedTuple):
    """Sparse background points, (B, N, ...)."""

    uv: torch.Tensor      # (B, N, 2) float32 keypoint positions
    depth: torch.Tensor   # (B, N) float32 depth at uv (-1 where none)
    flow: torch.Tensor    # (B, N, 2) float32 flow at uv
    corres: torch.Tensor  # (B, N, 2) float32 uv + flow
    valid: torch.Tensor   # (B, N) bool
    patch: torch.Tensor   # (B, N, P) intensity patch at uv


def compact(valid: torch.Tensor, n_max: int, *payloads):
    """Compact entries where ``valid`` (B, n) into the first slots of
    length-n_max tensors, in original order.  Returns
    (n_valid (B,), mask (B, n_max), *packed).  The sort keys (index, +n for
    invalid entries) are unique, so any sort gives the JAX package's order."""
    B, n = valid.shape
    idx = torch.arange(n, device=valid.device)
    order = torch.argsort(torch.where(valid, idx, idx + n), dim=1)
    if n >= n_max:
        take = order[:, :n_max]
    else:
        take = torch.cat([order, order.new_zeros((B, n_max - n))], 1)
    n_valid = valid.sum(1)
    out_mask = torch.arange(n_max, device=valid.device)[None, :] < n_valid[:, None]
    packed = []
    for p in payloads:
        flat = p.reshape(B, n, -1)
        got = torch.gather(flat, 1, take[..., None].expand(B, n_max, flat.shape[-1]))
        got = torch.where(out_mask[..., None], got, torch.zeros_like(got))
        packed.append(got.reshape((B, n_max) + p.shape[2:]))
    return (n_valid, out_mask, *packed)


def sample_dense_objects(
    depth_img: torch.Tensor,
    sem_mask: torch.Tensor,
    flow_img: torch.Tensor,
    gray: torch.Tensor = None,
    step: int = 4,
    max_depth: float = 25.0,
    n_max: int = 8192,
    patch_radius: int = 2,
) -> ObjSamples:
    """Every ``step``-th pixel where mask != 0, 0 < depth < max_depth and
    the flow-shifted position stays strictly inside the image."""
    B, H, W = depth_img.shape
    d = depth_img[:, ::step, ::step]
    lab = sem_mask[:, ::step, ::step]
    f = flow_img[:, ::step, ::step]
    Hg, Wg = d.shape[1], d.shape[2]
    ys = torch.arange(0, H, step, device=d.device, dtype=torch.float32)[:, None].expand(Hg, Wg)
    xs = torch.arange(0, W, step, device=d.device, dtype=torch.float32)[None, :].expand(Hg, Wg)
    nx = xs + f[..., 0]
    ny = ys + f[..., 1]
    valid = (
        (lab != 0) & (d < max_depth) & (d > 0)
        & (nx < W) & (nx > 0) & (ny < H) & (ny > 0)
    )
    uv = torch.stack([xs, ys], -1).reshape(1, -1, 2).expand(B, -1, 2)
    corres = torch.stack([nx, ny], -1).reshape(B, -1, 2)
    P = (2 * patch_radius + 1) ** 2
    if gray is None:
        patch_grid = torch.zeros((B, Hg * Wg, P), dtype=torch.float32, device=d.device)
    else:
        # grid points sit at integer stride-`step` positions, so every patch
        # tap is a strided slice of the edge-padded image
        r = patch_radius
        g = Fnn.pad(gray.to(torch.float32)[:, None], (r, r, r, r), mode="replicate")[:, 0]
        taps = [
            g[:, r + dy: r + dy + (Hg - 1) * step + 1: step,
              r + dx: r + dx + (Wg - 1) * step + 1: step]
            for dy in range(-r, r + 1)
            for dx in range(-r, r + 1)
        ]
        patch_grid = torch.stack(taps, -1).reshape(B, -1, P)
    _, mask, uv_p, d_p, l_p, f_p, c_p, patch = compact(
        valid.reshape(B, -1), n_max, uv, d.reshape(B, -1), lab.reshape(B, -1),
        f.reshape(B, -1, 2), corres, patch_grid,
    )
    return ObjSamples(uv=uv_p, depth=d_p, label=l_p, flow=f_p, corres=c_p,
                      valid=mask, patch=patch)


def sample_static(
    kp_uv: torch.Tensor,
    kp_valid: torch.Tensor,
    depth_img: torch.Tensor,
    sem_mask: torch.Tensor,
    flow_img: torch.Tensor,
    gray: torch.Tensor = None,
    max_depth: float = 40.0,
    n_max: int = 2048,
    patch_radius: int = 2,
) -> StaticSamples:
    """Keep keypoints that are off-mask, have 0 < depth <= max_depth, carry
    non-zero flow, and whose flow-shifted position stays inside the image;
    lookups at the truncated keypoint position."""
    B, H, W = depth_img.shape
    xi = torch.clamp(kp_uv[..., 0].to(torch.int64), 0, W - 1)
    yi = torch.clamp(kp_uv[..., 1].to(torch.int64), 0, H - 1)
    lab = gather_pixels(sem_mask, yi, xi)
    d = gather_pixels(depth_img, yi, xi)
    f = gather_pixels(flow_img, yi, xi)
    nx = kp_uv[..., 0] + f[..., 0]
    ny = kp_uv[..., 1] + f[..., 1]
    valid = (
        kp_valid & (lab == 0) & (d <= max_depth) & (d > 0)
        & (f[..., 0] != 0) & (f[..., 1] != 0)
        & (nx < W) & (ny < H) & (kp_uv[..., 0] < W) & (kp_uv[..., 1] < H)
    )
    depth_kept = torch.where(d > 0, d, torch.full_like(d, -1.0))
    corres = torch.stack([nx, ny], -1)
    _, mask, uv_p, d_p, f_p, c_p = compact(valid, n_max, kp_uv, depth_kept, f, corres)
    if gray is None:
        patch = torch.zeros((B, n_max, (2 * patch_radius + 1) ** 2),
                            dtype=torch.float32, device=kp_uv.device)
    else:
        patch = photometric.extract_patches(gray.to(torch.float32), uv_p, patch_radius)
    return StaticSamples(uv=uv_p, depth=d_p, flow=f_p, corres=c_p, valid=mask,
                         patch=patch)
