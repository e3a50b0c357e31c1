"""Pinhole camera projection / unprojection on batched torch tensors.

Port of ``multimot_track_tpu.geometry.camera``, with the Brown-Conrady
lens model the monocular frontend undistorts its keypoints with.
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


def project_jacobian(y: torch.Tensor, fx, fy, bf=None) -> torch.Tensor:
    """d pi / d y at camera-frame points y (..., 3): (..., 2, 3), with 1/z
    taken at z clamped to 1e-6; with ``bf``, (..., 3, 3), the stereo
    disparity bf/z's row below."""
    inv_z = 1.0 / torch.clamp(y[..., 2], min=1e-6)
    zero = torch.zeros_like(inv_z)
    rows = [
        torch.stack([fx * inv_z, zero, -fx * y[..., 0] * inv_z * inv_z], -1),
        torch.stack([zero, fy * inv_z, -fy * y[..., 1] * inv_z * inv_z], -1),
    ]
    if bf is not None:
        rows.append(torch.stack([zero, zero, -bf * inv_z * inv_z], -1))
    return torch.stack(rows, -2)


def disparity_png_to_depth(raw: torch.Tensor, bf: float) -> torch.Tensor:
    """KITTI disparity png values -> metric depth (+inf where disparity 0)."""
    disp = raw.to(torch.float32) / 256.0
    return torch.where(disp > 0, bf / torch.clamp(disp, min=1e-12),
                       torch.full_like(disp, float("inf")))


def bilinear_sample(img: torch.Tensor, uv: torch.Tensor) -> torch.Tensor:
    """Bilinear sample of one (H, W) or (H, W, C) image at float pixel
    positions (..., 2).  Positions clip to [0, W - 1.001] x [0, H - 1.001];
    integer images blend in float32."""
    H, W = img.shape[0], img.shape[1]
    u = torch.clamp(uv[..., 0], 0.0, W - 1.001)
    v = torch.clamp(uv[..., 1], 0.0, H - 1.001)
    u0 = torch.floor(u).to(torch.int32)
    v0 = torch.floor(v).to(torch.int32)
    du, dv = u - u0, v - v0
    if img.is_floating_point():
        du, dv = du.to(img.dtype), dv.to(img.dtype)
    u0, v0 = u0.long(), v0.long()
    i00, i01 = img[v0, u0], img[v0, u0 + 1]
    i10, i11 = img[v0 + 1, u0], img[v0 + 1, u0 + 1]
    if img.dim() == 3:
        du, dv = du[..., None], dv[..., None]
    return (i00 * (1 - du) * (1 - dv) + i01 * du * (1 - dv)
            + i10 * (1 - du) * dv + i11 * du * dv)


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


def distort_normalized(xy: torch.Tensor, k1, k2, p1, p2, k3=0.0) -> torch.Tensor:
    """Apply Brown-Conrady distortion to normalized coords (..., 2)."""
    x, y = xy[..., 0], xy[..., 1]
    r2 = x * x + y * y
    radial = 1.0 + r2 * (k1 + r2 * (k2 + r2 * k3))
    xd = x * radial + 2.0 * p1 * x * y + p2 * (r2 + 2.0 * x * x)
    yd = y * radial + p1 * (r2 + 2.0 * y * y) + 2.0 * p2 * x * y
    return torch.stack([xd, yd], -1)


def undistort_points(uv: torch.Tensor, fx, fy, cx, cy, k1, k2, p1, p2, k3=0.0,
                     iters: int = 8) -> torch.Tensor:
    """Invert Brown-Conrady distortion on pixel keypoints (..., 2): normalize,
    iterate x <- (xd - dt(x)) / radial(x) a fixed ``iters`` times (OpenCV's
    compensation loop, as the reference's Frame::UndistortKeyPoints runs it
    through cv::undistortPoints), re-project with K."""
    xd = torch.stack([(uv[..., 0] - cx) / fx, (uv[..., 1] - cy) / fy], -1)
    x = xd
    for _ in range(iters):
        xx, yy = x[..., 0], x[..., 1]
        r2 = xx * xx + yy * yy
        radial = 1.0 + r2 * (k1 + r2 * (k2 + r2 * k3))
        dtx = 2.0 * p1 * xx * yy + p2 * (r2 + 2.0 * xx * xx)
        dty = p1 * (r2 + 2.0 * yy * yy) + 2.0 * p2 * xx * yy
        x = torch.stack([(xd[..., 0] - dtx) / radial, (xd[..., 1] - dty) / radial], -1)
    return torch.stack([x[..., 0] * fx + cx, x[..., 1] * fy + cy], -1)
