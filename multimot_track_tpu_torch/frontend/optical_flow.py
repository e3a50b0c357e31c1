"""Dense optical flow: coarse-to-fine pyramidal Lucas-Kanade.

Port of ``multimot_track_tpu.frontend.optical_flow``.  The reference
consumes precomputed .flo files (Examples/RGB-D/rgbd_tum.cc:129) and cannot
run without them; this estimates a dense flow field on the device with the
classic iterative LK scheme:

  per level (coarse to fine): warp I1 by the upsampled flow, compute
  spatio-temporal gradients, solve the 2x2 LK system per pixel from
  box-filtered gradient products (separable running sums), iterate.

Gradients wrap at the image edge (``roll``), as in the JAX package; the
pyramid is ``_box_filter(., 1)[::2, ::2] / 9`` and the upsampling
``2 * resize(linear)``.  Float32 work in another summation order than XLA's,
so the flow agrees with the JAX package's to float32 rounding carried
through the iterations, not bit for bit.
"""

from __future__ import annotations

import torch

from multimot_track_tpu_torch.frontend.stereo import _box_filter
from multimot_track_tpu_torch.geometry.camera import bilinear_sample
from multimot_track_tpu_torch.ops.resize import resize_linear


def _warp(img: torch.Tensor, flow: torch.Tensor) -> torch.Tensor:
    H, W = img.shape
    ys = torch.arange(H, dtype=torch.float32, device=img.device)[:, None].expand(H, W)
    xs = torch.arange(W, dtype=torch.float32, device=img.device)[None, :].expand(H, W)
    uv = torch.stack([xs + flow[..., 0], ys + flow[..., 1]], -1)
    return bilinear_sample(img, uv)


def _lk_level(I0, I1, flow, radius: int, iters: int, eps: float = 1e-3):
    """Iterative LK refinement of ``flow`` at one pyramid level."""
    gx = 0.5 * (torch.roll(I0, -1, 1) - torch.roll(I0, 1, 1))
    gy = 0.5 * (torch.roll(I0, -1, 0) - torch.roll(I0, 1, 0))
    Ixx, Ixy, Iyy = _box_filter(torch.stack([gx * gx, gx * gy, gy * gy]), radius)
    det = Ixx * Iyy - Ixy * Ixy
    zero = torch.zeros((), device=I0.device)
    inv_det = torch.where(det > eps, 1.0 / torch.clamp(det, min=eps), zero)
    g = torch.stack([gx, gy])
    flow0 = flow
    for _ in range(iters):
        It = _warp(I1, flow) - I0
        bx, by = _box_filter(g * It, radius)
        du = -(Iyy * bx - Ixy * by) * inv_det
        dv = -(Ixx * by - Ixy * bx) * inv_det
        # damped, clamped update; total per-level correction trust region
        # keeps weakly-textured regions from drifting off the pyramid init
        upd = 0.5 * torch.stack([torch.clamp(du, -1.0, 1.0), torch.clamp(dv, -1.0, 1.0)], -1)
        flow = flow0 + torch.clamp(flow + upd - flow0, -3.0, 3.0)
    return flow


def dense_flow(img0: torch.Tensor, img1: torch.Tensor, n_levels: int = 5, radius: int = 5,
               iters: int = 8) -> torch.Tensor:
    """(H, W) x2 -> (H, W, 2) forward flow img0 -> img1, on the images'
    device."""
    pyr = [torch.stack([img0, img1]).to(torch.float32)]
    for _ in range(n_levels - 1):
        pyr.append(_box_filter(pyr[-1], 1)[:, ::2, ::2] / 9.0)
    flow = torch.zeros(pyr[-1].shape[1:] + (2,), dtype=torch.float32, device=img0.device)
    for lvl in range(n_levels - 1, -1, -1):
        if lvl < n_levels - 1:
            Hn, Wn = pyr[lvl].shape[1:]
            flow = 2.0 * resize_linear(flow, (Hn, Wn, 2))
        flow = _lk_level(pyr[lvl][0], pyr[lvl][1], flow, radius, iters)
    return flow
