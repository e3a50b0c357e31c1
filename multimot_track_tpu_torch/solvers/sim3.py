"""Sim(3) alignment and RANSAC: the loop-closing similarity solver.

Port of ``multimot_track_tpu.solvers.sim3``: closed-form Umeyama alignment
with scale, batched over minimal samples, scored by the symmetric
reprojection error in both keyframes.  The minimal samples come from a
``ransac.HypothesisSampler`` at the site ``(frame, "sim3")``, as the PnP
and ego RANSACs draw theirs.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from multimot_track_tpu_torch.geometry import camera
from multimot_track_tpu_torch.solvers.ransac import HypothesisSampler, Sites


def umeyama(src: torch.Tensor, dst: torch.Tensor, with_scale: bool = True):
    """dst ~= s R src + t.  src / dst: (..., N, 3).  Returns (s, R, t)."""
    n = src.shape[-2]
    cs, cd = src.mean(-2), dst.mean(-2)
    s0 = src - cs[..., None, :]
    d0 = dst - cd[..., None, :]
    cov = torch.einsum("...ni,...nj->...ij", d0, s0) / n
    U, S, Vh = torch.linalg.svd(cov)
    det = torch.linalg.det(U @ Vh)
    D = torch.diag_embed(torch.stack([torch.ones_like(det), torch.ones_like(det), det], -1))
    R = U @ D @ Vh
    var_s = (s0 * s0).sum(-1).mean(-1)
    trace_DS = S[..., 0] + S[..., 1] + det * S[..., 2]
    s = trace_DS / torch.clamp(var_s, min=1e-12) if with_scale else torch.ones_like(var_s)
    t = cd - s[..., None] * (R @ cs[..., None])[..., 0]
    return s, R, t


class Sim3Result(NamedTuple):
    scale: torch.Tensor      # ()
    R: torch.Tensor          # (3, 3)
    t: torch.Tensor          # (3,)
    inliers: torch.Tensor    # (N,) bool
    n_inliers: torch.Tensor  # () int64


def ransac_sim3(
    X1: torch.Tensor,         # (N, 3) points in keyframe-1 camera coordinates
    X2: torch.Tensor,         # (N, 3) corresponding points in keyframe-2 camera
    valid: torch.Tensor,      # (N,) bool
    fx, fy, cx, cy,
    sampler: HypothesisSampler,
    site: tuple,
    th2_px: float = 9.21,     # squared-pixel gate on both reprojections
    iters: int = 300,
    fix_scale: bool = False,
) -> Sim3Result:
    """The best of ``iters`` Umeyama hypotheses on minimal triples drawn
    with replacement in proportion to ``valid``; ties go to the first."""
    vf = valid.to(torch.float32)
    p = vf / torch.clamp(vf.sum(), min=1.0)
    idx = sampler(p[None], iters, Sites([site]))[0]                  # (iters, 3)
    s, R, t = umeyama(X1[idx], X2[idx], with_scale=not fix_scale)

    uv1 = camera.project(X1, fx, fy, cx, cy)
    uv2 = camera.project(X2, fx, fy, cx, cy)
    X12 = s[:, None, None] * (X1 @ R.transpose(-1, -2)) + t[:, None]
    d2 = camera.project(X12, fx, fy, cx, cy) - uv2
    s_inv = 1.0 / torch.clamp(s, min=1e-9)
    X21 = s_inv[:, None, None] * ((X2 - t[:, None]) @ R)
    d1 = camera.project(X21, fx, fy, cx, cy) - uv1
    inl = valid & ((d1 * d1).sum(-1) < th2_px) & ((d2 * d2).sum(-1) < th2_px)
    counts = inl.sum(-1)
    best = torch.argmax(counts)                               # first maximum, as jnp.argmax
    return Sim3Result(scale=s[best], R=R[best], t=t[best], inliers=inl[best],
                      n_inliers=counts[best])
