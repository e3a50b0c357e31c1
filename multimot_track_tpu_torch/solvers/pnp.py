"""Batched 2D-3D PnP (DLT + Gauss-Newton), depth-free.

Port of ``multimot_track_tpu.solvers.pnp``: relocalization's pose solver.
Hypotheses are 10-point DLT nullspaces (one small SVD each, batched over
the hypotheses), scored with the reprojection gate; the winner is refined
by Gauss-Newton on its inliers with re-classification.

The hypothesis index sets come from a ``ransac.HypothesisSampler`` at the
site ``(frame, "pnp")`` with k = ``min_set``; the JAX package draws them
with ``jax.random.choice`` under the frame's step key.  The DLT nullspace is
defined up to sign and the chirality normalisation removes it, so either
sign an SVD returns gives the same pose.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from multimot_track_tpu_torch.geometry import se3
from multimot_track_tpu_torch.solvers.ransac import (
    HypothesisSampler, Sites, _count_inliers, _gn_refine,
)


def dlt_pose(Xw: torch.Tensor, uv: torch.Tensor, fx, fy, cx, cy) -> torch.Tensor:
    """Direct linear transform from >= 6 2D-3D pairs: Xw (..., n, 3), uv
    (..., n, 2) pixels -> (..., 4, 4), R projected onto SO(3) and the scale
    taken from |det M|^(1/3)."""
    x = (uv[..., 0] - cx) / fx
    y = (uv[..., 1] - cy) / fy
    Xh = torch.cat([Xw, torch.ones_like(Xw[..., :1])], -1)           # (..., n, 4)
    z = torch.zeros_like(Xh)
    r1 = torch.cat([Xh, z, -x[..., None] * Xh], -1)
    r2 = torch.cat([z, Xh, -y[..., None] * Xh], -1)
    A = torch.cat([r1, r2], -2)                                        # (..., 2n, 12)
    # the nullspace in float64 (of the float32 rows): a float32 SVD of these
    # systems is an order of magnitude less accurate than the JAX package's
    Vh = torch.linalg.svd(A.double(), full_matrices=True)[2].to(A.dtype)
    P = Vh[..., -1, :].reshape(Vh.shape[:-2] + (3, 4))
    M = P[..., :3]
    scale = torch.pow(torch.abs(torch.linalg.det(M)) + 1e-20, 1.0 / 3.0)
    depth = (torch.einsum("...ij,...nj->...ni", M, Xw) + P[..., None, :, 3])[..., 2]
    P = P * (torch.sign(depth.sum(-1)) / scale)[..., None, None]
    U, _, Vt = torch.linalg.svd(P[..., :3])
    det = torch.linalg.det(U @ Vt)
    D = torch.diag_embed(torch.stack([torch.ones_like(det), torch.ones_like(det), det], -1))
    return se3.make_T(U @ D @ Vt, P[..., :, 3])


class PnPResult(NamedTuple):
    T: torch.Tensor
    inliers: torch.Tensor
    n_inliers: torch.Tensor


def ransac_pnp(
    Xw: torch.Tensor,       # (N, 3)
    uv: torch.Tensor,       # (N, 2)
    valid: torch.Tensor,    # (N,)
    fx, fy, cx, cy,
    sampler: HypothesisSampler,
    site: tuple,
    thresh: float = 5.99,
    iters: int = 300,
    refine_iters: int = 8,
    min_set: int = 10,
) -> PnPResult:
    """Depth-free RANSAC PnP with ``min_set`` points per hypothesis (above
    the 6-point minimum: the DLT is ill-conditioned on the near-planar
    slabs forward motion triangulates)."""
    vf = valid.to(torch.float32)
    p = vf / torch.clamp(vf.sum(), min=1.0)
    idx = sampler(p[None], iters, Sites([site]), k=min_set)[0]               # (iters, min_set)
    T_hyp = dlt_pose(Xw[idx], uv[idx], fx, fy, cx, cy)
    _, counts = _count_inliers(T_hyp, Xw[None], uv[None], valid[None], thresh,
                               fx, fy, cx, cy)
    T_cur = T_hyp[torch.argmax(counts)]                                # first maximum
    inl_cur, n_cur = _count_inliers(T_cur, Xw, uv, valid, thresh, fx, fy, cx, cy)
    for _ in range(2):
        T_ref = _gn_refine(T_cur, Xw, uv, inl_cur.to(torch.float32), refine_iters,
                           fx, fy, cx, cy)
        inl1, n1 = _count_inliers(T_ref, Xw, uv, valid, thresh, fx, fy, cx, cy)
        take = n1 >= n_cur
        T_cur = torch.where(take, T_ref, T_cur)
        inl_cur = torch.where(take, inl1, inl_cur)
        n_cur = torch.maximum(n_cur, n1)
    return PnPResult(T=T_cur, inliers=inl_cur, n_inliers=n_cur)
