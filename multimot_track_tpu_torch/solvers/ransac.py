"""Batched fixed-iteration RANSAC pose initialisation.

Port of ``multimot_track_tpu.solvers.ransac``: 3-point Horn hypotheses
between last-frame world points and current back-projected points, scored
with the 2-D reprojection gate, the winner polished by Gauss-Newton on its
inliers.  Every problem carries a leading batch axis M.

Hypothesis indices come from a *sampler*.  ``jax.random.choice`` under a
threefry key cannot be reproduced in torch, so the draw is a parameter:
``MultinomialSampler`` draws from a ``torch.Generator``; a test can pass a
sampler that replays the JAX package's key path instead, so both packages
score the same hypotheses.
"""

from __future__ import annotations

from typing import NamedTuple, Protocol, Sequence

import torch

from multimot_track_tpu_torch.geometry import camera, se3, smallsolve
from multimot_track_tpu_torch.solvers import horn


# points x hypotheses scored per pass (bounds the scoring intermediates)
_SCORE_CHUNK_ELEMS = 1 << 25


class HypothesisSampler(Protocol):
    def __call__(self, p: torch.Tensor, iters: int, sites: Sequence[tuple]) -> torch.Tensor:
        """p (M, N) row probabilities -> (M, iters, 3) int64 point indices.

        ``sites[m]`` names the draw of row m: ``(pair, "ego")`` for a pair's
        ego RANSAC, ``(pair, "obj", slot, seed)`` for an object stream."""


class MultinomialSampler:
    """Draws hypothesis triples with replacement, proportional to p, from
    one ``torch.Generator``.  Rows with no valid point draw uniformly."""

    def __init__(self, generator: torch.Generator):
        self.generator = generator

    def __call__(self, p, iters, sites):
        M, N = p.shape
        empty = p.sum(-1, keepdim=True) <= 0
        p = torch.where(empty, torch.ones_like(p), p)
        idx = torch.multinomial(p, iters * 3, replacement=True, generator=self.generator)
        return idx.view(M, iters, 3)


class RansacResult(NamedTuple):
    T: torch.Tensor          # (M, 4, 4) pose: cur_cam <- last_world
    inliers: torch.Tensor    # (M, N) bool
    n_inliers: torch.Tensor  # (M,) int64


def _count_inliers(T, Xw, uv, valid, thresh, fx, fy, cx, cy):
    """T (..., 4, 4), points (..., N, ·) -> (inliers (..., N), count (...))."""
    y = se3.transform(T, Xw)
    d = camera.project(y, fx, fy, cx, cy) - uv
    err = torch.sqrt((d * d).sum(-1))
    inl = valid & (err < thresh) & (y[..., 2] > 0)
    return inl, inl.sum(-1)


def _proj_point_jacobian(y, fx, fy):
    """d(u, v)/d xi of camera-frame points y (..., 3) under a left se(3)
    perturbation: (..., 2, 6)."""
    inv_z = 1.0 / torch.clamp(y[..., 2], min=1e-6)
    zero = torch.zeros_like(inv_z)
    dpi = torch.stack(
        [
            torch.stack([fx * inv_z, zero, -fx * y[..., 0] * inv_z * inv_z], -1),
            torch.stack([zero, fy * inv_z, -fy * y[..., 1] * inv_z * inv_z], -1),
        ],
        -2,
    )
    eye = torch.eye(3, dtype=y.dtype, device=y.device).expand(y.shape[:-1] + (3, 3))
    dy = torch.cat([-se3.hat(y), eye], -1)
    return dpi @ dy


def _gn_refine(T, Xw, uv, w, iters, fx, fy, cx, cy):
    """Weighted Gauss-Newton on 2-D reprojection over the inlier set."""
    eye6 = 1e-6 * torch.eye(6, dtype=T.dtype, device=T.device)
    for _ in range(iters):
        y = se3.transform(T, Xw)
        r = camera.project(y, fx, fy, cx, cy) - uv
        J = _proj_point_jacobian(y, fx, fy)
        Jw = J * w[..., None, None]
        H = torch.einsum("...nia,...nib->...ab", Jw, J) + eye6
        g = torch.einsum("...nia,...ni->...a", Jw, r)
        T = se3.exp_se3(smallsolve.solve_spd6(H, -g)) @ T
    return T


def _take_rows(x: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """x (M, N, C) at idx (M, ...) -> (M, ..., C)."""
    M, C = x.shape[0], x.shape[-1]
    flat = idx.reshape(M, -1)
    out = torch.gather(x, 1, flat[..., None].expand(M, flat.shape[1], C))
    return out.reshape(idx.shape + (C,))


def ransac_rigid_pose(
    Xw_last: torch.Tensor,      # (M, N, 3) last-frame points in world
    uv_cur: torch.Tensor,       # (M, N, 2) current-frame pixel observations
    xyz_cur: torch.Tensor,      # (M, N, 3) current-frame back-projected points
    valid: torch.Tensor,        # (M, N) bool
    fx: float, fy: float, cx: float, cy: float,
    sampler: HypothesisSampler,
    sites: Sequence[tuple],
    thresh: float = 0.3,
    iters: int = 500,
    refine_iters: int = 10,
) -> RansacResult:
    M, N = valid.shape
    vf = valid.to(torch.float32)
    p = vf / torch.clamp(vf.sum(-1, keepdim=True), min=1.0)
    idx = sampler(p, iters, sites)
    T_hyp = horn.rigid_align(_take_rows(Xw_last, idx), _take_rows(xyz_cur, idx))

    # score hypotheses in chunks: the (M, chunk, N, 3) intermediates of a
    # flat scoring pass grow with the pairs x objects x seeds batch
    chunk = max(1, min(iters, _SCORE_CHUNK_ELEMS // max(M * N, 1)))
    counts = torch.cat([
        _count_inliers(T_hyp[:, c0:c0 + chunk], Xw_last[:, None], uv_cur[:, None],
                       valid[:, None], thresh, fx, fy, cx, cy)[1]
        for c0 in range(0, iters, chunk)
    ], 1)
    best = torch.argmax(counts, dim=1)              # first maximum, as jnp.argmax
    T_best = T_hyp[torch.arange(M, device=best.device), best]
    inl0, n0 = _count_inliers(T_best, Xw_last, uv_cur, valid, thresh, fx, fy, cx, cy)
    T_ref = _gn_refine(T_best, Xw_last, uv_cur, inl0.to(torch.float32),
                       refine_iters, fx, fy, cx, cy)
    inl1, n1 = _count_inliers(T_ref, Xw_last, uv_cur, valid, thresh, fx, fy, cx, cy)
    take_ref = n1 >= n0
    return RansacResult(
        T=torch.where(take_ref[:, None, None], T_ref, T_best),
        inliers=torch.where(take_ref[:, None], inl1, inl0),
        n_inliers=torch.maximum(n0, n1),
    )
