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

from typing import Callable, List, NamedTuple, Optional, Protocol, Sequence

import torch

from multimot_track_tpu_torch.geometry import camera, se3, smallsolve
from multimot_track_tpu_torch.solvers import horn


# points x hypotheses scored per pass (bounds the scoring intermediates)
_SCORE_CHUNK_ELEMS = 1 << 25


class Sites:
    """The names of a sampler call's rows: ``(pair, "ego")`` for a pair's
    ego RANSAC, ``(pair, "obj", slot, seed)`` for an object stream,
    ``(frame, "pnp")`` for a relocalization PnP, and so on.

    ``len(sites)`` is free.  ``sites.names()`` returns the list of name
    tuples; names that depend on device data (the object slots a pair
    solves) are built by ``build`` on the first call, which reads that data
    back to the host.  So a sampler that never asks for the names never
    makes the pair step wait for the card."""

    def __init__(self, names: Sequence[tuple] = (), *, n: Optional[int] = None,
                 build: Optional[Callable[[], List[tuple]]] = None):
        self._names = None if build else list(names)
        self._build = build
        self._n = len(self._names) if build is None else n

    def __len__(self) -> int:
        return self._n

    def names(self) -> List[tuple]:
        if self._names is None:
            self._names = self._build()
            self._build = None
            if len(self._names) != self._n:
                raise ValueError(f"built {len(self._names)} site names for {self._n} rows")
        return self._names


class HypothesisSampler(Protocol):
    def __call__(self, p: torch.Tensor, iters: int, sites: Sites, k: int = 3) -> torch.Tensor:
        """p (M, N) row probabilities -> (M, iters, k) int64 point indices.
        ``sites`` names the M rows (``len(sites) == M``); a sampler that
        replays draws by name reads them with ``sites.names()``."""


class MultinomialSampler:
    """Draws hypothesis index sets with replacement, proportional to p, from
    one ``torch.Generator``.  Rows with no valid point draw uniformly.  It
    reads no site name, so on the card it never waits for the device."""

    def __init__(self, generator: torch.Generator):
        self.generator = generator

    def __call__(self, p, iters, sites, k=3):
        M, N = p.shape
        empty = p.sum(-1, keepdim=True) <= 0
        p = torch.where(empty, torch.ones_like(p), p)
        idx = torch.multinomial(p, iters * k, replacement=True, generator=self.generator)
        return idx.view(M, iters, k)


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


def _gn_refine(T, Xw, uv, w, iters, fx, fy, cx, cy, stereo=None):
    """Weighted Gauss-Newton on 2-D reprojection over the inlier set; with
    ``stereo = (disp_obs, w_disp, bf)``, on the stereo residual (u, v,
    disparity bf/z), whose disparity row carries the per-point weight
    ``w_disp``.  Steps are left se(3) perturbations."""
    eye6 = 1e-6 * torch.eye(6, dtype=T.dtype, device=T.device)
    for _ in range(iters):
        y = se3.transform(T, Xw)
        r = camera.project(y, fx, fy, cx, cy) - uv
        if stereo is None:
            J = camera.project_jacobian(y, fx, fy) @ se3.point_jacobian(y)
            Jw = J * w[..., None, None]
        else:
            disp_obs, w_disp, bf = stereo
            r_d = bf / torch.clamp(y[..., 2], min=1e-6) - disp_obs
            J = camera.project_jacobian(y, fx, fy, bf) @ se3.point_jacobian(y)
            r = torch.cat([r, r_d[..., None]], -1)
            Jw = J * torch.stack([w, w, w * w_disp], -1)[..., None]
        H = torch.einsum("...nia,...nib->...ab", Jw, J) + eye6
        g = torch.einsum("...nia,...ni->...a", Jw, r)
        T = se3.exp_se3(smallsolve.solve_spd6(H, -g)) @ T
    return T


def _gn_refine_stereo(T, Xw, uv_obs, disp_obs, w, w_disp, iters, fx, fy, cx, cy, bf):
    """``_gn_refine`` on the stereo residual."""
    return _gn_refine(T, Xw, uv_obs, w, iters, fx, fy, cx, cy, stereo=(disp_obs, w_disp, bf))


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
    sites: Sites,
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
