"""Monocular two-view initialization (H/F model selection + pose recovery).

Port of ``multimot_track_tpu.solvers.initializer`` (the reference's
Initializer, src/Initializer.cc): RANSAC over a fundamental-matrix model
and a homography model solved and scored as one batch each, the
reference's SH / (SH + SF) > 0.40 selection rule, then pose recovery
(essential-matrix decomposition, or the Faugeras H-decomposition) and
triangulation of every point under every candidate motion with
cheirality, reprojection and parallax-dominance checks.

The hypothesis index sets come from a ``ransac.HypothesisSampler``: the
F model's 8-point sets at ``(frame, "mono_F")`` and the H model's 4-point
sets at ``(frame, "mono_H")``, drawn with replacement proportional to the
match mask (the JAX package draws both with ``jax.random.choice`` from
the two halves of the frame's key).  SVD nullspaces and singular vectors
are defined up to sign; every result here is invariant to the sign an SVD
returns (the candidate motions form the same set in another order).
``triangulate`` keeps a float32 SVD, the rounding loop closing's
two-view point creation is held to.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from multimot_track_tpu_torch.geometry import se3
from multimot_track_tpu_torch.solvers.ransac import HypothesisSampler, Sites


def _normalize(pts: torch.Tensor):
    """Hartley normalisation of (..., n, 2): points with zero mean and mean
    distance sqrt(2), and the (..., 3, 3) transform that maps them."""
    mean = pts.mean(-2, keepdim=True)
    d = torch.linalg.norm(pts - mean, dim=-1).mean(-1)
    s = 2.0 ** 0.5 / torch.clamp(d, min=1e-9)
    T = torch.zeros(pts.shape[:-2] + (3, 3), dtype=pts.dtype, device=pts.device)
    T[..., 0, 0] = s
    T[..., 1, 1] = s
    T[..., 0, 2] = -s * mean[..., 0, 0]
    T[..., 1, 2] = -s * mean[..., 0, 1]
    T[..., 2, 2] = 1.0
    return (pts - mean) * s[..., None, None], T


def _nullvec(A: torch.Tensor) -> torch.Tensor:
    """The right singular vector of A's smallest singular value, (..., n).
    The model fits and decompositions take their SVDs in float64 of the
    float32 inputs: a float32 SVD of these small, ill-conditioned systems
    is an order of magnitude less accurate than the JAX package's float32
    SVD, and the inlier gates downstream see the difference."""
    return torch.linalg.svd(A.double())[2][..., -1, :].to(A.dtype)


def eight_point_F(p1: torch.Tensor, p2: torch.Tensor) -> torch.Tensor:
    """(..., 8+, 2) x2 -> (..., 3, 3) fundamental matrices (normalized 8-pt)."""
    p1n, T1 = _normalize(p1)
    p2n, T2 = _normalize(p2)
    x1, y1 = p1n[..., 0], p1n[..., 1]
    x2, y2 = p2n[..., 0], p2n[..., 1]
    A = torch.stack([x2 * x1, x2 * y1, x2, y2 * x1, y2 * y1, y2, x1, y1,
                     torch.ones_like(x1)], -1)
    F = _nullvec(A).reshape(A.shape[:-2] + (3, 3))
    U, S, Vt = torch.linalg.svd(F.double())
    S = torch.cat([S[..., :2], torch.zeros_like(S[..., 2:])], -1)   # rank 2
    F = (U @ (S[..., :, None] * Vt)).to(A.dtype)
    return T2.transpose(-1, -2) @ F @ T1


def four_point_H(p1: torch.Tensor, p2: torch.Tensor) -> torch.Tensor:
    """(..., 4+, 2) x2 -> (..., 3, 3) homographies (normalized DLT)."""
    p1n, T1 = _normalize(p1)
    p2n, T2 = _normalize(p2)
    x1, y1 = p1n[..., 0], p1n[..., 1]
    x2, y2 = p2n[..., 0], p2n[..., 1]
    z, o = torch.zeros_like(x1), torch.ones_like(x1)
    r1 = torch.stack([-x1, -y1, -o, z, z, z, x2 * x1, x2 * y1, x2], -1)
    r2 = torch.stack([z, z, z, -x1, -y1, -o, y2 * x1, y2 * y1, y2], -1)
    A = torch.cat([r1, r2], -2)
    Hn = _nullvec(A).reshape(A.shape[:-2] + (3, 3))
    return torch.linalg.inv(T2) @ Hn @ T1


def _homog(p: torch.Tensor) -> torch.Tensor:
    return torch.cat([p, torch.ones_like(p[..., :1])], -1)


def _sym_epipolar_score(F, p1, p2, sigma2=1.0, th=3.841, th_score=5.991):
    """The reference's CheckFundamental scoring: chi-square transfer errors
    both ways, score = sum of (th_score - chi2) over inliers.  F (..., 3, 3),
    points (..., N, 2) -> (ok (..., N), score (...))."""
    x1, x2 = _homog(p1), _homog(p2)
    Fx1 = x1 @ F.transpose(-1, -2)
    Ftx2 = x2 @ F
    x2Fx1 = (x2 * Fx1).sum(-1)
    e2_1 = x2Fx1 ** 2 / torch.clamp(Fx1[..., 0] ** 2 + Fx1[..., 1] ** 2, min=1e-12) / sigma2
    e2_2 = x2Fx1 ** 2 / torch.clamp(Ftx2[..., 0] ** 2 + Ftx2[..., 1] ** 2, min=1e-12) / sigma2
    in1, in2 = e2_1 < th, e2_2 < th
    zero = torch.zeros_like(e2_1)
    score = (torch.where(in1, th_score - e2_1, zero)
             + torch.where(in2, th_score - e2_2, zero)).sum(-1)
    return in1 & in2, score


def _homography_score(H, p1, p2, sigma2=1.0, th=5.991):
    """The reference's CheckHomography scoring: symmetric transfer errors."""
    x1, x2 = _homog(p1), _homog(p2)
    Hx1 = x1 @ H.transpose(-1, -2)
    Hinvx2 = x2 @ torch.linalg.inv(H).transpose(-1, -2)
    p2h = Hx1[..., :2] / torch.clamp(Hx1[..., 2:3], min=1e-12)
    p1h = Hinvx2[..., :2] / torch.clamp(Hinvx2[..., 2:3], min=1e-12)
    e2_2 = ((p2 - p2h) ** 2).sum(-1) / sigma2
    e2_1 = ((p1 - p1h) ** 2).sum(-1) / sigma2
    in1, in2 = e2_1 < th, e2_2 < th
    zero = torch.zeros_like(e2_1)
    score = (torch.where(in1, th - e2_1, zero) + torch.where(in2, th - e2_2, zero)).sum(-1)
    return in1 & in2, score


def _rot_y(c, sn, flip: bool):
    """(4,) cos / sin -> (4, 3, 3): the d' = +d2 rotation about y, or
    (``flip``) the d' = -d2 rotation-with-reflection."""
    z, o = torch.zeros_like(sn), torch.ones_like(sn)
    c = c.expand_as(sn)
    if not flip:
        rows = [[c, z, -sn], [z, o, z], [sn, z, c]]
    else:
        rows = [[c, z, sn], [z, -o, z], [sn, z, -c]]
    return torch.stack([torch.stack(r, -1) for r in rows], -2)


def decompose_homography(H: torch.Tensor, K: torch.Tensor):
    """Faugeras-Lustman decomposition of a calibrated homography (the
    reference's Initializer::ReconstructH candidates; Faugeras & Lustman
    1988).  Returns the 8 candidate motions: R (8, 3, 3), t (8, 3)
    unit-norm, n (8, 3) plane normals towards the camera, and valid ()
    bool, False when d1/d2 or d2/d3 is within 1.00001 (ill-conditioned)."""
    A = torch.linalg.inv(K) @ H @ K
    U, d, Vt = (x.to(A.dtype) for x in torch.linalg.svd(A.double()))
    s = torch.linalg.det(U) * torch.linalg.det(Vt)
    d1, d2, d3 = d[0], d[1], d[2]
    valid = ((d1 / torch.clamp(d2, min=1e-12) > 1.00001)
             & (d2 / torch.clamp(d3, min=1e-12) > 1.00001))
    f = dict(dtype=H.dtype, device=H.device)
    denom = torch.clamp(d1 * d1 - d3 * d3, min=1e-12)
    x1m = torch.sqrt(torch.clamp(d1 * d1 - d2 * d2, min=0.0) / denom)
    x3m = torch.sqrt(torch.clamp(d2 * d2 - d3 * d3, min=0.0) / denom)
    e1 = torch.tensor([1.0, 1.0, -1.0, -1.0], **f)
    e3 = torch.tensor([1.0, -1.0, 1.0, -1.0], **f)
    zero4 = torch.zeros(4, **f)
    root = torch.sqrt(torch.clamp((d1 * d1 - d2 * d2) * (d2 * d2 - d3 * d3), min=0.0))

    # d' = +d2: rotation about y by theta
    den_p = torch.clamp((d1 + d3) * d2, min=1e-12)
    Rp_pos = _rot_y((d2 * d2 + d1 * d3) / den_p, e1 * e3 * root / den_p, flip=False)
    tp_pos = (d1 - d3) * torch.stack([e1 * x1m, zero4, -e3 * x3m], -1)
    np_pos = torch.stack([e1 * x1m, zero4, e3 * x3m], -1)
    # d' = -d2: rotation-with-reflection by phi
    den_n = torch.clamp((d1 - d3) * d2, min=1e-12)
    Rp_neg = _rot_y((d1 * d3 - d2 * d2) / den_n, e1 * e3 * root / den_n, flip=True)
    tp_neg = (d1 + d3) * torch.stack([e1 * x1m, zero4, e3 * x3m], -1)

    Rp = torch.cat([Rp_pos, Rp_neg])
    tp = torch.cat([tp_pos, tp_neg])
    npl = torch.cat([np_pos, np_pos])
    R = s * (U @ Rp @ Vt)
    t = tp @ U.T
    t = t / torch.clamp(torch.linalg.norm(t, dim=-1, keepdim=True), min=1e-12)
    n = npl @ Vt
    n = torch.where(n[..., 2:3] < 0, -n, n)
    return R, t, n, valid


def triangulate(P1: torch.Tensor, P2: torch.Tensor, p1: torch.Tensor, p2: torch.Tensor):
    """DLT triangulation: P (..., 3, 4) projection matrices broadcasting
    against p (..., 2) pixels; returns (..., 3).  The homogeneous divide
    keeps the nullspace vector's sign out of the result, and a vanishing
    last coordinate divides by 1e-12 rather than by zero."""
    rows = torch.stack(torch.broadcast_tensors(
        p1[..., 0, None] * P1[..., 2, :] - P1[..., 0, :],
        p1[..., 1, None] * P1[..., 2, :] - P1[..., 1, :],
        p2[..., 0, None] * P2[..., 2, :] - P2[..., 0, :],
        p2[..., 1, None] * P2[..., 2, :] - P2[..., 1, :],
    ), -2)
    Xh = torch.linalg.svd(rows)[2][..., -1, :]
    w = Xh[..., 3:]
    return Xh[..., :3] / torch.where(w.abs() > 1e-12, w, torch.full_like(w, 1e-12))


class MonoInit(NamedTuple):
    ok: torch.Tensor              # () bool: enough inliers + parallax
    used_homography: torch.Tensor
    T21: torch.Tensor             # (4, 4) pose of frame 2 w.r.t. frame 1 (t unit-norm)
    points3d: torch.Tensor        # (N, 3) triangulated points in frame-1 coords
    inliers: torch.Tensor         # (N,)


def initialize_mono(
    uv1: torch.Tensor,            # (N, 2) matched pixels frame 1
    uv2: torch.Tensor,            # (N, 2) matched pixels frame 2
    valid: torch.Tensor,          # (N,)
    fx, fy, cx, cy,
    sampler: HypothesisSampler,
    frame: int,
    iters: int = 200,
    sigma: float = 1.0,
    min_inliers: int = 50,
) -> MonoInit:
    """Two-view bootstrap of the matches ``uv1[i] <-> uv2[i]``: the better of
    the F and H models (RH rule), its candidate motions triangulated and
    scored on every matched point, and the winner accepted only with
    ``min_inliers`` good model inliers, 70 % of the model's inliers good and
    a clear margin over the runner-up candidate."""
    dev, dt = uv1.device, uv1.dtype
    Kmat = torch.tensor([[fx, 0.0, cx], [0.0, fy, cy], [0.0, 0.0, 1.0]], dtype=dt, device=dev)
    vf = valid.to(dt)
    pr = vf / torch.clamp(vf.sum(), min=1.0)
    idxF = sampler(pr[None], iters, Sites([(frame, "mono_F")]), k=8)[0]
    idxH = sampler(pr[None], iters, Sites([(frame, "mono_H")]), k=4)[0]
    Fs = eight_point_F(uv1[idxF], uv2[idxF])
    Hs = four_point_H(uv1[idxH], uv2[idxH])
    s2 = sigma * sigma
    okF, scF = _sym_epipolar_score(Fs, uv1[None], uv2[None], s2)
    okH, scH = _homography_score(Hs, uv1[None], uv2[None], s2)
    neg = torch.full_like(scF, -1.0)
    scF = torch.where(torch.isfinite(Fs.reshape(iters, -1)).all(-1), scF, neg)
    scH = torch.where(torch.isfinite(Hs.reshape(iters, -1)).all(-1), scH, neg)
    bF, bH = torch.argmax(scF), torch.argmax(scH)
    SF, SH = scF[bF], scH[bH]
    use_H = SH / torch.clamp(SH + SF, min=1e-9) > 0.40   # Initializer RH rule
    inl = torch.where(use_H, okH[bH], okF[bF]) & valid

    # essential decomposition (F model): 4 candidates and 4 masked pads
    E = Kmat.T @ Fs[bF] @ Kmat
    U, _, Vt = (x.to(dt) for x in torch.linalg.svd(E.double()))
    W = torch.tensor([[0.0, -1.0, 0.0], [1.0, 0.0, 0.0], [0.0, 0.0, 1.0]], dtype=dt,
                     device=dev)
    R1 = U @ W @ Vt
    R2 = U @ W.T @ Vt
    R1 = R1 * torch.sign(torch.linalg.det(R1))
    R2 = R2 * torch.sign(torch.linalg.det(R2))
    tvec = U[:, 2] / torch.clamp(torch.linalg.norm(U[:, 2]), min=1e-12)
    eye = torch.eye(4, dtype=dt, device=dev)
    cands_E = torch.stack([se3.make_T(R1, tvec), se3.make_T(R1, -tvec),
                           se3.make_T(R2, tvec), se3.make_T(R2, -tvec),
                           eye, eye, eye, eye])
    valid_E = torch.tensor([True] * 4 + [False] * 4, device=dev)
    # Faugeras decomposition (H model): 8 candidates
    RsH, tsH, _, h_ok = decompose_homography(Hs[bH], Kmat)
    cands_H = se3.make_T(RsH, tsH)
    cand_T = torch.where(use_H, cands_H, cands_E)
    cand_valid = torch.where(use_H, h_ok.expand(8), valid_E)

    # every point under every candidate (8, N)
    P1 = Kmat @ eye[:3]
    P2 = (Kmat @ cand_T[:, :3])[:, None]                            # (8, 1, 3, 4)
    X = triangulate(P1, P2, uv1, uv2)                               # (8, N, 3)
    z1 = X[..., 2]
    Xc2 = se3.transform(cand_T, X)
    z2 = Xc2[..., 2]
    # reprojection gate in both views (Initializer CheckRT: err2 < 4 sigma2);
    # with pure cheirality the two Faugeras planar solutions tie
    u1 = fx * X[..., 0] / z1 + cx
    v1 = fy * X[..., 1] / z1 + cy
    u2 = fx * Xc2[..., 0] / z2 + cx
    v2 = fy * Xc2[..., 1] / z2 + cy
    e1 = (u1 - uv1[..., 0]) ** 2 + (v1 - uv1[..., 1]) ** 2
    e2 = (u2 - uv2[..., 0]) ** 2 + (v2 - uv2[..., 1]) ** 2
    ok_geom = ((z1 > 0) & (z2 > 0) & torch.isfinite(z1) & torch.isfinite(z2)
               & (e1 < 4.0 * s2) & (e2 < 4.0 * s2))
    # candidate selection scores ALL matched points (as the JAX package
    # does; the reference scores model inliers only): on a plane-dominant
    # scene the two Faugeras solutions tie on the planar inliers, and only
    # the off-plane points separate the true motion from its planar twin
    goods = inl & ok_geom
    ns_sel = torch.where(cand_valid, (valid & ok_geom).sum(-1),
                         torch.full((8,), -1, dtype=torch.int64, device=dev))
    best_c = torch.argmax(ns_sel)
    n_good = goods.sum(-1)[best_c]
    n_inl = inl.sum()
    # the winner must clearly dominate the runner-up (the role of the
    # reference's secondBestGood < 0.75 bestGood): relative (< 0.9) and an
    # absolute gap
    second = torch.sort(ns_sel).values[-2].to(dt)
    best_sel = ns_sel[best_c].to(dt)
    gap_ok = (second < 0.9 * best_sel) & (
        (best_sel - second) > torch.clamp(0.02 * valid.sum().to(dt), min=10.0))
    ok = (n_good > min_inliers) & (n_good.to(dt) > 0.7 * n_inl.to(dt)) & gap_ok
    return MonoInit(ok=ok, used_homography=use_H, T21=cand_T[best_c],
                    points3d=X[best_c], inliers=goods[best_c])
