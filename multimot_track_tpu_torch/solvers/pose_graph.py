"""Pose-graph optimisation: the essential-graph solve of loop closing.

Port of ``multimot_track_tpu.solvers.pose_graph``.  Relative SE(3)
constraints between poses, the edge residual r_e = Log(Z_ij^-1 Ti Tj^-1)
evaluated for all edges as one batch, and two solvers of it:

* :func:`optimize_pose_graph`: exact dense Gauss-Newton with the Jacobian
  from ``torch.func.jacfwd`` and one (6M)^2 solve per step, at keyframe
  scale (M <= 256 poses in the loop ladder);
* :func:`optimize_pose_graph_cg`: analytic edge Jacobians and a
  matrix-free, block-Jacobi preconditioned conjugate-gradient solve of the
  normal equations, O(E) memory, for longer trajectories.  Its CG runs a
  fixed number of steps with no early exit and no host read inside.

Gauge: pose 0 is fixed.  Both solvers run in the poses' dtype (float32 in
the loop ladder).
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from multimot_track_tpu_torch.geometry import se3


class PoseGraphResult(NamedTuple):
    poses: torch.Tensor    # (M, 4, 4) optimised
    chi2: torch.Tensor


def optimize_pose_graph(
    poses_init: torch.Tensor,   # (M, 4, 4) Tcw estimates
    edges_ij: torch.Tensor,     # (E, 2) int (i, j) pose indices
    Z: torch.Tensor,            # (E, 4, 4) measured T_i @ T_j^-1
    weights: torch.Tensor,      # (E,) edge information scale
    iters: int = 20,
    lam: float = 1e-4,
) -> PoseGraphResult:
    M = poses_init.shape[0]
    dev, dt = poses_init.device, poses_init.dtype
    ii, jj = edges_ij[:, 0].long(), edges_ij[:, 1].long()
    Zinv, sw = se3.inverse(Z), torch.sqrt(weights.to(dt))

    def residuals(xi_flat, base):
        T = se3.exp_se3(xi_flat.reshape(M, 6)) @ base
        err = Zinv @ (T[ii] @ se3.inverse(T[jj]))
        return (se3.log_se3(err) * sw[:, None]).reshape(-1)

    jac = torch.func.jacfwd(residuals)
    # gauge: pose 0 fixed by zeroing its columns
    mask = torch.cat([torch.zeros(6, dtype=dt, device=dev),
                      torch.ones(6 * (M - 1), dtype=dt, device=dev)])
    lam_eye = lam * torch.eye(6 * M, dtype=dt, device=dev)
    xi0 = torch.zeros(6 * M, dtype=dt, device=dev)
    poses = poses_init
    for _ in range(iters):
        r = residuals(xi0, poses)
        J = jac(xi0, poses) * mask                          # (6E, 6M)
        # solve_ex: no host sync on the info flag
        dxi = torch.linalg.solve_ex(J.T @ J + lam_eye, -(J.T @ r)[:, None])[0][:, 0] * mask
        poses = se3.exp_se3(dxi.reshape(M, 6)) @ poses
    r_fin = residuals(xi0, poses)
    return PoseGraphResult(poses=poses, chi2=(r_fin * r_fin).sum())


def _ad_se3(xi: torch.Tensor) -> torch.Tensor:
    """Little adjoint ad(xi) for the (omega, upsilon) ordering:
    ad = [[hat(w), 0], [hat(v), hat(w)]]."""
    hw, hv = se3.hat(xi[..., :3]), se3.hat(xi[..., 3:])
    return torch.cat([torch.cat([hw, torch.zeros_like(hw)], -1),
                      torch.cat([hv, hw], -1)], -2)


def _scatter_rows(M: int, ii, a, jj, b) -> torch.Tensor:
    """(M, ...) sums of per-edge terms a at rows ii, then b at rows jj."""
    out = torch.zeros((M,) + a.shape[1:], dtype=a.dtype, device=a.device)
    return out.index_add_(0, ii, a).index_add_(0, jj, b)


def optimize_pose_graph_cg(
    poses_init: torch.Tensor,   # (M, 4, 4) Tcw estimates
    edges_ij: torch.Tensor,     # (E, 2) int (i, j) pose indices
    Z: torch.Tensor,            # (E, 4, 4) measured T_i @ T_j^-1
    weights: torch.Tensor,      # (E,) edge information scale
    iters: int = 20,
    cg_iters: int | None = None,
    lam: float = 1e-4,
) -> PoseGraphResult:
    """Pose-graph Gauss-Newton with analytic edge Jacobians
    (J_i = Jl^-1(r) Ad(Z^-1), J_j = -Jl^-1(r) Ad(Z^-1 A), Jl^-1 ~ I - ad(r)/2)
    and matrix-free preconditioned CG; the model of
    :func:`optimize_pose_graph`.  ``cg_iters`` defaults to max(60, 1.5 M): a
    loop correction moves one edge along the chain per CG step."""
    M = poses_init.shape[0]
    dev, dt = poses_init.device, poses_init.dtype
    if cg_iters is None:
        cg_iters = max(60, int(1.5 * M))
    ii, jj = edges_ij[:, 0].long(), edges_ij[:, 1].long()
    Zinv, sw = se3.inverse(Z), torch.sqrt(weights.to(dt))
    eye6 = torch.eye(6, dtype=dt, device=dev)
    gauge = (torch.arange(M, device=dev) > 0).to(dt)[:, None]   # pose 0 fixed

    def edge_terms(T):
        err = Zinv @ (T[ii] @ se3.inverse(T[jj]))
        r = se3.log_se3(err)                                  # (E, 6)
        Jl_inv = eye6 - 0.5 * _ad_se3(r)
        Ji = Jl_inv @ se3.adjoint(Zinv)
        Jj = -(Jl_inv @ se3.adjoint(err))                     # Ad(Z^-1 A) = Ad(err)
        return r * sw[:, None], Ji * sw[:, None, None], Jj * sw[:, None, None]

    def matvec(Jm, x):                                        # (E, 6, 6) x (E, 6)
        return (Jm @ x[..., None])[..., 0]

    poses = poses_init
    for _ in range(iters):
        r, Ji, Jj = edge_terms(poses)
        JiT, JjT = Ji.transpose(-1, -2), Jj.transpose(-1, -2)

        def Hx(x):                                            # x: (M, 6)
            x = x * gauge
            ax = matvec(Ji, x[ii]) + matvec(Jj, x[jj])        # J x
            y = _scatter_rows(M, ii, matvec(JiT, ax), jj, matvec(JjT, ax))
            return (y + lam * x) * gauge

        g = _scatter_rows(M, ii, matvec(JiT, r), jj, matvec(JjT, r)) * gauge
        # block-Jacobi preconditioner: the 6x6 diagonal blocks of H
        diag = _scatter_rows(M, ii, JiT @ Ji, jj, JjT @ Jj) + (lam + 1e-6) * eye6
        Minv = torch.linalg.inv_ex(diag)[0]

        def apply_M(v):
            return matvec(Minv, v) * gauge

        # preconditioned CG on H dxi = -g, a fixed number of steps
        x = torch.zeros((M, 6), dtype=dt, device=dev)
        rr = -g
        z = apply_M(rr)
        p, rz = z, (rr * z).sum()
        for _ in range(cg_iters):
            Hp = Hx(p)
            pHp = (p * Hp).sum()
            alpha = torch.where(pHp > 1e-20, rz / torch.clamp(pHp, min=1e-20),
                                torch.zeros_like(pHp))
            x = x + alpha * p
            rr = rr - alpha * Hp
            z = apply_M(rr)
            rz_new = (rr * z).sum()
            beta = torch.where(rz > 1e-20, rz_new / torch.clamp(rz, min=1e-20),
                               torch.zeros_like(rz))
            p = z + beta * p
            rz = rz_new
        # a broken-down CG round (non-finite direction) is skipped
        x = torch.where(torch.isfinite(x), x, torch.zeros_like(x))
        poses = se3.exp_se3(x) @ poses
    r_fin, _, _ = edge_terms(poses)
    return PoseGraphResult(poses=poses, chi2=(r_fin * r_fin).sum())


def odometry_edges(poses: torch.Tensor):
    """Consecutive-pose odometry constraints of a trajectory: edges
    (i, i-1) and Z = T_i T_{i-1}^-1."""
    M = poses.shape[0]
    ar = torch.arange(M, device=poses.device)
    ij = torch.stack([ar[1:], ar[:-1]], -1).to(torch.int32)
    return ij, poses[1:] @ se3.inverse(poses[:-1])
