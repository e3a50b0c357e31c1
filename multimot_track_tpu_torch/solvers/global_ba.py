"""Global bundle adjustment over the keyframe graph, run after a loop closes.

Port of ``multimot_track_tpu.solvers.global_ba``: all keyframe poses (pose
0 is the gauge) and the landmarks seen by at least two keyframes, solved
jointly.  Landmarks are Schur-eliminated with closed-form 3x3 block
inverses over the (L, O) observation table; the reduced camera system is
dense (6K x 6K).  Levenberg accept / reject with the JAX package's stop
rule, one host read per step.

Measurement model per observation (landmark l seen by keyframe k):
  y       = Tcw_k @ X_l
  r_uv    = uv_obs - pi(y)                  (pixels)
  r_disp  = disp_obs - bf / y_z             (pixels; the stereo row)
with Huber IRLS on ||r_uv|| and a depth-variance weight on the disparity
row (sigma_z ~ z^2).
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from multimot_track_tpu_torch.geometry import se3


class GlobalBAParams(NamedTuple):
    iters: int = 25
    huber_px: float = 2.0        # Huber delta on the pixel residual norm
    disp_info: float = 0.5       # information of the disparity row
    depth_weight_z0: float = 15.0  # z-variance model scale (SolverConfig)
    tau: float = 1e-4            # lambda_0 = tau
    rel_tol: float = 1e-6


class GlobalBAResult(NamedTuple):
    poses: torch.Tensor       # (K, 4, 4) optimised Tcw (pose 0 = gauge, fixed)
    X: torch.Tensor           # (L, 3) optimised landmark positions (world)
    chi2_init: torch.Tensor   # () robust objective before
    chi2: torch.Tensor        # () robust objective after


def _disp_weight(obs_disp, bf, p: GlobalBAParams):
    z_meas = bf / torch.clamp(obs_disp, min=1e-3)
    return p.disp_info / (1.0 + (z_meas / p.depth_weight_z0) ** 2)


def _residuals(T_stack, X, obs_kf, obs_uv, obs_disp, fx, fy, cx, cy, bf):
    """(r (L, O, 3), y (L, O, 3), z (L, O), Tk (L, O, 4, 4))."""
    Tk = T_stack[obs_kf]                              # (L, O, 4, 4)
    y = torch.einsum("loij,lj->loi", Tk[..., :3, :3], X) + Tk[..., :3, 3]
    z = torch.clamp(y[..., 2], min=1e-3)
    r = torch.stack([obs_uv[..., 0] - (fx * y[..., 0] / z + cx),
                     obs_uv[..., 1] - (fy * y[..., 1] / z + cy),
                     obs_disp - bf / z], -1)
    return r, y, z, Tk


def _obs_terms(T_stack, X, obs_kf, obs_uv, obs_disp, obs_w,
               fx, fy, cx, cy, bf, p: GlobalBAParams):
    """Per-observation residuals, IRLS weights and Jacobian blocks.

    Shapes: T_stack (K, 4, 4); X (L, 3); obs_* (L, O, ...).  Returns r
    (L, O, 3), w3 (L, O, 3) per-row information, Jp (L, O, 3, 6), Jx
    (L, O, 3, 3)."""
    r, y, z, Tk = _residuals(T_stack, X, obs_kf, obs_uv, obs_disp, fx, fy, cx, cy, bf)
    r_px = torch.sqrt(r[..., 0] ** 2 + r[..., 1] ** 2 + 1e-12)
    w_rob = obs_w * torch.clamp(p.huber_px / r_px, max=1.0)
    w3 = torch.stack([w_rob, w_rob, w_rob * _disp_weight(obs_disp, bf, p)], -1)

    inv_z = 1.0 / z
    zero = torch.zeros_like(z)
    dpi = torch.stack([
        torch.stack([fx * inv_z, zero, -fx * y[..., 0] * inv_z * inv_z], -1),
        torch.stack([zero, fy * inv_z, -fy * y[..., 1] * inv_z * inv_z], -1),
        torch.stack([zero, zero, bf * inv_z * inv_z], -1),
    ], -2)
    # r = obs - h(y): dr/d. = -dh/dy @ dy/d.  (left update T <- exp(xi) T)
    return r, w3, -(dpi @ se3.point_jacobian(y)), -(dpi @ Tk[..., :3, :3])


def _objective(T_stack, X, obs_kf, obs_uv, obs_disp, obs_w,
               fx, fy, cx, cy, bf, p: GlobalBAParams):
    r, _, _, _ = _residuals(T_stack, X, obs_kf, obs_uv, obs_disp, fx, fy, cx, cy, bf)
    # robust pixel part: Huber(chi2_px) with delta^2 = huber_px^2
    chi2_px = r[..., 0] ** 2 + r[..., 1] ** 2
    d2 = p.huber_px ** 2
    rho = torch.where(chi2_px <= d2, chi2_px,
                      2.0 * torch.sqrt(d2 * torch.clamp(chi2_px, min=1e-20)) - d2)
    return (obs_w * (rho + _disp_weight(obs_disp, bf, p) * r[..., 2] ** 2)).sum()


def solve_global_ba(
    poses_Tcw: torch.Tensor,  # (K, 4, 4)
    X0: torch.Tensor,         # (L, 3) landmark inits (world)
    obs_kf: torch.Tensor,     # (L, O) int keyframe index per observation
    obs_uv: torch.Tensor,     # (L, O, 2) pixel observations
    obs_disp: torch.Tensor,   # (L, O) measured disparity bf/z
    obs_w: torch.Tensor,      # (L, O) observation weight; 0 = padding
    fx, fy, cx, cy, bf,
    params: GlobalBAParams = GlobalBAParams(),
) -> GlobalBAResult:
    p = params
    K, O = poses_Tcw.shape[0], obs_kf.shape[1]
    f32, dev = torch.float32, poses_Tcw.device
    obs_kf = obs_kf.long()
    T0, X_init = poses_Tcw.to(f32), X0.to(f32)
    eye3 = torch.eye(3, dtype=f32, device=dev)
    eye6 = torch.eye(6, dtype=f32, device=dev)
    kf_flat = obs_kf.reshape(-1)
    # gauge: pose 0 fixed, its rows and columns masked, identity diagonal
    free = (torch.arange(6 * K, device=dev) >= 6).to(f32)
    args = (obs_kf, obs_uv, obs_disp, obs_w, fx, fy, cx, cy, bf, p)

    def gn_step(T_stack, X, lam):
        r, w3, Jp, Jx = _obs_terms(T_stack, X, *args)
        WJp = w3[..., None] * Jp                       # (L, O, 3, 6)
        WJx = w3[..., None] * Jx                       # (L, O, 3, 3)
        Hpp_o = Jp.transpose(-1, -2) @ WJp             # (L, O, 6, 6)
        # the right-hand side of H dx = b is b = -J^T W r
        bp_o = -(WJp.transpose(-1, -2) @ r[..., None])[..., 0]          # (L, O, 6)
        Hll = (Jx.transpose(-1, -2) @ WJx).sum(1)                       # (L, 3, 3)
        bl = -(WJx.transpose(-1, -2) @ r[..., None])[..., 0].sum(1)     # (L, 3)
        Wblk = Jp.transpose(-1, -2) @ WJx              # (L, O, 6, 3)

        Hpp = torch.zeros((K, 6, 6), dtype=f32, device=dev).index_add_(
            0, kf_flat, Hpp_o.reshape(-1, 6, 6))
        bp = torch.zeros((K, 6), dtype=f32, device=dev).index_add_(
            0, kf_flat, bp_o.reshape(-1, 6))

        # damped landmark blocks, inverted in closed form per landmark
        Hll_inv = torch.linalg.inv_ex(Hll + (lam + 1e-8) * eye3)[0]    # (L, 3, 3)
        U = Wblk @ Hll_inv[:, None]                                     # (L, O, 6, 3)

        # reduced camera system S = Hpp + lam I - sum_l U W^T, scattered
        # into (K * K) blocks
        S = torch.zeros((K * K, 6, 6), dtype=f32, device=dev)
        diag_rows = torch.arange(K, device=dev) * (K + 1)
        S.index_add_(0, diag_rows, Hpp + lam * eye6)
        for o1 in range(O):
            for o2 in range(O):
                C = U[:, o1] @ Wblk[:, o2].transpose(-1, -2)
                S.index_add_(0, obs_kf[:, o1] * K + obs_kf[:, o2], -C)
        Ub = (U @ bl[:, None, :, None])[..., 0]        # (L, O, 6)
        b_red = bp.index_add(0, kf_flat, -Ub.reshape(-1, 6))

        Sm = S.reshape(K, K, 6, 6).transpose(1, 2).reshape(6 * K, 6 * K)
        Sm = Sm * free[:, None] * free[None, :] + torch.diag(1.0 - free)
        bm = b_red.reshape(6 * K) * free
        dxi = torch.linalg.solve_ex(Sm, bm[:, None])[0][:, 0].reshape(K, 6)

        # back-substitute the landmarks
        Wt_dxi = (Wblk.transpose(-1, -2) @ dxi[obs_kf][..., None])[..., 0].sum(1)   # (L, 3)
        dX = (Hll_inv @ (bl - Wt_dxi)[..., None])[..., 0]
        return se3.exp_se3(dxi) @ T_stack, X + dX

    F0 = _objective(T0, X_init, *args)
    T, X, F = T0, X_init, F0
    lam = torch.tensor(p.tau, dtype=f32, device=dev)
    nu = torch.tensor(2.0, dtype=f32, device=dev)
    for _ in range(p.iters):
        T_new, X_new = gn_step(T, X, lam)
        F_new = _objective(T_new, X_new, *args)
        accept = (F_new < F) & torch.isfinite(F_new)
        done = (accept & (F - F_new < p.rel_tol * F + 1e-10)) | (lam > 1e8)
        T = torch.where(accept, T_new, T)
        X = torch.where(accept, X_new, X)
        F = torch.where(accept, F_new, F)
        lam = torch.where(accept, lam / 3.0, lam * nu)
        nu = torch.where(accept, torch.full_like(nu, 2.0), nu * 2.0)
        if bool(done):            # the JAX while_loop's data-dependent stop
            break
    return GlobalBAResult(poses=T, X=X, chi2_init=F0, chi2=F)
