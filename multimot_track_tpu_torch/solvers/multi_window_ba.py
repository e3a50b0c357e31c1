"""Sliding-window joint ego + multi-object motion refinement.

Port of ``multimot_track_tpu.solvers.multi_window_ba``.  Variables: the
camera pose deltas xi_f of window frames 1..F-1 (frame 0 is the gauge) and
the world-frame object motion deltas eta_{f,k} per pair and object slot.
Residuals: static and object flow reprojection per pair (depths are fixed
measurements), the constant-motion smoothness prior Log(H_{f,k}^-1
H_{f+1,k}), the odometry prior on each consecutive relative pose, and the
motion prior holding each object motion near its online estimate.

``iters`` Gauss-Newton steps on the dense ``J^T J + lam I`` (D = 6(F-1)(1+K)
unknowns).  ``J`` is the forward-mode Jacobian (``torch.func.jacfwd``) of
the unweighted residuals; the Huber IRLS weights are computed from the
primal residuals once per step and enter as constant row scales, which is
what the JAX package's ``stop_gradient`` on the weight amounts to.

Inside the live system's ``joint_ba`` span, ``refine_window``'s parts are
the spans ``problem`` (the residual model), ``jacobian`` (each step's
residuals, row weights and Jacobian) and ``solve`` (each step's normal
equations and solve, and the final residuals).
"""

from __future__ import annotations

from typing import Callable, NamedTuple

import torch

from multimot_track_tpu_torch.geometry import camera, se3
from multimot_track_tpu_torch.utils.profiling import span


class MultiWindowParams(NamedTuple):
    iters: int = 15
    huber_px: float = 1.0
    w_static: float = 1.0
    w_object: float = 1.0
    w_smooth: float = 100.0         # information on the constant-motion prior
    w_odo: float = 0.0              # se(3) information of the odometry prior
    w_motion_prior: float = 0.0     # information holding eta near 0
    # drop object points whose residual under the online init exceeds this
    # (px; 0 disables)
    obj_init_gate_px: float = 0.0
    lam: float = 1e-3


class MultiWindowResult(NamedTuple):
    poses: torch.Tensor      # (F, 4, 4) refined Tcw
    motions: torch.Tensor    # (F-1, K, 4, 4) refined world-frame H
    chi2: torch.Tensor


def _tf(T: torch.Tensor, X: torch.Tensor) -> torch.Tensor:
    """Apply transforms (..., 4, 4) to point sets (..., n, 3)."""
    return (X @ T[..., :3, :3].transpose(-1, -2)) + T[..., None, :3, 3]


class WindowProblem(NamedTuple):
    raw_residuals: Callable   # v (D,) -> unweighted residuals (R,)
    row_scale: Callable       # primal raw residuals (R,) -> row weights (R,)
    unpack: Callable          # v -> (poses (F, 4, 4), motions (F-1, K, 4, 4), eta)
    D: int                    # unknowns: 6(F-1)(1+K)


def window_problem(
    poses_init: torch.Tensor,     # (F, 4, 4) Tcw from the online pass
    motions_init: torch.Tensor,   # (F-1, K, 4, 4) object motions per pair / slot
    motions_valid: torch.Tensor,  # (F-1, K) bool
    st_uv: torch.Tensor,          # (F-1, N, 2) last-frame static observations
    st_flow: torch.Tensor,        # (F-1, N, 2)
    st_depth: torch.Tensor,       # (F-1, N)
    st_valid: torch.Tensor,       # (F-1, N) bool mask or float weights
    ob_uv: torch.Tensor,          # (F-1, K, M, 2) object points per pair / slot
    ob_flow: torch.Tensor,        # (F-1, K, M, 2)
    ob_depth: torch.Tensor,       # (F-1, K, M)
    ob_valid: torch.Tensor,       # (F-1, K, M) bool mask or float weights
    fx: float, fy: float, cx: float, cy: float,
    params: MultiWindowParams = MultiWindowParams(),
) -> WindowProblem:
    """The residual model of ``refine_window`` (with its one-shot object
    gate applied): the weighted residual at v is
    ``row_scale(raw_residuals(v)) * raw_residuals(v)``."""
    p = params
    F, K = poses_init.shape[0], motions_init.shape[1]
    dev, f32 = poses_init.device, torch.float32
    Z_odo_inv = se3.inverse(poses_init[1:] @ se3.inverse(poses_init[:-1]))   # measured rels
    mv = motions_valid.to(f32)

    Xl = camera.backproject(st_uv, st_depth, fx, fy, cx, cy)   # (F-1, N, 3)
    Xo = camera.backproject(ob_uv, ob_depth, fx, fy, cx, cy)   # (F-1, K, M, 3)
    st_target = st_uv + st_flow
    ob_target = ob_uv + ob_flow

    if p.obj_init_gate_px > 0.0:
        # one-shot outlier gate at the online init (v = 0)
        Xw0 = _tf(se3.inverse(poses_init[:-1])[:, None], Xo)
        yo0 = _tf(poses_init[1:, None], _tf(motions_init, Xw0))
        r0 = ob_target - camera.project(yo0, fx, fy, cx, cy)
        ob_valid = ob_valid * ((r0 * r0).sum(-1) < p.obj_init_gate_px ** 2).to(ob_valid.dtype)

    def unpack(v):
        xi = v[: 6 * (F - 1)].reshape(F - 1, 6)
        eta = v[6 * (F - 1):].reshape(F - 1, K, 6)
        T = torch.cat([poses_init[:1], se3.exp_se3(xi) @ poses_init[1:]], 0)
        return T, se3.exp_se3(eta) @ motions_init, eta

    def raw_residuals(v):
        """Unweighted residual pieces, flattened and concatenated in the JAX
        package's order: static, object, smoothness, odometry, motion prior."""
        T, H, eta = unpack(v)
        Twl = se3.inverse(T[:-1])                            # (F-1, 4, 4)
        Tc = T[1:]
        # static: (obs + flow) - pi(Tc_f Twc_{f-1} X_l)
        r_s = st_target - camera.project(_tf(Tc, _tf(Twl, Xl)), fx, fy, cx, cy)
        # objects: (obs + flow) - pi(Tc_f H_{f,k} Twc_{f-1} X_l)
        yo = _tf(Tc[:, None], _tf(H, _tf(Twl[:, None], Xo)))
        r_o = ob_target - camera.project(yo, fx, fy, cx, cy)
        r_m = se3.log_se3(se3.inverse(H[:-1]) @ H[1:])     # (F-2, K, 6)
        r_odo = se3.log_se3(T[1:] @ se3.inverse(T[:-1]) @ Z_odo_inv)
        return torch.cat([r_s.reshape(-1), r_o.reshape(-1), r_m.reshape(-1),
                          r_odo.reshape(-1), eta.reshape(-1)])

    n_s, n_o = st_uv[..., 0].numel(), ob_uv[..., 0].numel()
    w_m = (motions_valid[:-1] & motions_valid[1:]).to(f32)
    fixed_scale = torch.cat([
        (p.w_smooth ** 0.5 * w_m[..., None]).expand(F - 2, K, 6).reshape(-1),
        torch.full((6 * (F - 1),), p.w_odo ** 0.5, dtype=f32, device=dev),
        (p.w_motion_prior ** 0.5 * mv[..., None]).expand(F - 1, K, 6).reshape(-1),
    ])
    w_o = ob_valid.to(f32) * mv[..., None]

    def row_scale(r_raw):
        """Per-row weights at the primal residuals: Huber IRLS weights
        (frozen for the step) times the masks, then the priors' scales."""
        def irls(r, w, mask):
            wi = torch.clamp(p.huber_px / torch.sqrt((r * r).sum(-1) + 1e-12), max=1.0)
            return (mask.to(f32) * torch.sqrt(w * wi))[..., None].expand(r.shape).reshape(-1)

        r_s = r_raw[: 2 * n_s].reshape(st_uv.shape)
        r_o = r_raw[2 * n_s: 2 * (n_s + n_o)].reshape(ob_uv.shape)
        return torch.cat([irls(r_s, p.w_static, st_valid), irls(r_o, p.w_object, w_o),
                          fixed_scale])

    return WindowProblem(raw_residuals, row_scale, unpack, 6 * (F - 1) * (1 + K))


def refine_window(
    poses_init: torch.Tensor,     # (F, 4, 4) Tcw from the online pass
    motions_init: torch.Tensor,   # (F-1, K, 4, 4) object motions per pair / slot
    motions_valid: torch.Tensor,  # (F-1, K) bool
    st_uv: torch.Tensor,          # (F-1, N, 2) last-frame static observations
    st_flow: torch.Tensor,        # (F-1, N, 2)
    st_depth: torch.Tensor,       # (F-1, N)
    st_valid: torch.Tensor,       # (F-1, N) bool mask or float weights
    ob_uv: torch.Tensor,          # (F-1, K, M, 2) object points per pair / slot
    ob_flow: torch.Tensor,        # (F-1, K, M, 2)
    ob_depth: torch.Tensor,       # (F-1, K, M)
    ob_valid: torch.Tensor,       # (F-1, K, M) bool mask or float weights
    fx: float, fy: float, cx: float, cy: float,
    params: MultiWindowParams = MultiWindowParams(),
) -> MultiWindowResult:
    with span("problem"):
        pb = window_problem(poses_init, motions_init, motions_valid, st_uv, st_flow, st_depth,
                            st_valid, ob_uv, ob_flow, ob_depth, ob_valid, fx, fy, cx, cy, params)
        dev, f32 = poses_init.device, torch.float32
        lam_eye = params.lam * torch.eye(pb.D, dtype=f32, device=dev)
        jac = torch.func.jacfwd(pb.raw_residuals)
        v = torch.zeros(pb.D, dtype=f32, device=dev)
    for _ in range(params.iters):
        with span("jacobian"):
            r_raw = pb.raw_residuals(v)
            s = pb.row_scale(r_raw)
            J = s[:, None] * jac(v)
            r = s * r_raw
        with span("solve"):
            # solve_ex: no host sync on the info flag
            v = v + torch.linalg.solve_ex(J.T @ J + lam_eye, -(J.T @ r)[:, None])[0][:, 0]
    with span("solve"):
        r_raw = pb.raw_residuals(v)
        r_fin = pb.row_scale(r_raw) * r_raw
        T, Hm, _ = pb.unpack(v)
        return MultiWindowResult(poses=T, motions=Hm, chi2=(r_fin * r_fin).sum())
