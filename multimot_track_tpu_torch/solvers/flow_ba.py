"""Flow-aware pose/motion bundle adjustment, Schur-reduced, batched.

Port of ``multimot_track_tpu.solvers.flow_ba``: one SE(3) pose plus one
marginalised 2-D flow variable per point, with

  binary edge   r_p = (obs + f) - pi(T @ X_w),  info w_p (x point weight),
                Huber delta^2 = rp_thres
  unary edge    r_f = f - flow_meas,            info w_f

and a Levenberg-Marquardt loop (Nielsen's lambda schedule) that stops at
``rel_tol`` or the iteration cap.  Every per-point flow block is a scalar
times I2, so the Schur complement onto the pose is a masked reduction over
the points.

``solve_flow_ba`` is the plain torch version: it solves M independent
instances at once, freezing each instance's state from the iteration its
``done`` flag rises, exactly as ``vmap`` of the JAX ``while_loop`` does.
``solve_flow_ba_auto`` dispatches: the CUDA kernel (solvers/flow_ba_cuda.py)
for CUDA tensors, this version for CPU tensors.  There is no fallback
between the two.  ``flow_ba_route`` reads a config's route for every caller;
``linearise`` is also the point-sharded solver's (parallel/dist_ba).

``solve_flow_depth_ba`` is the experimental variant with per-point depth
as a third point variable (3x3 Schur blocks); it has no caller in either
package and runs as plain torch on the caller's device.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from multimot_track_tpu_torch.geometry import camera, se3, smallsolve


class FlowBAParams(NamedTuple):
    reproj_info: float = 0.1     # w_p
    prior_info: float = 0.3      # w_f  (0.3 camera / 0.5 object)
    rp_thres: float = 0.04       # chi2 inlier gate; huber delta^2
    iters: int = 100             # LM iteration cap
    tau: float = 1e-5            # lambda_0 = tau * max diag(H)
    rel_tol: float = 1e-6        # accepted-step relative-decrease stop


class FlowBAResult(NamedTuple):
    T: torch.Tensor            # (M, 4, 4) optimised pose
    flow: torch.Tensor         # (M, N, 2) optimised flow
    chi2: torch.Tensor         # (M, N) final unweighted reprojection chi2
    inliers: torch.Tensor      # (M, N) bool, chi2 <= rp_thres
    n_inliers: torch.Tensor    # (M,) int64
    mean_reproj: torch.Tensor  # (M,) mean sqrt(chi2) over inliers


def empty_result(M: int, N: int, device) -> FlowBAResult:
    """Uninitialised tensors shaped and typed as a solve of M instances of
    N points returns them."""
    e = lambda *shape, dtype=torch.float32: torch.empty(shape, dtype=dtype, device=device)
    return FlowBAResult(T=e(M, 4, 4), flow=e(M, N, 2), chi2=e(M, N),
                        inliers=e(M, N, dtype=torch.bool), n_inliers=e(M, dtype=torch.int64),
                        mean_reproj=e(M))


def world_points(Twl, obs, depth, fx, fy, cx, cy):
    """X_w = Twl @ pi^-1(obs, depth): (M, N, 3)."""
    return se3.transform(Twl, camera.backproject(obs, depth, fx, fy, cx, cy))


def residual_chi2(T, f, Xw, obs, flow_meas, valid, p: FlowBAParams, fx, fy, cx, cy,
                  w_pt=1.0):
    """Robust total objective F (M,) and raw per-point chi2 (M, N)."""
    r_p = (obs + f) - camera.project(se3.transform(T, Xw), fx, fy, cx, cy)
    chi2_p = p.reproj_info * (r_p * r_p).sum(-1)
    chi2_w = w_pt * chi2_p
    d2 = p.rp_thres
    rho = torch.where(chi2_w <= d2, chi2_w,
                      2.0 * torch.sqrt(d2 * torch.clamp(chi2_w, min=1e-20)) - d2)
    r_f = f - flow_meas
    chi2_f = p.prior_info * (r_f * r_f).sum(-1)
    F = torch.where(valid, rho + chi2_f, torch.zeros_like(rho)).sum(-1)
    return F, chi2_p


def linearise(T, f, Xw, obs, flow_meas, valid, lam, p: FlowBAParams, fx, fy, cx, cy,
              w_pt=1.0):
    """The Gauss-Newton pieces at (T, f), over any leading axes (lam has
    them too): the residual Jacobian A (..., N, 2, 6), the robust
    reprojection information wp (..., N), the flow's gradient g_f
    (..., N, 2) and damped block h_ff (..., N) (times I2), the pose block
    H_TT and gradient g_T, and the flow's Schur terms S_H and S_g of them.
    The reduced system is H_TT + lam I - S_H, g_T - S_g."""
    y = se3.transform(T, Xw)
    r_p = (obs + f) - camera.project(y, fx, fy, cx, cy)
    r_f = f - flow_meas
    chi2_p = w_pt * p.reproj_info * (r_p * r_p).sum(-1)
    w_rob = torch.where(chi2_p <= p.rp_thres, torch.ones_like(chi2_p),
                        torch.sqrt(p.rp_thres / torch.clamp(chi2_p, min=1e-20)))
    vw = torch.where(valid, w_rob, torch.zeros_like(w_rob))
    wp = w_pt * p.reproj_info * vw
    wf = p.prior_info * valid.to(wp.dtype)
    A = -(camera.project_jacobian(y, fx, fy) @ se3.point_jacobian(y))
    h_ff = wp + wf + lam[..., None]
    g_f = wp[..., None] * r_p + wf[..., None] * r_f
    AtW = A * wp[..., None, None]
    return (A, wp, g_f, h_ff,
            torch.einsum("...nia,...nib,...n->...ab", A, A, wp),
            torch.einsum("...nia,...ni,...n->...a", A, r_p, wp),
            torch.einsum("...nia,...nib,...n->...ab", AtW, AtW, 1.0 / h_ff),
            torch.einsum("...nia,...ni,...n->...a", AtW, g_f, 1.0 / h_ff))


def lambda_seed(T_init, Xw, valid, p: FlowBAParams, fx, fy, w_pt=1.0):
    """Each point's reprojection information times its pixel scale
    (fx/z)^2 + (fy/z)^2 at T_init; lambda_0 is tau times the largest."""
    z = torch.clamp(se3.transform(T_init, Xw)[..., 2], min=1e-6)
    scale = (fx / z) ** 2 + (fy / z) ** 2
    return torch.where(valid, w_pt * p.reproj_info * scale, torch.zeros_like(scale))


def _build_and_solve(T, f, Xw, obs, flow_meas, valid, lam, p: FlowBAParams,
                     fx, fy, cx, cy, w_pt=1.0):
    """One damped Gauss-Newton step by analytic Schur elimination of the
    flow.  lam is (M,); returns dxi (M, 6), df (M, N, 2), pred (M,)."""
    A, wp, g_f, h_ff, H_TT, g_T, S_H, S_g = linearise(T, f, Xw, obs, flow_meas, valid, lam,
                                                      p, fx, fy, cx, cy, w_pt=w_pt)
    eye6 = torch.eye(6, dtype=A.dtype, device=A.device)
    H_red = H_TT + lam[:, None, None] * eye6 - S_H
    g_red = g_T - S_g

    dxi = smallsolve.solve_spd6(H_red, -g_red)
    Adxi = (A @ dxi[:, None, :, None])[..., 0]               # (M, N, 2)
    df = -(g_f + wp[..., None] * Adxi) / h_ff[..., None]
    pred_flow = torch.where(valid[..., None], df * (lam[:, None, None] * df - g_f),
                            torch.zeros_like(df)).sum((-2, -1))
    pred = 0.5 * ((dxi * (lam[:, None] * dxi - g_red)).sum(-1) + pred_flow)
    return dxi, df, pred


def solve_flow_ba(
    T_init: torch.Tensor,       # (M, 4, 4)
    Twl: torch.Tensor,          # (M, 4, 4)
    obs: torch.Tensor,          # (M, N, 2)
    flow_meas: torch.Tensor,    # (M, N, 2)
    depth: torch.Tensor,        # (M, N)
    valid: torch.Tensor,        # (M, N) bool
    fx: float, fy: float, cx: float, cy: float,
    params: FlowBAParams = FlowBAParams(),
    point_weight: torch.Tensor = None,   # (M, N) or None
) -> FlowBAResult:
    """Plain batched torch LM solve of M flow-BA instances."""
    p = params
    w_pt = 1.0 if point_weight is None else point_weight
    Xw = world_points(Twl, obs, depth, fx, fy, cx, cy)
    valid = valid & (depth > 0)
    T, f = T_init, flow_meas
    F, _ = residual_chi2(T, f, Xw, obs, flow_meas, valid, p, fx, fy, cx, cy, w_pt=w_pt)

    seed = lambda_seed(T_init, Xw, valid, p, fx, fy, w_pt=w_pt)
    lam = p.tau * torch.clamp(seed.amax(-1), min=1.0)
    nu = torch.full_like(lam, 2.0)
    done = torch.zeros_like(valid[:, 0])

    for _ in range(p.iters):
        active = ~done
        if not bool(active.any()):
            break
        dxi, df, pred = _build_and_solve(T, f, Xw, obs, flow_meas, valid, lam, p,
                                         fx, fy, cx, cy, w_pt=w_pt)
        T_new = se3.exp_se3(dxi) @ T
        f_new = f + df
        F_new, _ = residual_chi2(T_new, f_new, Xw, obs, flow_meas, valid, p,
                                 fx, fy, cx, cy, w_pt=w_pt)
        accept, lam_n, nu_n = smallsolve.nielsen_step(F, F_new, pred, lam, nu)
        done_new = done | (accept & (F - F_new < p.rel_tol * F + 1e-10)) | (lam > 1e8)
        take = active & accept
        T = torch.where(take[:, None, None], T_new, T)
        f = torch.where(take[:, None, None], f_new, f)
        F = torch.where(take, F_new, F)
        lam = torch.where(active, lam_n, lam)
        nu = torch.where(active, nu_n, nu)
        done = torch.where(active, done_new, done)

    _, chi2 = residual_chi2(T, f, Xw, obs, flow_meas, valid, p, fx, fy, cx, cy)
    inliers = valid & (chi2 <= p.rp_thres)
    n_in = inliers.sum(-1)
    mean_reproj = (torch.where(inliers, torch.sqrt(chi2), torch.zeros_like(chi2)).sum(-1)
                   / torch.clamp(n_in, min=1))
    return FlowBAResult(T=T, flow=f, chi2=chi2, inliers=inliers, n_inliers=n_in,
                        mean_reproj=mean_reproj)


def flow_ba_route(name: str) -> str:
    """``solve_flow_ba_auto``'s ``backend`` for a ``SolverConfig.flow_ba_backend``,
    which keeps the JAX package's names: its ``"xla"`` is the plain version
    here, ``"pallas"`` the CUDA kernel; every other name passes as it is."""
    return {"xla": "torch", "pallas": "cuda"}.get(name, name)


def camera_params(sol) -> FlowBAParams:
    """The camera solve's parameters in a ``SolverConfig``."""
    return FlowBAParams(reproj_info=sol.reproj_info, prior_info=sol.cam_flow_prior_info,
                        rp_thres=sol.cam_rp_thres, iters=sol.cam_lm_iters, tau=sol.lm_tau)


def solve_flow_ba_auto(
    T_init, Twl, obs, flow_meas, depth, valid, fx, fy, cx, cy,
    params: FlowBAParams = FlowBAParams(), backend: str = "auto",
    point_weight=None,
) -> FlowBAResult:
    """Backend dispatch.  ``"auto"``: the CUDA kernel for CUDA tensors, the
    plain version for CPU tensors.  ``"cuda"`` on a CPU tensor raises;
    ``"torch"`` forces the plain version on any device.  A kernel that fails
    to build or launch raises: there is no fallback."""
    if backend not in ("auto", "cuda", "torch"):
        raise ValueError(f"unknown flow-BA backend {backend!r}")
    use_cuda = backend == "cuda" or (backend == "auto" and obs.is_cuda)
    if use_cuda:
        from multimot_track_tpu_torch.solvers.flow_ba_cuda import solve_flow_ba_cuda

        return solve_flow_ba_cuda(T_init, Twl, obs, flow_meas, depth, valid,
                                  fx, fy, cx, cy, params=params,
                                  point_weight=point_weight)
    return solve_flow_ba(T_init, Twl, obs, flow_meas, depth, valid, fx, fy, cx, cy,
                         params=params, point_weight=point_weight)


def solve_flow_ba_batched(T_init, Twl, obs, flow_meas, depth, valid, fx, fy, cx, cy,
                          params: FlowBAParams = FlowBAParams()) -> FlowBAResult:
    """K independent problems (objects) sharing one (4, 4) ``Twl``: the JAX
    package's ``vmap`` of ``solve_flow_ba`` (the plain version)."""
    Twl = Twl.expand(T_init.shape[0], 4, 4)
    return solve_flow_ba(T_init, Twl, obs, flow_meas, depth, valid, fx, fy, cx, cy,
                         params=params)


class FlowDepthBAParams(NamedTuple):
    reproj_info: float = 0.1
    flow_prior_info: float = 0.3
    depth_prior_info: float = 1.0   # EdgeDepthPrior information
    rp_thres: float = 0.04
    iters: int = 100
    tau: float = 1e-5
    rel_tol: float = 1e-6


def solve_flow_depth_ba(
    T_init: torch.Tensor,       # (4, 4)
    Twl: torch.Tensor,          # (4, 4)
    obs: torch.Tensor,          # (N, 2)
    flow_meas: torch.Tensor,    # (N, 2)
    depth_meas: torch.Tensor,   # (N,)
    valid: torch.Tensor,        # (N,) bool
    fx: float, fy: float, cx: float, cy: float,
    params: FlowDepthBAParams = FlowDepthBAParams(),
) -> FlowBAResult:
    """Flow-BA with per-point depth as a variable (3-DoF point vertices:
    flow u, v and depth, each with a Gaussian prior): the reference's
    experimental ``PoseOptimizationFlowDepth2`` (src/Optimizer.cc:1568).
    Port of the JAX package's ``solve_flow_depth_ba``: each point's 3x3
    Schur block is inverted in closed form (``smallsolve.inv_spd3``), and
    the LM loop stops as its ``while_loop`` does (a small relative gain or
    lambda > 1e8, at most ``iters`` steps), reading ``done`` on the host
    once per step.  One problem, on the device of its inputs."""
    p = params
    valid = valid & (depth_meas > 0)
    R_wl, t_wl = Twl[:3, :3], Twl[:3, 3]
    dirs = camera.backproject(obs, torch.ones_like(depth_meas), fx, fy, cx, cy)
    vmask = valid.to(obs.dtype)

    def point_world(d):
        return se3.transform(Twl, camera.backproject(obs, d, fx, fy, cx, cy))

    def residuals(T, f, d):
        y = se3.transform(T, point_world(d))
        r_p = (obs + f) - camera.project(y, fx, fy, cx, cy)
        return y, r_p, f - flow_meas, d - depth_meas

    def robust_objective(T, f, d):
        _, r_p, r_f, r_d = residuals(T, f, d)
        chi2_p = p.reproj_info * (r_p * r_p).sum(-1)
        d2 = p.rp_thres
        rho = torch.where(chi2_p <= d2, chi2_p,
                          2 * torch.sqrt(d2 * torch.clamp(chi2_p, min=1e-20)) - d2)
        F = rho + p.flow_prior_info * (r_f * r_f).sum(-1) + p.depth_prior_info * r_d * r_d
        return torch.where(valid, F, torch.zeros_like(F)).sum(), chi2_p

    def build(T, f, d, lam):
        y, r_p, r_f, r_d = residuals(T, f, d)
        chi2_p = p.reproj_info * (r_p * r_p).sum(-1)
        w_rob = torch.where(chi2_p <= p.rp_thres, torch.ones_like(chi2_p),
                            torch.sqrt(p.rp_thres / torch.clamp(chi2_p, min=1e-20)))
        wp = p.reproj_info * torch.where(valid, w_rob, torch.zeros_like(w_rob))
        wf = p.flow_prior_info * vmask
        wd = p.depth_prior_info * vmask

        dpi = camera.project_jacobian(y, fx, fy)            # (N, 2, 3)
        A = -(dpi @ se3.point_jacobian(y))                  # d r_p / d xi (N, 2, 6)
        # X = backproject(obs, d) is linear in d: dy/dd = R_total @ the ray
        dy_dd = dirs @ (T[:3, :3] @ R_wl).T
        J_d = -(dpi @ dy_dd[..., None])[..., 0]             # (N, 2)
        eye2 = torch.eye(2, dtype=y.dtype, device=y.device).expand(r_p.shape[:-1] + (2, 2))
        B = torch.cat([eye2, J_d[..., None]], -1)           # (N, 2, 3): [I2 | J_d]

        H_TT = torch.einsum("nia,nib,n->ab", A, A, wp)
        g_T = torch.einsum("nia,ni,n->a", A, r_p, wp)
        prior_diag = torch.stack([wf, wf, wd], -1)          # (N, 3)
        H_vv = (torch.einsum("nia,nib,n->nab", B, B, wp)
                + torch.diag_embed(prior_diag + lam))
        g_v = (torch.einsum("nia,ni,n->na", B, r_p, wp)
               + prior_diag * torch.stack([r_f[:, 0], r_f[:, 1], r_d], -1))
        H_Tv = torch.einsum("nia,nib,n->nab", A, B, wp)     # (N, 6, 3)

        H_vv_inv = smallsolve.inv_spd3(H_vv)
        eye6 = torch.eye(6, dtype=y.dtype, device=y.device)
        H_red = H_TT + lam * eye6 - torch.einsum("nab,nbc,ndc->ad", H_Tv, H_vv_inv, H_Tv)
        g_red = g_T - torch.einsum("nab,nbc,nc->a", H_Tv, H_vv_inv, g_v)
        dxi = smallsolve.solve_spd6(H_red, -g_red)
        dv = -torch.einsum("nab,nb->na", H_vv_inv,
                           g_v + torch.einsum("nba,b->na", H_Tv, dxi))
        pred = 0.5 * ((dxi * (lam * dxi - g_red)).sum() + torch.where(
            valid[:, None], dv * (lam * dv - g_v), torch.zeros_like(dv)).sum())
        return dxi, dv, pred

    T, f, d = T_init, flow_meas, depth_meas
    Fv, _ = robust_objective(T, f, d)
    z0 = torch.clamp(depth_meas, min=1e-3)
    seed = torch.where(valid, p.reproj_info * ((fx / z0) ** 2 + (fy / z0) ** 2),
                       torch.zeros_like(z0))
    lam = p.tau * torch.clamp(seed.max(), min=1.0)
    nu = torch.full_like(lam, 2.0)
    for _ in range(p.iters):
        dxi, dv, pred = build(T, f, d, lam)
        T_new = se3.exp_se3(dxi) @ T
        f_new = f + dv[:, :2]
        d_new = torch.clamp(d + dv[:, 2], min=1e-3)
        F_new, _ = robust_objective(T_new, f_new, d_new)
        accept, lam_n, nu = smallsolve.nielsen_step(Fv, F_new, pred, lam, nu)
        done = (accept & (Fv - F_new < p.rel_tol * Fv + 1e-10)) | (lam > 1e8)
        T = torch.where(accept, T_new, T)
        f = torch.where(accept, f_new, f)
        d = torch.where(accept, d_new, d)
        Fv, lam = torch.where(accept, F_new, Fv), lam_n
        if bool(done):
            break
    _, chi2 = robust_objective(T, f, d)
    inliers = valid & (chi2 <= p.rp_thres)
    n_in = inliers.sum()
    mean_reproj = (torch.where(inliers, torch.sqrt(chi2), torch.zeros_like(chi2)).sum()
                   / torch.clamp(n_in, min=1))
    return FlowBAResult(T=T, flow=f, chi2=chi2, inliers=inliers, n_inliers=n_in,
                        mean_reproj=mean_reproj)
