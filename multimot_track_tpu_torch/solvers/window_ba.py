"""Sliding-window bundle adjustment with inverse-depth Schur elimination.

Port of ``multimot_track_tpu.solvers.window_ba``.  Every track starts in
window frame 0 (the gauge); each point carries one inverse-depth variable
with a Gaussian prior from the depth map, so eliminating the points is a
per-track scalar division and the reduced system over the F-1 free poses
is a dense 6(F-1) square solved on the device.  Optional odometry-prior
edges hold each consecutive relative pose near the one in ``poses_init``.

Residual per (frame f >= 1, track i):
  r_{f,i} = obs_{f,i} - pi(Tcw_f @ pi^-1(obs_{0,i}, 1/rho_i)).

The Levenberg-Marquardt loop runs exactly ``iters`` steps (the JAX
``while_loop`` has no early exit) with the Nielsen lambda schedule, and
stays on the device: no step reads a value back to the host.  It computes
in the inputs' floating type (float32 on the live path; float64 gives the
tests a reference for the float32 solvers).

The per-track algebra (``WindowProblem``) is shared with the track-sharded
solver ``parallel/dist_window_ba``, which assembles its blocks across ranks.

``solve_window_ba_auto`` dispatches: the CUDA kernel K3
(solvers/window_ba_cuda.py, one launch a window) for CUDA tensors, this
plain version for CPU tensors.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from multimot_track_tpu_torch.geometry import camera, se3, smallsolve


class WindowBAParams(NamedTuple):
    iters: int = 30
    huber_px: float = 2.0          # Huber delta on the pixel residual norm
    depth_prior_sigma: float = 2e-2   # sigma on rho (1/m)
    tau: float = 1e-4
    # information (1/sigma^2 on the mixed (rad, m) tangent) of the odometry
    # prior on each consecutive relative pose of ``poses_init``; 0 = off
    odo_prior_weight: float = 0.0


class WindowBAResult(NamedTuple):
    poses: torch.Tensor      # (F, 4, 4) optimized Tcw (frame 0 = identity gauge)
    inv_depth: torch.Tensor  # (N,) optimized inverse depths
    chi2: torch.Tensor       # () final robust objective


class WindowProblem:
    """A window's data as its solvers read it (from frame 0's tracks), and
    the per-track algebra of the objective and the normal equations."""

    def __init__(self, uv, alive, depth0, fx, fy, cx, cy, params: WindowBAParams):
        self.p, self.cam, self.depth0 = params, (fx, fy, cx, cy), depth0
        self.valid0 = alive[0] & (depth0 > 0)                # (N,) alive with a depth
        self.rho0 = torch.where(self.valid0, 1.0 / torch.clamp(depth0, min=1e-3),
                                torch.ones_like(depth0))     # (N,) prior inverse depth
        self.w_prior = 1.0 / (params.depth_prior_sigma ** 2)
        self.obs = uv[1:]                                    # (F-1, N, 2)
        self.vis = alive[1:] & self.valid0[None, :]          # (F-1, N)
        self.dirs = camera.backproject(uv[0], torch.ones_like(depth0), fx, fy, cx, cy)

    def lambda_scale(self):
        """(fx / nearest valid depth)^2: lambda_0 is tau times it, at least tau."""
        near = torch.where(self.valid0, self.depth0, torch.full_like(self.depth0, 1e9)).min()
        return (self.cam[0] / torch.clamp(near, min=1.0)) ** 2

    def _residuals(self, T_stack, rho):
        X = self.dirs / rho[:, None]                         # (N, 3) frame-0 camera coords
        y = torch.einsum("fij,nj->fni", T_stack[:, :3, :3], X) + T_stack[:, None, :3, 3]
        r = self.obs - camera.project(y, *self.cam)
        return X, y, r, (r * r).sum(-1)

    def residual_blocks(self, T_stack, rho, lam):
        """The normal equations' blocks at (T_stack, rho): the poses' H_ff
        (F-1, 6, 6) and g_f, the inverse depths' damped scalar blocks h_r
        and g_r (N,), and their couplings B (N, F-1, 6)."""
        p, w_prior = self.p, self.w_prior
        X, y, r, rn2 = self._residuals(T_stack, rho)
        w_rob = torch.where(rn2 <= p.huber_px ** 2, torch.ones_like(rn2),
                            p.huber_px / torch.sqrt(torch.clamp(rn2, min=1e-20)))
        w = torch.where(self.vis, w_rob, torch.zeros_like(w_rob))      # (F-1, N)
        dpi = camera.project_jacobian(y, self.cam[0], self.cam[1])     # (F-1, N, 2, 3)
        Jp = -(dpi @ se3.point_jacobian(y))                            # (F-1, N, 2, 6)
        dy_drho = -torch.einsum("fij,nj->fni", T_stack[:, :3, :3], X) / rho[None, :, None]
        Jr = -(dpi @ dy_drho[..., None])[..., 0]                       # (F-1, N, 2)
        H_ff = torch.einsum("fnia,fnib,fn->fab", Jp, Jp, w)
        g_f = torch.einsum("fnia,fni,fn->fa", Jp, r, w)
        h_r = torch.einsum("fni,fni,fn->n", Jr, Jr, w) + w_prior + lam
        g_r = torch.einsum("fni,fni,fn->n", Jr, r, w) + w_prior * (rho - self.rho0)
        B = torch.einsum("fnia,fni,fn->nfa", Jp, Jr, w)                # (N, F-1, 6)
        return H_ff, g_f, h_r, g_r, B

    def objective(self, T_stack, rho):
        """The robust reprojection cost plus the depth prior (no odometry
        prior)."""
        p = self.p
        rn2 = self._residuals(T_stack, rho)[3]
        d2 = p.huber_px ** 2
        rob = torch.where(rn2 <= d2, rn2,
                          2.0 * p.huber_px * torch.sqrt(torch.clamp(rn2, min=1e-20)) - d2)
        prior = self.w_prior * (rho - self.rho0) ** 2
        return (torch.where(self.vis, rob, torch.zeros_like(rob)).sum()
                + torch.where(self.valid0, prior, torch.zeros_like(prior)).sum())

    def back_substitute(self, T_stack, rho, dxi, h_r, g_r, B):
        """A pose step's inverse-depth step and trial state: (drho, T_new,
        rho_new)."""
        drho = -(g_r + torch.einsum("nfa,fa->n", B, dxi)) / h_r
        rho_new = torch.where(self.valid0, torch.clamp(rho + drho, min=1e-4), rho)
        return drho, se3.exp_se3(dxi) @ T_stack, rho_new


def solve_window_ba(
    poses_init: torch.Tensor,   # (F, 4, 4) initial Tcw (pose[0] must be I)
    uv: torch.Tensor,           # (F, N, 2) track observations
    alive: torch.Tensor,        # (F, N) bool
    depth0: torch.Tensor,       # (N,) metric depth at the frame-0 observation
    fx: float, fy: float, cx: float, cy: float,
    params: WindowBAParams = WindowBAParams(),
) -> WindowBAResult:
    p = params
    F = uv.shape[0]
    dev, dt = uv.device, uv.dtype             # float32 on the live path
    prob = WindowProblem(uv, alive, depth0, fx, fy, cx, cy, p)
    eye6 = torch.eye(6, dtype=dt, device=dev)

    w_odo = p.odo_prior_weight
    Z_odo = poses_init[1:] @ se3.inverse(poses_init[:-1])     # (F-1, 4, 4)
    Ad_Z = se3.adjoint(Z_odo)                                 # (F-1, 6, 6)

    def odo_residuals(T_stack):
        T_prev = torch.cat([torch.eye(4, dtype=dt, device=dev)[None], T_stack[:-1]], 0)
        return se3.log_se3(T_stack @ se3.inverse(T_prev) @ se3.inverse(Z_odo))   # (F-1, 6)

    def full_objective(T_stack, rho):
        Fv = prob.objective(T_stack, rho)
        if w_odo > 0.0:
            r_o = odo_residuals(T_stack)
            Fv = Fv + w_odo * (r_o * r_o).sum()
        return Fv

    T_stack, rho = poses_init[1:], prob.rho0
    Fv = full_objective(T_stack, rho)
    lam = p.tau * torch.clamp(prob.lambda_scale(), min=1.0)
    nu = torch.full((), 2.0, dtype=dt, device=dev)
    D = 6 * (F - 1)
    idx = torch.arange(F - 1, device=dev)
    for _ in range(p.iters):
        H_ff, g_f, h_r, g_r, B = prob.residual_blocks(T_stack, rho, lam)
        # the reduced dense system over the F-1 poses
        H = torch.zeros((F - 1, F - 1, 6, 6), dtype=dt, device=dev)
        H[idx, idx] = H_ff + lam * eye6
        Bh = B / h_r[:, None, None]
        H = H - torch.einsum("nfa,ngb->fgab", Bh, B)
        g = g_f - torch.einsum("nfa,n->fa", Bh, g_r)
        if w_odo > 0.0:
            # edge e couples poses (e-1, e): Jacobian ~ I on the current
            # side, ~ -Ad(Z_e) on the previous one
            r_o = odo_residuals(T_stack)
            H[idx, idx] += w_odo * eye6
            g = g + w_odo * r_o
            if F > 2:
                A2 = Ad_Z[1:]                                          # (F-2, 6, 6)
                H[idx[:-1], idx[:-1]] += w_odo * (A2.transpose(-1, -2) @ A2)
                H[idx[1:], idx[:-1]] += -w_odo * A2
                H[idx[:-1], idx[1:]] += -w_odo * A2.transpose(-1, -2)
                g = torch.cat([g[:-1] - w_odo * (A2.transpose(-1, -2) @ r_o[1:, :, None])[..., 0],
                               g[-1:]], 0)
        Hd = H.permute(0, 2, 1, 3).reshape(D, D)
        # solve_ex: no host sync on the info flag; a singular system gives
        # a non-finite step, which the acceptance test rejects
        dxi = torch.linalg.solve_ex(Hd, -g.reshape(D, 1))[0].reshape(F - 1, 6)
        drho, T_new, rho_new = prob.back_substitute(T_stack, rho, dxi, h_r, g_r, B)
        F_new = full_objective(T_new, rho_new)
        pred = 0.5 * ((dxi * (lam * dxi - g)).sum()
                      + torch.where(prob.valid0, drho * (lam * drho - g_r),
                                    torch.zeros_like(drho)).sum())
        accept, lam, nu = smallsolve.nielsen_step(Fv, F_new, pred, lam, nu)
        T_stack = torch.where(accept, T_new, T_stack)
        rho = torch.where(accept, rho_new, rho)
        Fv = torch.where(accept, F_new, Fv)
    return WindowBAResult(poses=torch.cat([poses_init[:1], T_stack], 0), inv_depth=rho,
                          chi2=Fv)


def solve_window_ba_auto(
    poses_init, uv, alive, depth0, fx, fy, cx, cy, params: WindowBAParams = WindowBAParams(),
) -> WindowBAResult:
    """The CUDA kernel for CUDA tensors, the plain version for CPU tensors.
    A kernel that fails to build or launch raises: there is no fallback."""
    if uv.is_cuda:
        from multimot_track_tpu_torch.solvers.window_ba_cuda import solve_window_ba_cuda

        return solve_window_ba_cuda(poses_init, uv, alive, depth0, fx, fy, cx, cy, params=params)
    return solve_window_ba(poses_init, uv, alive, depth0, fx, fy, cx, cy, params=params)
