"""Distributed flow-BA: the point set sharded over the ranks, the reduced
6x6 system assembled with all-reduces.

Port of ``multimot_track_tpu.parallel.dist_ba``.  Per-point Hessian and
gradient blocks are computed on each rank's own points, the flow variables
are Schur-eliminated there (their blocks are per-point scalars, so the
elimination never crosses ranks), and only the 6x6 reduced system and a few
scalars cross: per LM iteration four all-reduces (SUM) of the trial
objective, H (6x6), g (6) and the flow part of the predicted gain; per
solve two more, the initial objective (SUM) and the lambda seed (MAX).
That is 4 * iters + 2 all-reduces a solve.

It mirrors the JAX distributed solver, not the single-card one: exactly
``params.iters`` iterations (no relative-decrease stop), lambda * I added
after the reduction, the 6x6 solved by LU, no point weights.  Nothing in
the loop reads a value back to the host, so on NCCL every collective is
queued on the stream behind the arithmetic.  The arithmetic is plain torch
on the rank's device: the 6x6 sums are tiny, and kernel K1's one-launch LM
has no point at which to stop for a collective.
"""

from __future__ import annotations

import torch

from multimot_track_tpu_torch.geometry import camera, se3
from multimot_track_tpu_torch.parallel.mesh import Mesh
from multimot_track_tpu_torch.solvers.flow_ba import FlowBAParams, _residual_chi2


def _local_blocks(T, f, Xw, obs, flow_meas, valid, lam, p: FlowBAParams, fx, fy, cx, cy):
    """A rank's Schur-reduced system pieces over its N points (the algebra
    of solvers/flow_ba._build_and_solve, factored for the reduction)."""
    y = se3.transform(T, Xw)
    r_p = (obs + f) - camera.project(y, fx, fy, cx, cy)
    r_f = f - flow_meas
    chi2_p = p.reproj_info * (r_p * r_p).sum(-1)
    w_rob = torch.where(chi2_p <= p.rp_thres, torch.ones_like(chi2_p),
                        torch.sqrt(p.rp_thres / torch.clamp(chi2_p, min=1e-20)))
    vw = torch.where(valid, w_rob, torch.zeros_like(w_rob))
    wp = p.reproj_info * vw
    wf = p.prior_info * valid.to(wp.dtype)
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
    A = -(dpi @ torch.cat([-se3.hat(y), eye], -1))          # (N, 2, 6)
    h_ff = wp + wf + lam
    g_f = wp[:, None] * r_p + wf[:, None] * r_f
    AtW = A * wp[:, None, None]
    H_loc = (torch.einsum("nia,nib,n->ab", A, A, wp)
             - torch.einsum("nia,nib,n->ab", AtW, AtW, 1.0 / h_ff))
    g_loc = (torch.einsum("nia,ni,n->a", A, r_p, wp)
             - torch.einsum("nia,ni,n->a", AtW, g_f, 1.0 / h_ff))
    return A, wp, h_ff, g_f, H_loc, g_loc


def make_distributed_flow_ba(mesh: Mesh, params: FlowBAParams, fx, fy, cx, cy):
    """Build a distributed solver over ``mesh``'s ranks.  Returns
    ``solve(T_init, Twl, obs, flow_meas, depth, valid) -> T (4, 4)``:
    ``T_init`` and ``Twl`` (4, 4) the same on every rank, the rest this
    rank's own points ((N_r, 2), (N_r, 2), (N_r,), (N_r,) bool)."""
    p = params

    def solve(T_init, Twl, obs, flow_meas, depth, valid):
        Xw = se3.transform(Twl, camera.backproject(obs, depth, fx, fy, cx, cy))
        valid_ = valid & (depth > 0)
        f0 = flow_meas
        eye6 = torch.eye(6, dtype=T_init.dtype, device=T_init.device)

        def objective(T, f):
            F_loc, _ = _residual_chi2(T, f, Xw, obs, flow_meas, valid_, p, fx, fy, cx, cy)
            return mesh.all_reduce(F_loc)

        F = objective(T_init, f0)
        z0 = torch.clamp(se3.transform(T_init, Xw)[..., 2], min=1e-6)
        seed = torch.where(valid_, p.reproj_info * ((fx / z0) ** 2 + (fy / z0) ** 2),
                           torch.zeros_like(z0))
        diag_loc = seed.amax() if seed.numel() else torch.zeros((), device=seed.device)
        lam = p.tau * torch.clamp(mesh.all_reduce(diag_loc, "max"), min=1.0)
        nu = torch.full_like(lam, 2.0)
        T, f = T_init, f0
        for _ in range(p.iters):
            A, wp, h_ff, g_f, H_loc, g_loc = _local_blocks(
                T, f, Xw, obs, flow_meas, valid_, lam, p, fx, fy, cx, cy)
            H_red = mesh.all_reduce(H_loc) + lam * eye6
            g_red = mesh.all_reduce(g_loc)
            # LU as jnp.linalg.solve; solve_ex keeps the host out of the
            # loop (a singular system gives a non-finite step, rejected)
            dxi = torch.linalg.solve_ex(H_red, -g_red)[0]
            Adxi = A @ dxi
            df = -(g_f + wp[:, None] * Adxi) / h_ff[:, None]
            T_new = se3.exp_se3(dxi) @ T
            f_new = f + df
            F_new = objective(T_new, f_new)
            pred_loc = 0.5 * torch.where(valid_[:, None], df * (lam * df - g_f),
                                         torch.zeros_like(df)).sum()
            pred = 0.5 * torch.dot(dxi, lam * dxi - g_red) + mesh.all_reduce(pred_loc)
            gain = (F - F_new) / torch.clamp(pred, min=1e-20)
            accept = (F_new < F) & torch.isfinite(F_new)
            lam_acc = lam * torch.clamp(1.0 - (2.0 * gain - 1.0) ** 3, min=1.0 / 3.0)
            T = torch.where(accept, T_new, T)
            f = torch.where(accept, f_new, f)
            F = torch.where(accept, F_new, F)
            lam = torch.where(accept, lam_acc, lam * nu)
            nu = torch.where(accept, torch.full_like(nu, 2.0), nu * 2.0)
        return T

    return solve
