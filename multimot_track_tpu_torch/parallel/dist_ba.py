"""Distributed flow-BA: the point set sharded over the ranks, the reduced
6x6 system assembled with all-reduces.

Port of ``multimot_track_tpu.parallel.dist_ba``.  Each rank linearises its
own points with the single-card solver's algebra (``flow_ba.linearise``),
which Schur-eliminates the flow variables there (their blocks are per-point
scalars, so the elimination never crosses ranks), and only the 6x6 reduced
system and a few scalars cross: per LM iteration four all-reduces (SUM) of
the trial objective, H (6x6), g (6) and the flow part of the predicted
gain; per solve two more, the initial objective (SUM) and the lambda seed
(MAX).  That is 4 * iters + 2 all-reduces a solve.

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

from multimot_track_tpu_torch.geometry import se3, smallsolve
from multimot_track_tpu_torch.parallel.mesh import Mesh
from multimot_track_tpu_torch.solvers.flow_ba import (
    FlowBAParams, lambda_seed, linearise, residual_chi2, world_points)


def make_distributed_flow_ba(mesh: Mesh, params: FlowBAParams, fx, fy, cx, cy):
    """Build a distributed solver over ``mesh``'s ranks.  Returns
    ``solve(T_init, Twl, obs, flow_meas, depth, valid) -> T (4, 4)``:
    ``T_init`` and ``Twl`` (4, 4) the same on every rank, the rest this
    rank's own points ((N_r, 2), (N_r, 2), (N_r,), (N_r,) bool)."""
    p = params

    def solve(T_init, Twl, obs, flow_meas, depth, valid):
        Xw = world_points(Twl, obs, depth, fx, fy, cx, cy)
        valid_ = valid & (depth > 0)
        eye6 = torch.eye(6, dtype=T_init.dtype, device=T_init.device)

        def objective(T, f):
            F_loc, _ = residual_chi2(T, f, Xw, obs, flow_meas, valid_, p, fx, fy, cx, cy)
            return mesh.all_reduce(F_loc)

        F = objective(T_init, flow_meas)
        seed = lambda_seed(T_init, Xw, valid_, p, fx, fy)
        diag_loc = seed.amax() if seed.numel() else torch.zeros((), device=seed.device)
        lam = p.tau * torch.clamp(mesh.all_reduce(diag_loc, "max"), min=1.0)
        nu = torch.full_like(lam, 2.0)
        T, f = T_init, flow_meas
        for _ in range(p.iters):
            A, wp, g_f, h_ff, H_TT, g_T, S_H, S_g = linearise(
                T, f, Xw, obs, flow_meas, valid_, lam, p, fx, fy, cx, cy)
            H_red = mesh.all_reduce(H_TT - S_H) + lam * eye6
            g_red = mesh.all_reduce(g_T - S_g)
            # LU as jnp.linalg.solve; solve_ex keeps the host out of the
            # loop (a singular system gives a non-finite step, rejected)
            dxi = torch.linalg.solve_ex(H_red, -g_red)[0]
            df = -(g_f + wp[:, None] * (A @ dxi)) / h_ff[:, None]
            T_new = se3.exp_se3(dxi) @ T
            f_new = f + df
            F_new = objective(T_new, f_new)
            pred_loc = 0.5 * torch.where(valid_[:, None], df * (lam * df - g_f),
                                         torch.zeros_like(df)).sum()
            pred = 0.5 * torch.dot(dxi, lam * dxi - g_red) + mesh.all_reduce(pred_loc)
            accept, lam, nu = smallsolve.nielsen_step(F, F_new, pred, lam, nu)
            T = torch.where(accept, T_new, T)
            f = torch.where(accept, f_new, f)
            F = torch.where(accept, F_new, F)
        return T

    return solve
