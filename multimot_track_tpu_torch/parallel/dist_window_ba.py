"""Distributed sliding-window BA: the tracks sharded over the ranks.

Port of ``multimot_track_tpu.parallel.dist_window_ba``.  Each rank holds
its own tracks and computes their pose-block and Schur contributions with
the single-card solver's algebra (``solvers/window_ba.WindowProblem``),
and only the reduced 6(F-1)-dim system and a few scalars cross the ranks
per LM iteration, as all-reduces: a few KB whatever the number of tracks.
Inverse depths stay on their rank (their Schur blocks are scalars);
back-substitution never communicates.

It mirrors the JAX distributed solver: exactly ``params.iters``
iterations, lambda * I added after the reduction, LU for the dense solve,
and no odometry prior (``WindowBAParams.odo_prior_weight`` is ignored, as
there).  Like ``shard_map``, it refuses tracks that do not split evenly
over the ranks.  Nothing in the loop reads a value back to the host.
"""

from __future__ import annotations

import torch

from multimot_track_tpu_torch.geometry import smallsolve
from multimot_track_tpu_torch.parallel.mesh import Mesh
from multimot_track_tpu_torch.solvers import window_ba as wba


def make_distributed_window_ba(mesh: Mesh, params: wba.WindowBAParams, fx, fy, cx, cy):
    """Returns ``solve(poses_init, uv, alive, depth0) -> (poses, inv_depth)``:
    ``poses_init`` (F, 4, 4) the same on every rank; ``uv`` (F, N_r, 2),
    ``alive`` (F, N_r) and ``depth0`` (N_r,) this rank's tracks, N_r the
    same on every rank; ``inv_depth`` (N_r,) this rank's."""
    p = params

    def solve(poses_init, uv, alive, depth0):
        F = uv.shape[0]
        dev, dt = uv.device, uv.dtype
        n = torch.tensor([uv.shape[1], -uv.shape[1]], device=dev)
        n_max, n_neg_min = mesh.all_reduce(n, "max").tolist()
        if n_max != -n_neg_min:
            raise ValueError(f"tracks split unevenly over the ranks: {-n_neg_min} to {n_max} "
                             "a rank")
        prob = wba.WindowProblem(uv, alive, depth0, fx, fy, cx, cy, p)
        eye6 = torch.eye(6, dtype=dt, device=dev)
        idx = torch.arange(F - 1, device=dev)

        def objective(T_stack, rho):
            return mesh.all_reduce(prob.objective(T_stack, rho))

        T_stack, rho = poses_init[1:], prob.rho0
        Fv = objective(T_stack, rho)
        lam = p.tau * torch.clamp(mesh.all_reduce(prob.lambda_scale(), "max"), min=1.0)
        nu = torch.full_like(lam, 2.0)
        D = 6 * (F - 1)
        for _ in range(p.iters):
            H_ff, g_f, h_r, g_r, B = prob.residual_blocks(T_stack, rho, lam)
            # this rank's Schur-reduced pose system, summed over the ranks
            Bh = B / h_r[:, None, None]
            H_loc = -torch.einsum("nfa,ngb->fgab", Bh, B)
            H_loc[idx, idx] += H_ff
            H = mesh.all_reduce(H_loc)
            g = mesh.all_reduce(g_f - torch.einsum("nfa,n->fa", Bh, g_r))
            H[idx, idx] += lam * eye6
            Hd = H.permute(0, 2, 1, 3).reshape(D, D)
            # LU as jnp.linalg.solve, without the host sync of its check
            dxi = torch.linalg.solve_ex(Hd, -g.reshape(D, 1))[0].reshape(F - 1, 6)
            drho, T_new, rho_new = prob.back_substitute(T_stack, rho, dxi, h_r, g_r, B)
            F_new = objective(T_new, rho_new)
            pred_loc = 0.5 * torch.where(prob.valid0, drho * (lam * drho - g_r),
                                         torch.zeros_like(drho)).sum()
            pred = 0.5 * (dxi * (lam * dxi - g)).sum() + mesh.all_reduce(pred_loc)
            accept, lam, nu = smallsolve.nielsen_step(Fv, F_new, pred, lam, nu)
            T_stack = torch.where(accept, T_new, T_stack)
            rho = torch.where(accept, rho_new, rho)
            Fv = torch.where(accept, F_new, Fv)
        return torch.cat([poses_init[:1], T_stack], 0), rho

    return solve
