"""Distributed sliding-window BA: the tracks sharded over the ranks.

Port of ``multimot_track_tpu.parallel.dist_window_ba``.  Each rank holds
its own tracks, computes their pose-block and Schur contributions (the
algebra of solvers/window_ba.solve_window_ba), and only the reduced
6(F-1)-dim system and a few scalars cross the ranks per LM iteration, as
all-reduces: a few KB whatever the number of tracks.  Inverse depths stay
on their rank (their Schur blocks are scalars); back-substitution never
communicates.

It mirrors the JAX distributed solver: exactly ``params.iters``
iterations, lambda * I added after the reduction, LU for the dense solve,
and no odometry prior (``WindowBAParams.odo_prior_weight`` is ignored, as
there).  Like ``shard_map``, it refuses tracks that do not split evenly
over the ranks.  Nothing in the loop reads a value back to the host.
"""

from __future__ import annotations

import torch

from multimot_track_tpu_torch.geometry import camera, se3
from multimot_track_tpu_torch.parallel.mesh import Mesh
from multimot_track_tpu_torch.solvers.window_ba import WindowBAParams


def make_distributed_window_ba(mesh: Mesh, params: WindowBAParams, fx, fy, cx, cy):
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
        uv0 = uv[0]
        valid0 = alive[0] & (depth0 > 0)
        rho0 = torch.where(valid0, 1.0 / torch.clamp(depth0, min=1e-3),
                           torch.ones_like(depth0))
        w_prior = 1.0 / (p.depth_prior_sigma ** 2)
        obs = uv[1:]
        vis = alive[1:] & valid0[None, :]
        dirs = camera.backproject(uv0, torch.ones_like(depth0), fx, fy, cx, cy)
        eye6 = torch.eye(6, dtype=dt, device=dev)
        idx = torch.arange(F - 1, device=dev)

        def points(T_stack, rho):
            X = dirs / rho[:, None]
            y = torch.einsum("fij,nj->fni", T_stack[:, :3, :3], X) + T_stack[:, None, :3, 3]
            return X, y

        def objective(T_stack, rho):
            _, y = points(T_stack, rho)
            r = obs - camera.project(y, fx, fy, cx, cy)
            rn2 = (r * r).sum(-1)
            d2 = p.huber_px ** 2
            rob = torch.where(rn2 <= d2, rn2,
                              2.0 * p.huber_px * torch.sqrt(torch.clamp(rn2, min=1e-20)) - d2)
            prior = w_prior * (rho - rho0) ** 2
            loc = (torch.where(vis, rob, torch.zeros_like(rob)).sum()
                   + torch.where(valid0, prior, torch.zeros_like(prior)).sum())
            return mesh.all_reduce(loc)

        def blocks(T_stack, rho, lam):
            X, y = points(T_stack, rho)
            r = obs - camera.project(y, fx, fy, cx, cy)
            rn2 = (r * r).sum(-1)
            w_rob = torch.where(rn2 <= p.huber_px ** 2, torch.ones_like(rn2),
                                p.huber_px / torch.sqrt(torch.clamp(rn2, min=1e-20)))
            w = torch.where(vis, w_rob, torch.zeros_like(w_rob))
            z = torch.clamp(y[..., 2], min=1e-6)
            inv_z = 1.0 / z
            zero = torch.zeros_like(z)
            dpi = torch.stack([
                torch.stack([fx * inv_z, zero, -fx * y[..., 0] * inv_z * inv_z], -1),
                torch.stack([zero, fy * inv_z, -fy * y[..., 1] * inv_z * inv_z], -1),
            ], -2)
            eye3 = torch.eye(3, dtype=dt, device=dev).expand(y.shape[:-1] + (3, 3))
            Jp = -(dpi @ torch.cat([-se3.hat(y), eye3], -1))              # (F-1, N, 2, 6)
            dy_drho = -torch.einsum("fij,nj->fni", T_stack[:, :3, :3], X) / rho[None, :, None]
            Jr = -(dpi @ dy_drho[..., None])[..., 0]                       # (F-1, N, 2)
            H_ff = torch.einsum("fnia,fnib,fn->fab", Jp, Jp, w)
            g_f = torch.einsum("fnia,fni,fn->fa", Jp, r, w)
            h_r = torch.einsum("fni,fni,fn->n", Jr, Jr, w) + w_prior + lam
            g_r = torch.einsum("fni,fni,fn->n", Jr, r, w) + w_prior * (rho - rho0)
            B = torch.einsum("fnia,fni,fn->nfa", Jp, Jr, w)                # (N, F-1, 6)
            Bh = B / h_r[:, None, None]
            H_loc = -torch.einsum("nfa,ngb->fgab", Bh, B)
            H_loc[idx, idx] += H_ff
            g_loc = g_f - torch.einsum("nfa,n->fa", Bh, g_r)
            return h_r, g_r, B, H_loc, g_loc

        T_stack, rho = poses_init[1:], rho0
        Fv = objective(T_stack, rho)
        near = torch.where(valid0, depth0, torch.full_like(depth0, 1e9)).min()
        lam = p.tau * torch.clamp(
            mesh.all_reduce((fx / torch.clamp(near, min=1.0)) ** 2, "max"), min=1.0)
        nu = torch.full_like(lam, 2.0)
        D = 6 * (F - 1)
        for _ in range(p.iters):
            h_r, g_r, B, H_loc, g_loc = blocks(T_stack, rho, lam)
            H = mesh.all_reduce(H_loc)
            g = mesh.all_reduce(g_loc)
            H[idx, idx] += lam * eye6
            Hd = H.permute(0, 2, 1, 3).reshape(D, D)
            # LU as jnp.linalg.solve, without the host sync of its check
            dxi = torch.linalg.solve_ex(Hd, -g.reshape(D, 1))[0].reshape(F - 1, 6)
            drho = -(g_r + torch.einsum("nfa,fa->n", B, dxi)) / h_r
            T_new = se3.exp_se3(dxi) @ T_stack
            rho_new = torch.where(valid0, torch.clamp(rho + drho, min=1e-4), rho)
            F_new = objective(T_new, rho_new)
            pred_loc = 0.5 * torch.where(valid0, drho * (lam * drho - g_r),
                                         torch.zeros_like(drho)).sum()
            pred = 0.5 * (dxi * (lam * dxi - g)).sum() + mesh.all_reduce(pred_loc)
            accept = (F_new < Fv) & torch.isfinite(F_new)
            gain = (Fv - F_new) / torch.clamp(pred, min=1e-20)
            lam_acc = lam * torch.clamp(1.0 - (2.0 * gain - 1.0) ** 3, min=1.0 / 3.0)
            T_stack = torch.where(accept, T_new, T_stack)
            rho = torch.where(accept, rho_new, rho)
            Fv = torch.where(accept, F_new, Fv)
            lam = torch.where(accept, lam_acc, lam * nu)
            nu = torch.where(accept, torch.full_like(nu, 2.0), nu * 2.0)
        return torch.cat([poses_init[:1], T_stack], 0), rho

    return solve
