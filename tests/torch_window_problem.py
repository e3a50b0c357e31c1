"""Seeded trailing-window BA problems at the KITTI camera, for kernel K3
(csrc/window_ba_lm.cu) and its plain version ``solvers/window_ba``.

``tests/test_torch_window_kernel.py`` and ``chip_smoke.py --k3-only`` draw
their windows here; ``objective`` is the solvers' objective in float64,
which holds a solution to the float64 solve where float32 cannot resolve
the poses.  Imports no jax.
"""

from __future__ import annotations

import numpy as np
import torch

from multimot_track_tpu_torch.config import CameraConfig
from multimot_track_tpu_torch.geometry import camera, se3

CAM = CameraConfig()


def cams():
    return CAM.fx, CAM.fy, CAM.cx, CAM.cy


def make_window(F=5, N=512, seed=0, outlier_frac=0.0, dead_frac=0.1):
    """A seeded window at the KITTI camera: points at 5-35 m, forward
    motion of 1.2 m a frame (a car at ~40 km/h and 10 Hz; at most 4.8 m over
    the window, so that long windows keep their points in front of the
    camera) with a small rotation, 0.1 px noise,
    ``outlier_frac`` observations off by ~20 px, perturbed initial poses,
    5 % depth noise; ``dead_frac`` of the tracks lose their depth or die
    part-way, and a track stays dead once lost, as chained tracks do.  A
    track without a finite depth is dead from frame 0, as the live path's
    frame-0 gate (depth under 40 m) makes it.  Returns (poses_init, uv,
    alive, depth0) on the CPU."""
    rng = np.random.default_rng(seed)
    t = lambda a: torch.from_numpy(np.ascontiguousarray(a, np.float32))
    uv0 = rng.uniform([80, 40], [CAM.width - 80, CAM.height - 40], (N, 2))
    z = rng.uniform(5.0, 35.0, N)
    X = camera.backproject(t(uv0), t(z), CAM.fx, CAM.fy, CAM.cx, CAM.cy)
    step = min(1.2, 4.8 / (F - 1))
    poses, init = [np.eye(4, dtype=np.float32)], [np.eye(4, dtype=np.float32)]
    uv, alive = [uv0], [np.ones(N, bool)]
    for f in range(1, F):
        xi = np.concatenate([rng.normal(scale=0.003, size=3),
                             [0.01 * f, 0.005 * f, step * f + rng.normal(scale=0.01)]])
        T = se3.exp_se3(t(xi))
        y = se3.transform(T, X)
        u = camera.project(y, CAM.fx, CAM.fy, CAM.cx, CAM.cy).numpy()
        u = u + rng.normal(scale=0.1, size=u.shape)
        bad = rng.uniform(size=N) < outlier_frac
        u[bad] += rng.normal(scale=20.0, size=(int(bad.sum()), 2))
        ok = (u[:, 0] > 5) & (u[:, 0] < CAM.width - 5) & (u[:, 1] > 5) & (u[:, 1] < CAM.height - 5)
        ok &= (y[:, 2].numpy() > 1.0) & (rng.uniform(size=N) >= dead_frac / (F - 1))
        uv.append(u)
        alive.append(alive[-1] & ok)
        d = np.concatenate([rng.normal(scale=0.002, size=3), rng.normal(scale=0.02, size=3)])
        poses.append(T.numpy())
        init.append((se3.exp_se3(t(d)) @ T).numpy())
    z_meas = z * (1 + rng.normal(scale=0.05, size=N))
    z_meas[rng.uniform(size=N) < dead_frac / 2] = 0.0                  # no depth
    z_meas[rng.uniform(size=N) < dead_frac / 4] = np.inf               # zero disparity
    alive = np.stack(alive)
    alive[:, ~np.isfinite(z_meas)] = False
    return t(np.stack(init)), t(np.stack(uv)), torch.from_numpy(alive), t(z_meas)


def objective(args, result, params) -> float:
    """The window BA's objective at ``result`` (poses, inverse depths), in
    float64 on the CPU: Huber reprojection over the visible observations,
    the inverse-depth prior and the odometry prior, as
    ``solvers/window_ba.solve_window_ba`` sums it."""
    d = lambda x: x.detach().cpu().double() if x.is_floating_point() else x.detach().cpu()
    init, uv, alive, depth0 = (d(x) for x in args)
    P, rho = d(result.poses), d(result.inv_depth)
    fx, fy, cx, cy = cams()
    valid0 = alive[0] & (depth0 > 0)
    rho0 = torch.where(valid0, 1.0 / torch.clamp(depth0, min=1e-3), torch.ones_like(depth0))
    X = camera.backproject(uv[0], torch.ones_like(depth0), fx, fy, cx, cy) / rho[:, None]
    y = torch.einsum("fij,nj->fni", P[1:, :3, :3], X) + P[1:, None, :3, 3]
    r = uv[1:] - camera.project(y, fx, fy, cx, cy)
    rn2, h = (r * r).sum(-1), params.huber_px
    rob = torch.where(rn2 <= h * h, rn2, 2 * h * torch.sqrt(torch.clamp(rn2, min=1e-20)) - h * h)
    total = torch.where(alive[1:] & valid0, rob, torch.zeros_like(rob)).sum()
    total = total + torch.where(valid0, (rho - rho0) ** 2, torch.zeros_like(rho)).sum() \
        / params.depth_prior_sigma ** 2
    if params.odo_prior_weight > 0:
        Z = init[1:] @ se3.inverse(init[:-1])
        T_prev = torch.cat([torch.eye(4, dtype=P.dtype)[None], P[1:-1]], 0)
        ro = se3.log_se3(P[1:] @ se3.inverse(T_prev) @ se3.inverse(Z))
        total = total + params.odo_prior_weight * (ro * ro).sum()
    return float(total)
