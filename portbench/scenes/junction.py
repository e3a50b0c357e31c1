"""Dense-traffic junction approach (``io/synth.make_junction_frames``):
the ego creeps forward at 0.45 m a frame with a lead vehicle, two oncoming
cars and four crossers at staggered depths, all in view together, so the
object branch meets 8 movers for its 6 solve slots.

``speed_knots`` and ``yaw_knots`` give the ego a drive of its own: lists of
[frame, value] pairs, linear between them (speed in m a frame, heading in
degrees, positive towards +x).  The step from frame t to t + 1 takes the
speed and heading at t + 1/2.  Without them the drive is the program's,
frame for frame."""

from __future__ import annotations

import numpy as np

from portbench.scenes.render import KITTI_SYNTH_CAM, Mover, Scene, path_poses, vee_panels


def build(n_frames: int = 60, n_concurrent: int = 8, cam=None, times=None,
          speed_knots=None, yaw_knots=None) -> Scene:
    cam = dict(KITTI_SYNTH_CAM) if cam is None else dict(cam)
    v = 0.45
    if speed_knots is None and yaw_knots is None:
        positions = [np.array([0.0, 0.0, v * t]) for t in range(n_frames)]
    else:
        positions = ego_path(n_frames, speed_knots or [[0, v]], yaw_knots or [[0, 0.0]])
    defs = [
        (1, lambda t: np.array([2.0, 0.25, 11.0 + 0.40 * t]), (0.0, 0.0, -1.0), 1.05, 0.78),
        (2, lambda t: np.array([-2.8, 0.20, 24.0 + 0.20 * t]), (0.0, 0.0, 1.0), 1.05, 0.78),
        (3, lambda t: np.array([-8.0 + 0.25 * t, 0.30, 20.0 + 0.30 * t]),
         (0.0, 0.0, -1.0), 1.0, 0.75),
        (4, lambda t: np.array([8.0 - 0.22 * t, 0.30, 23.0 + 0.25 * t]),
         (0.0, 0.0, -1.0), 1.0, 0.75),
        (5, lambda t: np.array([8.0 - 0.40 * t, 0.30, 10.5 + 0.43 * t]),
         (0.0, 0.0, -1.0), 0.8, 0.6),
        (6, lambda t: np.array([-14.0 + 0.40 * t, 0.35, 9.2 + 0.43 * t]),
         (0.0, 0.0, -1.0), 0.8, 0.6),
        (7, lambda t: np.array([-5.5, 0.20, 22.0 + 0.30 * t]), (0.0, 0.0, 1.0), 1.05, 0.78),
        (8, lambda t: np.array([6.5, 0.22, 18.0 + 0.33 * t]), (0.0, 0.0, 1.0), 1.05, 0.78),
    ]
    movers = [Mover(centre=c, half_w=hw, half_h=hh, seed=80 + lbl,
                    panels=vee_panels(face, hw, hh), label=lbl)
              for lbl, c, face, hw, hh in defs[:n_concurrent]]
    poses = path_poses(positions)
    return Scene(cam=cam, Twc_at=lambda t: poses[t], movers=movers,
                 times=list(range(n_frames)) if times is None else list(times),
                 box=(-40.0, 40.0, -20.0, v * n_frames + 95.0))


def ego_path(n_frames: int, speed_knots, yaw_knots):
    """Positions of frames 0 .. n_frames - 1 from piecewise-linear speed
    (m a frame) and heading (degrees) knots."""
    mid = np.arange(n_frames - 1) + 0.5
    sk, yk = np.asarray(speed_knots, np.float64), np.asarray(yaw_knots, np.float64)
    speed = np.interp(mid, sk[:, 0], sk[:, 1])
    yaw = np.deg2rad(np.interp(mid, yk[:, 0], yk[:, 1]))
    steps = speed[:, None] * np.stack([np.sin(yaw), np.zeros_like(yaw), np.cos(yaw)], -1)
    return list(np.concatenate([np.zeros((1, 3)), np.cumsum(steps, 0)], 0))
