"""Arterial drive with track turnover (``io/synth.make_avenue_frames``):
the ego drives at 0.75 m a frame along gentle S-curves (2.5 m amplitude,
a 120-frame period) behind a lead car; oncoming cars and crossers are born
and die along the road, and a newborn mover takes the mask label of one
that left (labels 2, 3, 2, 3 for the oncoming cars, 4, 5 for the crossers),
as the reference's 3-label KITTI masks hand labels on.

``box_frames`` sizes the drive as the program's generator sizes a drive of
that many frames (its path, the far wall, the movers' lifespans), and the
scene gives that drive's first ``n_frames`` frames, frame for frame.
``n_concurrent`` keeps the first n movers (the lead, then the oncoming
cars, then the crossers); None keeps all."""

from __future__ import annotations

import numpy as np

from portbench.scenes.render import KITTI_SYNTH_CAM, Mover, Scene, path_poses, vee_panels

SPEED = 0.75                # m a frame
AMPLITUDE, PERIOD = 2.5, 120.0


def facing_axes(n_dir):
    """Quad axes (e1 horizontal, e2 = +y, n) of a plane facing ``n_dir``
    (``io/synth._facing_axes``)."""
    n = np.asarray(n_dir, np.float64).copy()
    n[1] = 0.0
    n /= max(np.linalg.norm(n), 1e-9)
    return np.stack([np.array([n[2], 0.0, -n[0]]), np.array([0.0, 1.0, 0.0]), n])


def movers():
    """The drive's movers in the program's order: the lead (label 1), four
    oncoming cars (labels 2, 3, 2, 3), four crossers (labels 4, 5, 4, 5)."""
    v = SPEED
    out = [Mover(centre=lambda t: np.array([2.2, 0.25, 12.0 + 0.72 * t]),
                 half_w=1.1, half_h=0.8, seed=50,
                 panels=vee_panels((0.0, 0.0, -1.0), 1.1, 0.8), label=1)]
    for i in range(4):
        z0 = 55.0 + 62.0 * i
        t_meet = z0 / (v + 0.95)
        out.append(Mover(centre=lambda t, z=z0: np.array([-2.8, 0.2, z - 0.95 * t]),
                         half_w=1.0, half_h=0.75, seed=60 + i,
                         panels=vee_panels((0.0, 0.0, 1.0), 1.0, 0.75),
                         t0=max(0.0, t_meet - 32), t1=t_meet + 6, label=2 + i % 2))
    for i in range(4):
        z_st = 45.0 + 48.0 * i
        t_arr = (z_st - 12.0) / v
        out.append(Mover(centre=lambda t, z=z_st, ta=t_arr: np.array(
                             [-9.0 + 0.55 * (t - (ta - 10)), 0.3, z]),
                         half_w=0.9, half_h=0.8, seed=70 + i,
                         axes=facing_axes((0.0, 0.0, -1.0)),
                         t0=t_arr - 10, t1=t_arr + 28, label=4 + i % 2))
    return out


def build(n_frames: int = 120, cam=None, times=None, n_concurrent: int = None,
          box_frames: int = 240) -> Scene:
    if n_frames > box_frames:
        raise ValueError(f"{n_frames} frames of a drive sized for {box_frames}")
    cam = dict(KITTI_SYNTH_CAM) if cam is None else dict(cam)
    positions = [np.array([AMPLITUDE * np.sin(2 * np.pi * t / PERIOD), 0.0, SPEED * t])
                 for t in range(box_frames)]
    poses = path_poses(positions)
    return Scene(cam=cam, Twc_at=lambda t: poses[t], movers=movers()[:n_concurrent],
                 times=list(range(n_frames)) if times is None else list(times),
                 box=(-40.0, 40.0, -20.0, SPEED * box_frames + 60.0))
