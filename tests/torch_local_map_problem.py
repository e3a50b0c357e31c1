"""Seeded TrackLocalMap Gauss-Newton problems at the KITTI camera, for kernel
K4 (csrc/local_map_gn.cu) and its plain version ``keyframes.local_map_gn``.

``tests/test_torch_local_map_kernel.py`` and ``chip_smoke.py --k4-only``
draw their problems here.  A problem is what ``local_map_refine`` hands the
Gauss-Newton after its match: the init pose, the map points, the matched
keypoints, the measured disparities and their weights (from
``keyframes.disparity_rows``, as ``local_map_refine`` takes them) and the
match mask.  Imports no jax.
"""

from __future__ import annotations

import numpy as np
import torch

from multimot_track_tpu_torch.config import CameraConfig
from multimot_track_tpu_torch.geometry import camera, se3
from multimot_track_tpu_torch.pipeline.keyframes import disparity_rows

CAM = CameraConfig()


def cams():
    """(fx, fy, cx, cy, bf) of the KITTI camera."""
    return CAM.fx, CAM.fy, CAM.cx, CAM.cy, CAM.bf


def make_local_map(M=3072, seed=0, depth=True, outlier_frac=0.1, match_frac=0.85):
    """A seeded local map of M points at 4-35 m seen by the current frame,
    ``match_frac`` of them matched with 0.5 px noise, ``outlier_frac`` of the
    matches 6-40 px off, unmatched rows holding an unrelated keypoint (as a
    match index does).  With ``depth``, 90 % of the matches carry a depth
    with 1 % noise, else none has one.  The init pose is ~8 cm and ~0.2 deg
    off the true pose.  Returns (T_init, Xw, uv_obs, disp_obs, w_disp,
    matched) on the CPU."""
    rng = np.random.default_rng(seed)
    t = lambda a: torch.from_numpy(np.ascontiguousarray(a, np.float32))
    T_true = se3.exp_se3(t([0.01, -0.02, 0.005, 0.3, -0.1, 2.0]))
    uv0 = rng.uniform([10, 10], [CAM.width - 10, CAM.height - 10], (M, 2))
    z = rng.uniform(4.0, 35.0, M)
    Xc = camera.backproject(t(uv0), t(z), CAM.fx, CAM.fy, CAM.cx, CAM.cy)
    Xw = se3.transform(se3.inverse(T_true), Xc)
    y = se3.transform(T_true, Xw)
    uv = camera.project(y, CAM.fx, CAM.fy, CAM.cx, CAM.cy).numpy()
    uv = uv + rng.normal(scale=0.5, size=uv.shape)
    matched = rng.uniform(size=M) < match_frac
    bad = matched & (rng.uniform(size=M) < outlier_frac)
    ang = rng.uniform(0, 2 * np.pi, M)
    off = rng.uniform(6.0, 40.0, M)
    uv[bad] += np.stack([np.cos(ang), np.sin(ang)], -1)[bad] * off[bad, None]
    uv[~matched] = rng.uniform([0, 0], [CAM.width, CAM.height], (int((~matched).sum()), 2))
    z_obs = y[:, 2].numpy() * (1 + rng.normal(scale=0.01, size=M))
    z_obs[(rng.uniform(size=M) < 0.1) | (not depth)] = 0.0
    uv_obs, z_obs, matched = t(uv), t(z_obs), torch.from_numpy(matched)
    disp_obs, w_disp = disparity_rows(z_obs, matched, CAM.bf)
    d = t(np.concatenate([rng.normal(scale=0.002, size=3), rng.normal(scale=0.05, size=3)]))
    T_init = (se3.exp_se3(d) @ T_true).contiguous()
    return T_init, Xw.contiguous(), uv_obs, disp_obs, w_disp, matched
