"""Raw per-frame input record (host arrays).

A copy of ``multimot_track_tpu.io.kitti.FrameData``: the KITTI loader there
imports PIL and the JAX package, neither of which the port may need.
"""

from __future__ import annotations

import dataclasses

import numpy as np


@dataclasses.dataclass
class FrameData:
    """Raw per-frame inputs (host arrays)."""

    index: int
    timestamp: float
    gray: np.ndarray          # (H, W) float32 grayscale in [0, 255]
    depth_raw: np.ndarray     # (H, W) float32 raw png values (disparity*256)
    flow: np.ndarray          # (H, W, 2) float32 flow to next frame
    sem_mask: np.ndarray      # (H, W) int32 instance labels (0 = background)
    pose_gt: np.ndarray       # (4, 4) float32 camera-to-world (as stored on disk)
    obj_ids_gt: np.ndarray    # (M,) int32 ground-truth object ids this frame
    obj_poses_gt: np.ndarray  # (M, 4, 4) float32 camera-frame object poses L
    obj_bboxes_gt: np.ndarray  # (M, 4) float32 [x1 y1 x2 y2]
