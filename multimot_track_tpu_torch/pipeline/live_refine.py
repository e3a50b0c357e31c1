"""Per-frame refinement of the live loop, with its acceptance gates on the
device.

Port of ``multimot_track_tpu.pipeline.live_refine.live_refine_step``: the
TrackLocalMap refinement of the frame's flow pose against the local map,
gated on the device (enough inliers, finite, a correction within the
translation and rotation caps), then the trailing-window BA from the gated
pose, so that the host reads one small result.  The JAX package reads the
pose and the inlier count out of a packed transfer vector; here they come
from the ``PairResult`` itself.
"""

from __future__ import annotations

import math
from typing import NamedTuple

import torch

from multimot_track_tpu_torch.config import PipelineConfig
from multimot_track_tpu_torch.geometry import se3
from multimot_track_tpu_torch.pipeline import window_refine
from multimot_track_tpu_torch.pipeline.keyframes import local_map_refine


class LiveRefine(NamedTuple):
    T1: torch.Tensor          # (4, 4) the recorded-frame pose after the gates
    accept_lm: torch.Tensor   # () bool
    n_lm: torch.Tensor        # () local-map inliers
    poses_out: torch.Tensor   # (W, 4, 4) refined window poses relative to its
    #                           frame 0, or (0, 4, 4) without the window
    n_live: torch.Tensor      # () window tracks alive at the last frame


def live_refine_step(
    result,                     # the frame's PairResult (device tensors)
    uv, desc, valid, z,         # current-frame keyframe-grade features
    Xw_m, desc_m, valid_m,      # the stacked local map (KeyframeStore.local_map)
    poses_rel_prev,             # (W-1, 4, 4) window poses relative to its frame 0
    Twc0,                       # (4, 4) the window's anchor (frame 0's Twc)
    grays, depth0, flows, sems,  # the window's wire tensors (on the device)
    corr: torch.Tensor,         # (4, 4) right-factor from the raw device chain
    #                             to the recorded world frame (identity in
    #                             synchronous mode)
    cfg: PipelineConfig,
    use_lm: bool,
    use_win: bool,
    min_inliers: int,
    match_backend: str,
    stage,
) -> LiveRefine:
    """T1 = the local-map pose where every gate holds, else the flow pose;
    both in the recorded world frame (``corr`` applied).  With ``use_win``
    the window [poses_rel_prev, T1 @ Twc0] is refined.  ``stage(name)``:
    a context manager that times the two parts (``"local_map"``,
    ``"window_refine"``)."""
    dev = corr.device
    T1 = result.Tcw_cur @ corr
    accept = torch.zeros((), dtype=torch.bool, device=dev)
    n_lm = torch.zeros((), dtype=torch.int64, device=dev)
    if use_lm:
        with stage("local_map"):
            T1, accept, n_lm = _gated_local_map(
                T1, result.n_static_inliers, uv, desc, valid, z, Xw_m, desc_m, valid_m, cfg,
                min_inliers, match_backend)
    poses_out = torch.zeros((0, 4, 4), dtype=torch.float32, device=dev)
    n_live = torch.zeros((), dtype=torch.int64, device=dev)
    if use_win:
        with stage("window_refine"):
            poses_rel = torch.cat([poses_rel_prev, (T1 @ Twc0)[None]], 0)
            poses_out, n_live = window_refine.refine_trailing_window(
                poses_rel, grays, depth0, flows, sems, cfg)
    return LiveRefine(T1, accept, n_lm, poses_out, n_live)


def _gated_local_map(T_flow, n_static_inliers, uv, desc, valid, z, Xw_m, desc_m, valid_m,
                     cfg: PipelineConfig, min_inliers: int, match_backend: str):
    """TrackLocalMap from ``T_flow`` and the acceptance gates of the unfused
    path, on the device.  Returns (T1, accept, n_lm)."""
    cam, be = cfg.camera, cfg.backend
    T_lm, n_lm, _ = local_map_refine(
        T_flow, Xw_m, desc_m, valid_m, uv, desc, valid, z,
        cam.fx, cam.fy, cam.cx, cam.cy, cam.width, cam.height, cam.bf,
        radius=be.local_map_radius_px, thresh=be.local_map_thresh_px, backend=match_backend,
    )
    d = T_lm @ se3.inverse(T_flow)
    t_norm = torch.sqrt((d[:3, 3] * d[:3, 3]).sum())
    cos = torch.clamp((d[0, 0] + d[1, 1] + d[2, 2] - 1.0) / 2.0, -1.0, 1.0)
    ang = torch.arccos(cos) * (180.0 / math.pi)
    accept = ((n_static_inliers >= min_inliers)
              & (n_lm >= be.local_map_min_inliers)
              & torch.isfinite(T_lm).all()
              & (t_norm <= be.local_map_max_corr_m)
              & (ang <= be.local_map_max_rot_deg))
    return torch.where(accept, T_lm, T_flow), accept, n_lm
