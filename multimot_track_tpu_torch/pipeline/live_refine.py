"""Per-frame refinement of the live loop, with its acceptance gates on the
device.

Port of ``multimot_track_tpu.pipeline.live_refine.live_refine_step``: the
TrackLocalMap refinement of the frame's flow pose against the local map,
gated on the device (enough inliers, finite, a correction within the
translation and rotation caps) so that the host reads one small result.
The JAX package reads the pose and the inlier count out of a packed
transfer vector; here they come from the ``PairResult`` itself.

The trailing-window branch (``use_win``) needs ``window_refine``, which is
not ported yet (ROADMAP item 14).
"""

from __future__ import annotations

import math
from typing import NamedTuple

import torch

from multimot_track_tpu_torch.config import PipelineConfig
from multimot_track_tpu_torch.geometry import se3
from multimot_track_tpu_torch.pipeline.keyframes import local_map_refine


class LiveRefine(NamedTuple):
    T1: torch.Tensor          # (4, 4) the recorded-frame pose after the gates
    accept_lm: torch.Tensor   # () bool
    n_lm: torch.Tensor        # () local-map inliers


def live_refine_step(
    result,                     # the frame's PairResult (device tensors)
    uv, desc, valid, z,         # current-frame keyframe-grade features
    Xw_m, desc_m, valid_m,      # the stacked local map (KeyframeStore.local_map)
    corr: torch.Tensor,         # (4, 4) right-factor from the raw device chain
    #                             to the recorded world frame (identity in
    #                             synchronous mode)
    cfg: PipelineConfig,
    use_lm: bool,
    use_win: bool,
    min_inliers: int,
    match_backend: str = "auto",
) -> LiveRefine:
    """T1 = the local-map pose where every gate holds, else the flow pose;
    both in the recorded world frame (``corr`` applied)."""
    if use_win:
        raise NotImplementedError("the live window refinement needs window_refine, "
                                  "which is not ported yet (ROADMAP item 14)")
    cam, be = cfg.camera, cfg.backend
    T_flow = result.Tcw_cur @ corr
    accept = torch.zeros((), dtype=torch.bool, device=corr.device)
    n_lm = torch.zeros((), dtype=torch.int64, device=corr.device)
    if not use_lm:
        return LiveRefine(T_flow, accept, n_lm)
    T_lm, n_lm, _ = local_map_refine(
        T_flow, Xw_m, desc_m, valid_m, uv, desc, valid, z,
        cam.fx, cam.fy, cam.cx, cam.cy, cam.width, cam.height, cam.bf,
        radius=be.local_map_radius_px, thresh=be.local_map_thresh_px, backend=match_backend,
    )
    d = T_lm @ se3.inverse(T_flow)
    t_norm = torch.sqrt((d[:3, 3] * d[:3, 3]).sum())
    cos = torch.clamp((d[0, 0] + d[1, 1] + d[2, 2] - 1.0) / 2.0, -1.0, 1.0)
    ang = torch.arccos(cos) * (180.0 / math.pi)
    accept = ((result.n_static_inliers >= min_inliers)
              & (n_lm >= be.local_map_min_inliers)
              & torch.isfinite(T_lm).all()
              & (t_norm <= be.local_map_max_corr_m)
              & (ang <= be.local_map_max_rot_deg))
    return LiveRefine(torch.where(accept, T_lm, T_flow), accept, n_lm)
