"""Online ground-truth evaluation: camera and object relative pose errors,
speed error, segmentation confusion, flow-error histogram, ATE.

Port of ``multimot_track_tpu.eval.metrics`` (formula-level replication of
the reference system's src/Tracking.cc:1322-1345 and :2199-2248); every
function takes arbitrary leading batch dimensions.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from multimot_track_tpu_torch.geometry import se3


def _norm(x: torch.Tensor) -> torch.Tensor:
    return torch.sqrt((x * x).sum(-1))


class PoseRPE(NamedTuple):
    t_abs: torch.Tensor
    r_abs: torch.Tensor
    t_rel: torch.Tensor
    r_rel: torch.Tensor


def camera_rpe(Tcw_cur, Tcw_last, Tcw_gt_cur, Tcw_gt_last) -> PoseRPE:
    """RePoEr = (Tcw_cur Twc_last_est) (Tcw_gt_last Twc_gt_cur)."""
    T_lc_inv = Tcw_cur @ se3.inverse(Tcw_last)
    T_lc_gt = Tcw_gt_last @ se3.inverse(Tcw_gt_cur)
    E = T_lc_inv @ T_lc_gt
    t_abs = _norm(E[..., :3, 3])
    r_abs = se3.rotation_angle_deg(E[..., :3, :3])
    t_gt = _norm(T_lc_gt[..., :3, 3])
    return PoseRPE(t_abs, r_abs, t_abs / t_gt, r_abs / t_gt)


class ObjMotionErr(NamedTuple):
    t_abs: torch.Tensor
    r_abs: torch.Tensor
    t_rel: torch.Tensor
    r_rel: torch.Tensor
    speed_est: torch.Tensor      # km/h
    speed_gt: torch.Tensor       # km/h
    speed_err_rel: torch.Tensor
    t_abs_centred: torch.Tensor
    t_rel_centred: torch.Tensor


def object_motion_error(H_est, H_gt, centre_pre, L_w_p_t, L_w_c_t) -> ObjMotionErr:
    """E = H_est^-1 H_gt; speed from the centroid lever arm."""
    E = se3.inverse(H_est) @ H_gt
    t_abs = _norm(E[..., :3, 3])
    r_abs = se3.rotation_angle_deg(E[..., :3, :3])
    t_gt = _norm(H_gt[..., :3, 3])
    sp_gt = _norm(L_w_p_t - L_w_c_t)
    R = H_est[..., :3, :3]
    eye = torch.eye(3, dtype=H_est.dtype, device=H_est.device)
    sp_est_v = H_est[..., :3, 3] - ((eye - R) @ centre_pre[..., None])[..., 0]
    sp_est = _norm(sp_est_v)
    d_gt = L_w_c_t - L_w_p_t
    t_cen = _norm(sp_est_v - d_gt)
    return ObjMotionErr(
        t_abs=t_abs, r_abs=r_abs, t_rel=t_abs / t_gt, r_rel=r_abs / t_gt,
        speed_est=sp_est * 36.0, speed_gt=sp_gt * 36.0,
        speed_err_rel=(sp_est - sp_gt).abs() / torch.clamp(sp_gt, min=1e-12),
        t_abs_centred=t_cen,
        t_rel_centred=t_cen / torch.clamp(_norm(d_gt), min=1e-12),
    )


class SegConfusion(NamedTuple):
    tot: torch.Tensor
    fp: torch.Tensor
    fn: torch.Tensor
    nd: torch.Tensor


def segmentation_confusion(pred_label, sem_label, gt_dynamic_ids, gt_dynamic_valid,
                           valid) -> SegConfusion:
    """The reference's ``coer`` tot/fp/fn/nd accounting over (..., N) points
    against (..., K) GT-dynamic ids."""
    is_gt_dyn = (
        (sem_label[..., :, None] == gt_dynamic_ids[..., None, :])
        & gt_dynamic_valid[..., None, :]
    ).any(-1) & valid
    pred_dyn = (pred_label >= 1) & valid
    pred_static = (pred_label == 0) & valid
    undetected = (pred_label < 0) & valid
    return SegConfusion(
        tot=is_gt_dyn.sum(-1),
        fp=(pred_dyn & ~is_gt_dyn).sum(-1),
        fn=(pred_static & is_gt_dyn).sum(-1),
        nd=(undetected & is_gt_dyn).sum(-1),
    )


def flow_error_histogram(err: torch.Tensor, valid: torch.Tensor) -> torch.Tensor:
    """20-bin histogram of (..., N) flow errors: 0.5 px bins to 9, then
    [9, 10) and [10, inf).  Returns (..., 20) int64."""
    edges = torch.cat([torch.arange(0.0, 9.5, 0.5, device=err.device),
                       torch.tensor([10.0, float("inf")], device=err.device)])
    idx = torch.clamp(torch.searchsorted(edges, err.contiguous(), right=True) - 1, 0, 19)
    out = torch.zeros(err.shape[:-1] + (20,), dtype=torch.int64, device=err.device)
    return out.scatter_add_(-1, idx, valid.to(torch.int64))


def umeyama(src: torch.Tensor, dst: torch.Tensor, with_scale: bool = True):
    """dst ~= s R src + t for (N, 3) point sets.  Returns (s, R, t)."""
    n = src.shape[-2]
    cs, cd = src.mean(-2), dst.mean(-2)
    s0, d0 = src - cs, dst - cd
    cov = d0.transpose(-1, -2) @ s0 / n
    U, S, Vt = torch.linalg.svd(cov)
    det = torch.linalg.det(U @ Vt)
    D = torch.diag(torch.stack([torch.ones_like(det), torch.ones_like(det), det]))
    R = U @ D @ Vt
    var_s = (s0 * s0).sum(-1).mean(-1)
    trace_DS = S[0] + S[1] + det * S[2]
    s = trace_DS / torch.clamp(var_s, min=1e-12) if with_scale else torch.ones_like(var_s)
    t = cd - s * (R @ cs)
    return s, R, t


def absolute_trajectory_error(est_Twc, gt_Twc, align: bool = True, with_scale: bool = False):
    """ATE-RMSE of (M, 4, 4) camera-to-world trajectories after rigid (or
    similarity) Umeyama alignment.  Returns (rmse, per-frame errors)."""
    p_est = est_Twc[:, :3, 3]
    p_gt = gt_Twc[:, :3, 3]
    if align:
        s, R, t = umeyama(p_est, p_gt, with_scale=with_scale)
        p_est = s * p_est @ R.T + t
    err = _norm(p_est - p_gt)
    return torch.sqrt((err ** 2).mean()), err
