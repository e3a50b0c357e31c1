"""Trailing-window refinements of the live system.

Port of ``multimot_track_tpu.pipeline.window_refine``.  Both refiners take
the window's wire tensors, which stay on the device after the frames'
uploads, so a refinement moves no image data between host and device:

* ``refine_trailing_window`` (every frame): FAST on window frame 0, tracks
  chained through the stored flow fields and verified by ZNCC against the
  frame-0 patch, then the inverse-depth window BA (``solvers.window_ba``;
  on the card one launch of kernel K3) from the online poses;
* ``refine_joint_window`` (keyframe cadence): per-pair static grid points
  and per-slot object points re-derived from the window's images, then the
  joint ego + object refinement (``solvers.multi_window_ba``).

Inside the live system's spans, the trailing window's parts are the spans
``tracks`` (FAST, chained tracks, ZNCC) and ``lm`` (the window BA), and the
joint window's point selection is part of its ``problem`` span.
"""

from __future__ import annotations

import torch

from multimot_track_tpu_torch.config import PipelineConfig
from multimot_track_tpu_torch.frontend import fast, sampling, tracks
from multimot_track_tpu_torch.geometry import camera
from multimot_track_tpu_torch.ops import photometric, wire
from multimot_track_tpu_torch.solvers import multi_window_ba
from multimot_track_tpu_torch.solvers.window_ba import WindowBAParams, solve_window_ba_auto
from multimot_track_tpu_torch.utils.profiling import span


def refine_joint_window(
    poses_rel: torch.Tensor,    # (W, 4, 4) Tcw relative to window frame 0
    H_init: torch.Tensor,       # (W-1, K, 4, 4) window-world object motions
    H_valid: torch.Tensor,      # (W-1, K) bool
    grays_u8: torch.Tensor,     # (W, H, W) uint8
    depths_w: torch.Tensor,     # (W, ...) wire depth
    flows_w: torch.Tensor,      # (W-1, ...) wire flow k -> k+1
    sems_w: torch.Tensor,       # (W, ...) wire instance masks
    cfg: PipelineConfig,
):
    """Joint ego + multi-object window BA.  Returns (poses (W, 4, 4),
    motions (W-1, K, 4, 4), chi2)."""
    with span("problem"):
        be, cam, fe = cfg.backend, cfg.camera, cfg.frontend
        K = cfg.padding.k_obj_max
        P = poses_rel.shape[0] - 1                     # pairs in the window
        Himg, Wimg = grays_u8.shape[-2:]
        dev = grays_u8.device
        depths = camera.disparity_png_to_depth(wire._decode_depth(depths_w, Wimg), cam.bf)[:-1]
        flows = wire._decode_flow(flows_w, Himg, Wimg)
        sems = wire._decode_sem(sems_w, Wimg)[:-1]
        grays = grays_u8.to(torch.float32)

        # static grid: off-mask, valid depth, flow target inside the image
        yy, xx = torch.meshgrid(torch.arange(0, Himg, be.joint_static_stride, device=dev),
                                torch.arange(0, Wimg, be.joint_static_stride, device=dev),
                                indexing="ij")
        d, lab, f = depths[:, yy, xx], sems[:, yy, xx], flows[:, yy, xx]
        xs, ys = xx.to(torch.float32), yy.to(torch.float32)
        nx, ny = xs + f[..., 0], ys + f[..., 1]
        ok = ((lab == 0) & (d > 0) & (d < fe.static_max_depth)
              & (nx > 0) & (nx < Wimg) & (ny > 0) & (ny < Himg))
        uv = torch.stack([xs, ys], -1).reshape(1, -1, 2).expand(P, -1, 2)
        _, m_s, uv_s, z_s, f_s = sampling.compact(ok.reshape(P, -1), be.joint_static_max, uv,
                                                  d.reshape(P, -1), f.reshape(P, -1, 2))
        # photometric verification of the flow correspondence, then the
        # depth-variance weight (sigma_z ~ z^2) of the fixed depths
        r = cfg.solver.zncc_patch_radius
        p0 = photometric.extract_patches(grays[:-1], uv_s, r)
        p1 = photometric.extract_patches(grays[1:], uv_s + f_s, r)
        m_s = m_s & (photometric.zncc(p0, p1) > be.window_zncc_min)
        m_s = m_s.to(torch.float32) / (1.0 + (z_s / cfg.solver.cam_depth_weight_z0) ** 2)

        # object points: the tracker's dense sampling, split by slot
        M = be.joint_obj_pts
        s = sampling.sample_dense_objects(depths, sems, flows, step=fe.obj_sample_step,
                                          max_depth=fe.obj_max_depth, n_max=4 * M * K)
        slots = torch.arange(1, K + 1, device=dev)
        vk = s.valid[:, None] & (s.label[:, None] == slots[None, :, None])     # (P, K, n)
        n = vk.shape[-1]
        rep = lambda x: x[:, None].expand((P, K) + x.shape[1:]).reshape((P * K,) + x.shape[1:])
        _, ob_m, ob_uv, ob_z, ob_fl = sampling.compact(vk.reshape(P * K, n), M, rep(s.uv),
                                                       rep(s.depth), rep(s.flow))
        unflat = lambda x: x.reshape((P, K) + x.shape[1:])

    res = multi_window_ba.refine_window(
        poses_rel, H_init, H_valid, uv_s, f_s, z_s, m_s,
        unflat(ob_uv), unflat(ob_fl), unflat(ob_z), unflat(ob_m),
        cam.fx, cam.fy, cam.cx, cam.cy,
        params=multi_window_ba.MultiWindowParams(
            iters=be.joint_iters, w_smooth=be.joint_w_smooth, w_odo=be.joint_w_odo,
            w_motion_prior=be.joint_w_motion_prior, obj_init_gate_px=be.joint_obj_gate_px),
    )
    return res.poses, res.motions, res.chi2


def refine_trailing_window(
    poses_rel: torch.Tensor,    # (W, 4, 4) Tcw relative to window frame 0 (I)
    grays_u8: torch.Tensor,     # (W, H, W) uint8 window frames
    depth0_w: torch.Tensor,     # wire depth of window frame 0
    flows_w: torch.Tensor,      # (W-1, ...) wire flow k -> k+1
    sems_w: torch.Tensor,       # (W, ...) wire instance masks
    cfg: PipelineConfig,
):
    """Returns (refined poses (W, 4, 4), live tracks at the last frame ())."""
    with span("tracks"):
        be, cam = cfg.backend, cfg.camera
        grays = grays_u8.to(torch.float32)
        depth0 = camera.disparity_png_to_depth(wire._decode_depth(depth0_w, cam.width), cam.bf)
        flows = wire._decode_flow(flows_w, cam.height, cam.width)
        sems = wire._decode_sem(sems_w, cam.width)

        kp = fast.detect_pyramid(grays[:1], n_levels=4, n_total=be.n_window_tracks)
        uv = kp.uv[0]
        z0 = camera.nearest_sample(depth0[None], kp.uv)[0][0]
        lab0 = camera.nearest_sample(sems[:1], kp.uv)[0][0]
        valid0 = kp.valid[0] & (z0 > 0) & (z0 < 40.0) & (lab0 == 0)

        tr = tracks.chain_tracks(uv, valid0, flows, sems)
        # every chained observation must still look like its frame-0 patch
        r = cfg.solver.zncc_patch_radius
        p0 = photometric.extract_patches(grays[:1], kp.uv, r)
        pf = photometric.extract_patches(grays[1:], tr.uv[1:], r)
        alive_v = tr.alive[1:] & (photometric.zncc(p0, pf) > be.window_zncc_min)
        alive_v = torch.cumprod(alive_v.to(torch.int32), 0).bool()
        alive = torch.cat([tr.alive[:1], alive_v], 0)

    with span("lm"):
        res = solve_window_ba_auto(
            poses_rel, tr.uv, alive, z0, cam.fx, cam.fy, cam.cx, cam.cy,
            params=WindowBAParams(iters=be.window_ba_iters,
                                  odo_prior_weight=be.odo_prior_weight),
        )
        return res.poses, alive[-1].sum()
