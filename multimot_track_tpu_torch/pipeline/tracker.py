"""The per-frame-pair multi-motion tracking step, batched over pairs.

Port of ``multimot_track_tpu.pipeline.tracker.track_pair``: ego RANSAC and
the symmetric forward/backward flow-BA, sparse scene flow, per-label
grouping and static/dynamic classification, the per-object RANSAC ->
flow-BA -> reclassify chains with their photometric and 3-D consensus
pick, and the online metrics.

``vmap`` becomes leading axes written out: every tensor of ``track_pairs``
is (B, ...) over pairs, object tensors are (B, K, ...) over label slots and
the seed ensemble (B, K_s, S, ...).  Each flow-BA stage is therefore one
solve over all instances of the chunk: camera forward (B), camera backward
(B), then object stage 0 and each reclassify round (B * K_s * S each).

``first_step`` and ``full_step`` run one frame of the live loop at B = 1
(the live system's per-frame program).  Inside the live system's
``dispatch_pair`` span, the step's parts are the spans ``frontend``,
``ego``, ``segment``, ``objects``, ``finish`` and ``gt_eval`` (the
evaluation against the frames' ground truth); elsewhere they record
nothing.  Given a ``step_graph.StepTape``, ``full_step`` replays the step
from recorded CUDA graphs where the tape engages; ``span`` and
``solve_flow_ba_auto`` here are ``step_graph``'s, the cuts of that tape.

Index clamps written out where XLA clamps silently and torch raises:
``slot_of_label[ob_cur_label]``, ``H_prev_by_label[mode_lab]``; the JAX
``.at[tgt].set(..., mode="drop")`` compaction scatters into an M+1 buffer
whose last slot is dropped.
"""

from __future__ import annotations

from typing import NamedTuple, Optional, Sequence

import torch

from multimot_track_tpu_torch.config import PipelineConfig
from multimot_track_tpu_torch.eval import metrics
from multimot_track_tpu_torch.frontend.fast import topk_stable
from multimot_track_tpu_torch.geometry import camera, se3
from multimot_track_tpu_torch.ops import photometric
from multimot_track_tpu_torch.pipeline.frames import PairInputs, tree_map
from multimot_track_tpu_torch.pipeline.step_graph import StepTape, solve_flow_ba_auto, span
from multimot_track_tpu_torch.solvers import ransac
from multimot_track_tpu_torch.solvers.flow_ba import (
    FlowBAParams, FlowBAResult, camera_params, flow_ba_route)
from multimot_track_tpu_torch.utils.profiling import count


class TrackContext(NamedTuple):
    """State carried from the previous pair, (B, ...)."""

    Tcw_last: torch.Tensor          # (B, 4, 4)
    H_prev_by_label: torch.Tensor   # (B, K+1, 4, 4) last world-frame motion by label
    H_prev_valid: torch.Tensor      # (B, K+1) bool
    T_velocity: torch.Tensor        # (B, 4, 4) constant-velocity model
    velocity_valid: torch.Tensor    # (B,) bool


def initial_context(k_obj_max: int, batch: int = 1, device="cpu") -> TrackContext:
    eye = torch.eye(4, device=device)
    return TrackContext(
        Tcw_last=eye.expand(batch, 4, 4).clone(),
        H_prev_by_label=eye.expand(batch, k_obj_max + 1, 4, 4).clone(),
        H_prev_valid=torch.zeros((batch, k_obj_max + 1), dtype=torch.bool, device=device),
        T_velocity=eye.expand(batch, 4, 4).clone(),
        velocity_valid=torch.zeros((batch,), dtype=torch.bool, device=device),
    )


class ObjectOutputs(NamedTuple):
    """Per-label-slot outputs, (B, K, ...); slot l is label l+1."""

    seen: torch.Tensor
    is_static: torch.Tensor
    active: torch.Tensor
    n_points: torch.Tensor
    mode_last_label: torch.Tensor
    H: torch.Tensor             # (B, K, 4, 4) world-frame motion
    n_inliers: torch.Tensor
    centre3d: torch.Tensor      # (B, K, 3)
    centre_pre: torch.Tensor    # (B, K, 3)
    bbox: torch.Tensor          # (B, K, 4)
    speed_est: torch.Tensor
    speed_gt: torch.Tensor
    t_rpe: torch.Tensor
    r_rpe: torch.Tensor
    t_rpe_rel: torch.Tensor
    r_rpe_rel: torch.Tensor
    speed_err_rel: torch.Tensor
    t_rpe_centred: torch.Tensor
    has_gt: torch.Tensor


class PairResult(NamedTuple):
    Tcw_cur: torch.Tensor
    cam_t_rpe: torch.Tensor
    cam_r_rpe: torch.Tensor
    cam_t_rpe_rel: torch.Tensor
    cam_r_rpe_rel: torch.Tensor
    n_static: torch.Tensor
    n_static_inliers: torch.Tensor
    flow_hist: torch.Tensor          # (B, 20)
    seg_confusion: metrics.SegConfusion
    objects: ObjectOutputs
    obj_label_map: torch.Tensor      # (B, No): -2 unprocessed, -1 outlier,
    #                                  0 static, l>=1 object slot+1


def _where_res(cond: torch.Tensor, a: FlowBAResult, b: FlowBAResult) -> FlowBAResult:
    """Per-instance select between two FlowBAResults; cond is (M,)."""
    return FlowBAResult(*(
        torch.where(cond.view((-1,) + (1,) * (x.dim() - 1)), x, y) for x, y in zip(a, b)
    ))


def _strided(n: int, s: int) -> slice:
    """The JAX package's witness subsample: every (n // s)-th of the first
    (n // s) * s points, or all points when s is 0 or >= n."""
    return slice(0, (n // s) * s, n // s) if 0 < s < n else slice(None)


def track_pairs(
    pair: PairInputs,
    ctx: TrackContext,
    cfg: PipelineConfig,
    sampler: ransac.HypothesisSampler,
    pair_ids: Sequence[int],
) -> PairResult:
    """Track B pairs at once.  ``pair_ids[b]`` names pair b for the
    hypothesis sampler; the flow-BA runs on cfg.solver.flow_ba_backend."""
    cam, sol, seg = cfg.camera, cfg.solver, cfg.segmentation
    K = cfg.padding.k_obj_max
    fx, fy, cx, cy = cam.fx, cam.fy, cam.cx, cam.cy
    backend = flow_ba_route(sol.flow_ba_backend)
    B = pair.st_uv.shape[0]
    dev = pair.st_uv.device
    bidx = torch.arange(B, device=dev)
    eye4 = torch.eye(4, device=dev)
    with span("ego"):
        # ---------------- ego motion: verified points, RANSAC/MM init, ------
        # ---------------- symmetric forward + backward flow-BA --------------
        Twl = se3.inverse(ctx.Tcw_last)
        st_phot = pair.st_valid & (pair.st_zncc > sol.zncc_min)
        st_solve = torch.where((st_phot.sum(-1) >= sol.min_gated_static)[:, None],
                               st_phot, pair.st_valid)
        Xw_st = se3.transform(Twl, camera.backproject(pair.st_uv, pair.st_depth, fx, fy, cx, cy))
        xyz_cur_st = camera.backproject(pair.st_cur_uv, pair.st_cur_depth, fx, fy, cx, cy)
        st_pnp_valid = st_solve & (pair.st_cur_depth > 0)
        rr = ransac.ransac_rigid_pose(
            Xw_st, pair.st_cur_uv, xyz_cur_st, st_pnp_valid, fx, fy, cx, cy,
            sampler=sampler, sites=ransac.Sites([(int(p), "ego") for p in pair_ids]),
            thresh=sol.ransac_reproj_px, iters=sol.ransac_iters,
            refine_iters=sol.refine_gn_iters,
        )
        MM_cam = ctx.T_velocity @ ctx.Tcw_last
        _, n_mm_cam = ransac._count_inliers(MM_cam, Xw_st, pair.st_cur_uv, st_pnp_valid,
                                            sol.ransac_reproj_px, fx, fy, cx, cy)
        use_mm_cam = ctx.velocity_valid & (n_mm_cam > rr.n_inliers)
        T_init_cam = torch.where(use_mm_cam[:, None, None], MM_cam, rr.T)
        if sol.cam_init_consensus_px > 0:
            inl0, n0 = ransac._count_inliers(T_init_cam, Xw_st, pair.st_cur_uv, st_solve,
                                             sol.cam_init_consensus_px, fx, fy, cx, cy)
            st_solve = torch.where((n0 >= sol.min_gated_static)[:, None], st_solve & inl0, st_solve)

        cam_params = camera_params(sol)

        def solve_cam_sym(subset, T_init):
            """Forward flow-BA plus a backward solve anchored on the current
            frame's depth, se(3)-averaged (cancels first-order depth bias)."""
            z0 = sol.cam_depth_weight_z0
            w_fwd = 1.0 / (1.0 + (pair.st_depth / z0) ** 2) if z0 > 0 else None
            res_f = solve_flow_ba_auto(
                T_init, Twl, pair.st_uv, pair.st_flow, pair.st_depth, subset,
                fx, fy, cx, cy, params=cam_params, backend=backend, point_weight=w_fwd)
            if not sol.symmetric_cam:
                return res_f.T, res_f
            rel_f = res_f.T @ se3.inverse(ctx.Tcw_last)
            w_bwd = (1.0 / (1.0 + (torch.clamp(pair.st_cur_depth, min=0.0) / z0) ** 2)
                     if z0 > 0 else None)
            bwd_res = solve_flow_ba_auto(
                se3.inverse(rel_f), eye4.expand(B, 4, 4), pair.st_cur_uv, -pair.st_flow,
                pair.st_cur_depth, subset & (pair.st_cur_depth > 0),
                fx, fy, cx, cy, params=cam_params, backend=backend, point_weight=w_bwd)
            rel_b = se3.inverse(bwd_res.T)
            xi_f = se3.log_se3(rel_f)
            xi = 0.5 * (xi_f + se3.log_se3(rel_b))
            ok_b = (bwd_res.n_inliers >= 10) & torch.isfinite(xi).all(-1)
            T = se3.exp_se3(torch.where(ok_b[:, None], xi, xi_f)) @ ctx.Tcw_last
            return T, res_f

        T_sym, cam_res = solve_cam_sym(st_solve, T_init_cam)
        if sol.sf_cam_gate > 0.0:
            # scene-flow reclassification of the static set, then re-solve
            d3 = se3.transform(se3.inverse(T_sym), xyz_cur_st) - Xw_st
            sfm = torch.sqrt(d3[..., 0] ** 2 + d3[..., 2] ** 2)
            gate = sol.sf_cam_gate + sol.sf_cam_depth_coeff * pair.st_depth ** 2
            keep = st_solve & torch.where(pair.st_cur_depth > 0, sfm < gate,
                                          torch.ones_like(st_solve))
            T_re, cam_res_re = solve_cam_sym(keep, T_sym)
            use_re = keep.sum(-1) >= sol.min_gated_static
            T_sym = torch.where(use_re[:, None, None], T_re, T_sym)
            cam_res = _where_res(use_re, cam_res_re, cam_res)
            st_solve = torch.where(use_re[:, None], keep, st_solve)
        n_st = st_solve.sum(-1)
        Tcw_cur = torch.where((n_st >= 3)[:, None, None], T_sym, ctx.Tcw_last)
        Twc_cur = se3.inverse(Tcw_cur)

    with span("segment"):
        # ---------------- sparse scene flow ----------------
        Xp_w = se3.transform(Twl, camera.backproject(pair.ob_uv, pair.ob_depth, fx, fy, cx, cy))
        Xc_w = se3.transform(Twc_cur, camera.backproject(pair.ob_cur_uv, pair.ob_cur_depth,
                                                         fx, fy, cx, cy))
        flow3 = Xc_w - Xp_w
        pt_ok = pair.ob_valid & (pair.ob_cur_label > 0) & (pair.ob_label_last > 0)

        # ---------------- grouping + static/dynamic ----------------
        labels = torch.arange(1, K + 1, dtype=torch.int32, device=dev)            # (K,)
        member = pt_ok[:, None, :] & (pair.ob_cur_label[:, None, :] == labels[None, :, None])
        mf = member.to(torch.float32)                                             # (B, K, No)
        count = mf.sum(-1)
        cnt1 = torch.clamp(count, min=1.0)
        u, v = pair.ob_cur_uv[..., 0], pair.ob_cur_uv[..., 1]
        H_img, W_img = cam.height, cam.width
        on_boundary = ((v < seg.boundary_margin_v) | (v > H_img - seg.boundary_margin_v)
                       | (u < seg.boundary_margin_u) | (u > W_img - seg.boundary_margin_u))
        bnd_frac = (mf * on_boundary[:, None, :]).sum(-1) / cnt1
        sf_norm = torch.sqrt(flow3[..., 0] ** 2 + flow3[..., 2] ** 2)
        sf_frac = (mf * (sf_norm < seg.sf_thres)[:, None, :]).sum(-1) / cnt1
        depth_mean = (mf * pair.ob_cur_depth[:, None, :]).sum(-1) / cnt1

        seen = (bnd_frac <= seg.boundary_frac) & (count > seg.min_obj_points)
        is_static = seen & (sf_frac > seg.sf_percent)
        active = seen & ~is_static & (depth_mean <= seg.max_obj_depth)

        # association: most frequent last-frame label among members
        last_onehot = (pair.ob_label_last[:, None, :] == labels[None, :, None]).to(torch.float32)
        cross = mf @ last_onehot.transpose(1, 2)                                   # (B, K, K)
        mode_last = torch.where(count > 0, labels[torch.argmax(cross, -1)],
                                torch.zeros_like(labels)[None])

    with span("objects"):
        # ---------------- per-object init + flow-BA ----------------
        xyz_cur_ob = camera.backproject(pair.ob_cur_uv, pair.ob_cur_depth, fx, fy, cx, cy)
        obj_params = FlowBAParams(reproj_info=sol.reproj_info, prior_info=sol.obj_flow_prior_info,
                                  rp_thres=sol.obj_rp_thres, iters=sol.obj_lm_iters, tau=sol.lm_tau)
        r_patch = sol.zncc_patch_radius
        # (the JAX package also compacts a per-member ZNCC score that no solve
        # reads; XLA drops it as dead code, and so does this port)

        # compact each label's members into n_per_obj_max slots: a scatter into
        # an M+1 buffer whose last slot takes the dropped points
        M = cfg.padding.n_per_obj_max
        slots = torch.cumsum(member.to(torch.int64), -1) - 1
        tgt = torch.where(member & (slots < M), slots, torch.full_like(slots, M))
        payload = torch.cat([
            pair.ob_uv, pair.ob_flow, pair.ob_depth[..., None], pair.ob_cur_uv, Xp_w,
            xyz_cur_ob, pair.ob_patch,
        ], -1)                                                                     # (B, No, C)
        C = payload.shape[-1]
        No = payload.shape[1]
        buf = torch.zeros((B, K, M + 1, C), dtype=payload.dtype, device=dev)
        buf.scatter_(2, tgt[..., None].expand(B, K, No, C), payload[:, None].expand(B, K, No, C))
        buf = buf[:, :, :M]
        c_mask = torch.arange(M, device=dev) < member.sum(-1)[..., None]          # (B, K, M)
        P_len = pair.ob_patch.shape[-1]
        c_uv, c_flow, c_depth = buf[..., 0:2], buf[..., 2:4], buf[..., 4]
        c_cur_uv, c_Xp, c_xyz = buf[..., 5:7], buf[..., 7:10], buf[..., 10:13]
        c_patch = buf[..., 13:13 + P_len]

        K_s = cfg.padding.k_obj_solve or K
        if 0 < K_s < K:
            # solve only the top-K_s most populated ACTIVE labels; inactive
            # labels rank -1, and ties go to the lower slot as in lax.top_k
            top_idx = topk_stable(torch.where(active, count, torch.full_like(count, -1.0)), K_s)[1]
        else:
            K_s = K
            top_idx = torch.arange(K, device=dev).expand(B, K)

        def sel(x):
            return x[bidx[:, None], top_idx]

        S = sol.obj_ensemble_seeds if sol.obj_ensemble else 1
        BKS = B * K_s * S
        mode_lab = sel(mode_last).to(torch.int64).clamp(0, K)                     # (B, K_s)
        H_prev = ctx.H_prev_by_label[bidx[:, None], mode_lab]
        has_prev = ctx.H_prev_valid[bidx[:, None], mode_lab]
        MM = Tcw_cur[:, None] @ H_prev                                             # (B, K_s, 4, 4)

        def per_stream(x):
            """(B, K_s, ...) -> (B*K_s*S, ...): one row per RANSAC stream."""
            return x[:, :, None].expand((B, K_s, S) + x.shape[2:]).reshape((BKS,) + x.shape[2:])

        uv_o, flow_o, depth_o = (per_stream(sel(c_uv)), per_stream(sel(c_flow)),
                                 per_stream(sel(c_depth)))
        cur_uv_o, Xp_o, xyz_o = (per_stream(sel(c_cur_uv)), per_stream(sel(c_Xp)),
                                 per_stream(sel(c_xyz)))
        memb = per_stream(sel(c_mask))
        MM_s, has_prev_s = per_stream(MM), per_stream(has_prev)
        Twl_s = Twl[:, None, None].expand(B, K_s, S, 4, 4).reshape(BKS, 4, 4)

        # the slots' names need top_idx on the host: built only if the sampler asks
        sites = ransac.Sites(n=BKS, build=lambda: [
            (int(pair_ids[b]), "obj", slot, s if sol.obj_ensemble else None)
            for b, row in enumerate(top_idx.tolist()) for slot in row for s in range(S)
        ])
        r_sub = _strided(M, sol.obj_ransac_score_pts)
        rrk = ransac.ransac_rigid_pose(
            Xp_o[:, r_sub], cur_uv_o[:, r_sub], xyz_o[:, r_sub], memb[:, r_sub],
            fx, fy, cx, cy, sampler=sampler, sites=sites,
            thresh=sol.obj_ransac_reproj_px, iters=sol.obj_ransac_iters,
            refine_iters=sol.refine_gn_iters,
        )
        if r_sub != slice(None):
            inl_f, n_f = ransac._count_inliers(rrk.T, Xp_o, cur_uv_o, memb,
                                               sol.obj_ransac_reproj_px, fx, fy, cx, cy)
            rrk = ransac.RansacResult(T=rrk.T, inliers=inl_f, n_inliers=n_f)
        inl_mm, n_mm = ransac._count_inliers(MM_s, Xp_o, cur_uv_o, memb,
                                             sol.obj_ransac_reproj_px, fx, fy, cx, cy)
        use_mm = has_prev_s & (n_mm >= rrk.n_inliers) & sol.obj_motion_model_init
        T_init = torch.where(use_mm[:, None, None], MM_s, rrk.T)
        subset = torch.where(use_mm[:, None], inl_mm, rrk.inliers)
        n_subset = subset.sum(-1)
        res = solve_flow_ba_auto(T_init, Twl_s, uv_o, flow_o, depth_o, subset,
                                 fx, fy, cx, cy, params=obj_params, backend=backend)
        for _ in range(sol.obj_reclassify_rounds):
            regate = memb & (res.chi2 <= sol.obj_rp_thres)
            res2 = solve_flow_ba_auto(res.T, Twl_s, uv_o, flow_o, depth_o, regate,
                                      fx, fy, cx, cy, params=obj_params, backend=backend)
            res = _where_res(regate.sum(-1) >= 10, res2, res)

        T_s = res.T.reshape(B, K_s, S, 4, 4)
        n_s = res.n_inliers.reshape(B, K_s, S)
        sub_s = subset.reshape(B, K_s, S, M)
        nsub_s = n_subset.reshape(B, K_s, S)
        if sol.obj_ensemble:
            # consensus pick: members that both photometrically register against
            # the last frame and agree with the measured stereo 3-D
            c_sub = _strided(M, sol.obj_consensus_pts)
            Xp_c, xyz_c = sel(c_Xp)[:, :, c_sub], sel(c_xyz)[:, :, c_sub]
            patch_c, memb_c = sel(c_patch)[:, :, c_sub], sel(c_mask)[:, :, c_sub]
            depth_c = sel(c_depth)[:, :, c_sub]
            Xc = se3.transform(T_s, Xp_c[:, :, None])                              # (B,K_s,S,Mc,3)
            uvp = camera.project(Xc, fx, fy, cx, cy)
            sp = photometric.zncc(patch_c[:, :, None],
                                  photometric.extract_patches(pair.cur_gray, uvp, r_patch))
            dd = Xc - xyz_c[:, :, None]
            d3 = torch.sqrt((dd * dd).sum(-1))
            gate = (0.1 + 0.002 * depth_c ** 2)[:, :, None]
            ok = ((sp > sol.obj_consensus_zncc) & (d3 < gate)
                  & (memb_c & (depth_c > 0))[:, :, None])
            best = torch.argmax(ok.sum(-1), -1)                                    # (B, K_s)
        else:
            best = torch.zeros((B, K_s), dtype=torch.int64, device=dev)
        pick = (bidx[:, None], torch.arange(K_s, device=dev)[None, :], best)
        best_T, best_n, subset_b, n_subset_b = T_s[pick], n_s[pick], sub_s[pick], nsub_s[pick]

        Pm = torch.where((n_subset_b >= 3)[..., None, None], best_T, eye4)
        H_s = Twc_cur[:, None] @ Pm
        sw = subset_b.to(torch.float32)
        cpre_s = ((sel(c_Xp) * sw[..., None]).sum(-2)
                  / torch.clamp(sw.sum(-1), min=1.0)[..., None])

        H_world = eye4.expand(B, K, 4, 4).clone()
        n_inl = torch.zeros((B, K), dtype=best_n.dtype, device=dev)
        centre_pre = torch.zeros((B, K, 3), device=dev)
        solved = torch.zeros((B, K), dtype=torch.bool, device=dev)
        H_world[bidx[:, None], top_idx] = H_s
        n_inl[bidx[:, None], top_idx] = best_n
        centre_pre[bidx[:, None], top_idx] = cpre_s
        # no host scalar
        solved[bidx[:, None], top_idx] = torch.ones_like(top_idx, dtype=torch.bool)
        active = active & solved

        # current-frame world centroid + bbox over all members
        centre3d = (mf @ Xc_w) / cnt1[..., None]
        big = 1e9
        bigt = torch.full_like(mf, big)
        u_min = torch.where(member, u[:, None], bigt).amin(-1) - 1.0
        u_max = torch.where(member, u[:, None], -bigt).amax(-1) + 1.0
        v_min = torch.where(member, v[:, None], bigt).amin(-1) - 1.0
        v_max = torch.where(member, v[:, None], -bigt).amax(-1) + 1.0
        bbox = torch.stack([u_min, v_min, u_max, v_max], -1)

    with span("finish"):
        # ---------------- per-point label map ----------------
        labels_b = labels[None].expand(B, K)
        lab_map = torch.full(pair.ob_valid.shape, -2, dtype=torch.int32, device=dev)
        lab_map = torch.where(pair.ob_valid & ~pt_ok, torch.full_like(lab_map, -1), lab_map)
        slot_vals = torch.where(active, labels_b,
                                torch.where(is_static, torch.zeros_like(labels_b),
                                            torch.full_like(labels_b, -1)))
        slot_of_label = torch.cat([torch.zeros_like(slot_vals[:, :1]), slot_vals], 1)  # (B, K+1)
        lab_idx = pair.ob_cur_label.to(torch.int64).clamp(0, K)
        lab_map = torch.where(pt_ok, torch.gather(slot_of_label, 1, lab_idx), lab_map)

    with span("gt_eval"):
        # ---------------- evaluation against the ground truth ----------------
        cam_rpe = metrics.camera_rpe(Tcw_cur, ctx.Tcw_last, pair.gt_cur.Tcw, pair.gt_last.Tcw)

        uv_gt = camera.project(se3.transform(pair.gt_cur.Tcw, Xw_st), fx, fy, cx, cy)
        d_gt = pair.st_cur_uv - uv_gt
        flow_hist = metrics.flow_error_histogram(torch.sqrt((d_gt * d_gt).sum(-1)), pair.st_valid)

        Twc_gt_last = se3.inverse(pair.gt_last.Tcw)
        Twc_gt_cur = se3.inverse(pair.gt_cur.Tcw)

        def gt_lookup(tab, Twc_gt, lab):
            """lab (B, L) -> (found (B, L), world pose Twc_gt @ L_cam (B, L, 4, 4))."""
            hit = tab.obj_valid[:, None, :] & (tab.obj_ids[:, None, :] == lab[..., None])
            idx = torch.argmax(hit.to(torch.int32), -1)
            L = tab.obj_L[bidx[:, None], idx]
            return hit.any(-1), Twc_gt[:, None] @ L

        ok_p, L_w_p = gt_lookup(pair.gt_last, Twc_gt_last, labels_b)
        ok_c, L_w_c = gt_lookup(pair.gt_cur, Twc_gt_cur, labels_b)
        H_gt = L_w_c @ se3.inverse(L_w_p)
        om = metrics.object_motion_error(H_world, H_gt, centre_pre,
                                         L_w_p[..., :3, 3], L_w_c[..., :3, 3])
        has_gt = ok_p & ok_c

        # GT-dynamic ids: objects posed in BOTH frames whose GT motion moves
        ok_pd, L_w_pd = gt_lookup(pair.gt_last, Twc_gt_last, pair.gt_cur.obj_ids)
        H_gt_d = (Twc_gt_cur[:, None] @ pair.gt_cur.obj_L) @ se3.inverse(L_w_pd)
        tgt_d = H_gt_d[..., :3, 3]
        gt_dyn = pair.gt_cur.obj_valid & ok_pd & (torch.sqrt((tgt_d * tgt_d).sum(-1)) > 0.05)
        seg_conf = metrics.segmentation_confusion(lab_map, pair.ob_cur_label,
                                                  pair.gt_cur.obj_ids, gt_dyn, pair.ob_valid)

    objects = ObjectOutputs(
        seen=seen, is_static=is_static, active=active,
        n_points=count.to(torch.int32), mode_last_label=mode_last,
        H=H_world, n_inliers=n_inl, centre3d=centre3d, centre_pre=centre_pre,
        bbox=bbox, speed_est=om.speed_est, speed_gt=om.speed_gt,
        t_rpe=om.t_abs, r_rpe=om.r_abs, t_rpe_rel=om.t_rel, r_rpe_rel=om.r_rel,
        speed_err_rel=om.speed_err_rel, t_rpe_centred=om.t_rel_centred, has_gt=has_gt,
    )
    return PairResult(
        Tcw_cur=Tcw_cur,
        cam_t_rpe=cam_rpe.t_abs, cam_r_rpe=cam_rpe.r_abs,
        cam_t_rpe_rel=cam_rpe.t_rel, cam_r_rpe_rel=cam_rpe.r_rel,
        n_static=n_st, n_static_inliers=cam_res.n_inliers,
        flow_hist=flow_hist, seg_confusion=seg_conf, objects=objects,
        obj_label_map=lab_map,
    )


def track_pair(
    pair: PairInputs,
    ctx: TrackContext,
    cfg: PipelineConfig,
    sampler: ransac.HypothesisSampler,
    pair_id: int = 0,
) -> PairResult:
    """One pair without the batch axis: ``track_pairs`` at B = 1."""
    res = track_pairs(tree_map(lambda x: x[None], pair), tree_map(lambda x: x[None], ctx),
                      cfg, sampler, [pair_id])
    return tree_map(lambda x: x[0], res)


def next_context(result: PairResult, prev: TrackContext, k_obj_max: int) -> TrackContext:
    """Fold a batch of pair results into the contexts for the next pairs:
    current per-label motions become the next motion models and the pair's
    relative motion the constant-velocity model."""
    B = result.Tcw_cur.shape[0]
    dev = result.Tcw_cur.device
    H_by = torch.eye(4, device=dev).expand(B, k_obj_max + 1, 4, 4).clone()
    H_by[:, 1:] = result.objects.H
    valid = torch.zeros((B, k_obj_max + 1), dtype=torch.bool, device=dev)
    valid[:, 1:] = result.objects.active
    return TrackContext(
        Tcw_last=result.Tcw_cur, H_prev_by_label=H_by, H_prev_valid=valid,
        T_velocity=result.Tcw_cur @ se3.inverse(prev.Tcw_last),
        velocity_valid=torch.ones((B,), dtype=torch.bool, device=dev),
    )


def _frame_observation(gray_u8, depth_w, flow_w, sem_w, gt, cfg: PipelineConfig,
                       generator: Optional[torch.Generator] = None):
    """One frame's wire tensors (no batch axis) -> (decoded depth image,
    decoded labels, gray, unbatched FrameObservation)."""
    from multimot_track_tpu_torch.ops import wire
    from multimot_track_tpu_torch.pipeline import frames as F

    cam = cfg.camera
    gray = gray_u8.to(torch.float32)[None]
    depth_raw = wire._decode_depth(depth_w[None], cam.width)
    sem = wire._decode_sem(sem_w[None], cam.width)
    flow = wire._decode_flow(flow_w[None], cam.height, cam.width)
    obs = F.build_frame_observation(gray, depth_raw, flow, sem,
                                    tree_map(lambda x: x[None], gt), cfg, generator=generator)
    return depth_raw, sem, gray, obs


def first_step(gray_u8, depth_w, flow_w, sem_w, gt, cfg: PipelineConfig,
               generator: Optional[torch.Generator] = None):
    """Frame 0: the frontend only.  Wire tensors of one frame and its
    unbatched GTTable -> the unbatched FrameObservation."""
    obs = _frame_observation(gray_u8, depth_w, flow_w, sem_w, gt, cfg, generator)[3]
    return tree_map(lambda x: x[0], obs)


def full_step(sampler: ransac.HypothesisSampler, pair_id: int, prev_obs, gray_u8, depth_w,
              flow_w, sem_w, gt_cur, ctx: TrackContext, cfg: PipelineConfig,
              generator: Optional[torch.Generator] = None, tape: Optional[StepTape] = None):
    """One frame of the live loop: frontend, pair build and ``track_pair``
    at B = 1 against the previous frame's observation.  ``pair_id`` names
    the pair for the hypothesis sampler (the live system passes the frame
    index).  ``tape``: the caller's recorded step, replayed where it
    engages (``step_graph``); the frame counts ``replayed`` 1 if it was, 0
    if the step ran eagerly.  Returns (PairResult, next TrackContext, this
    FrameObservation), all without the batch axis, owned by the caller."""
    from multimot_track_tpu_torch.pipeline import frames as F

    noise = generator if (cfg.solver.depth_noise or cfg.solver.flow_outliers) else None

    def step(prev_obs, gray_u8, depth_w, flow_w, sem_w, gt_cur, ctx):
        with span("frontend"):
            depth_raw, sem, gray, obs = _frame_observation(gray_u8, depth_w, flow_w, sem_w,
                                                           gt_cur, cfg, noise)
            pair = F.build_pair(tree_map(lambda x: x[None], prev_obs), depth_raw, sem, obs.gt,
                                cfg, cur_gray=gray)
        ctx_b = tree_map(lambda x: x[None], ctx)
        res = track_pairs(pair, ctx_b, cfg, sampler, [pair_id])
        with span("finish"):
            new_ctx = next_context(res, ctx_b, cfg.padding.k_obj_max)
            first = lambda x: x[0]
            return tree_map(first, res), tree_map(first, new_ctx), tree_map(first, obs)

    inputs = (prev_obs, gray_u8, depth_w, flow_w, sem_w, gt_cur, ctx)
    out = tape.run(step, inputs, sampler, noise, cfg) if tape is not None else None
    count("replayed", int(out is not None))
    return out if out is not None else step(*inputs)
