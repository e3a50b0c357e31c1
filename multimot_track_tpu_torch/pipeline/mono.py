"""Monocular ego-only visual odometry with the full backend ladder.

Port of ``multimot_track_tpu.pipeline.mono`` (the reference's mono drivers,
Examples/Monocular/mono_kitti.cc, with MonocularInitialization /
CreateInitialMapMonocular, src/Tracking.cc:2583-2830).  Per frame, on
``device``: FAST + ORB on the gray image (keypoints undistorted for the
geometry only); until initialised, the H/F two-view bootstrap against the
previous frame (up to scale, median scene depth normalised to 1);
afterwards the map points projected under the constant-velocity
prediction and matched by descriptor within 18 px (kernel K2 on the
card), RANSAC PnP, the global-match PnP as the fallback rung, then the
backend ladder (relocalization when LOST, TrackLocalMap against the
newest keyframes through K2 with its three gates), re-triangulation and
keyframe insertion with ``fix_scale=False`` Sim3 loop closing.  The scale
bookkeeping and the map's slot arrays stay on the host, as in the JAX
package.

Random draws come from a ``ransac.HypothesisSampler`` at the sites
``(frame, "mono_F")`` / ``(frame, "mono_H")`` (the initializer),
``(frame, "pnp")``, ``(frame, "pnp_fallback")``, ``(frame, "reloc")`` and
``(frame, "sim3")``; the JAX package draws them from
``fold_in(PRNGKey(seed), frame)`` (and ``fold_in`` of that with 1 for the
fallback).

Two defects of the JAX tracker are kept so that both packages agree:
the persistence channels write map points without a one-point-per-keypoint
gate (``mono.py:266``), and the velocity model is not reset on a LOST
frame (``mono.py:230``).
"""

from __future__ import annotations

import dataclasses
from typing import List, Optional

import numpy as np
import torch

from multimot_track_tpu_torch.config import DEFAULT_CONFIG, PipelineConfig
from multimot_track_tpu_torch.frontend import fast, orb
from multimot_track_tpu_torch.geometry import camera
from multimot_track_tpu_torch.io.frame import check_frame_size
from multimot_track_tpu_torch.ops import matching
from multimot_track_tpu_torch.pipeline.keyframes import Keyframe, KeyframeStore
from multimot_track_tpu_torch.solvers import pnp
from multimot_track_tpu_torch.solvers.initializer import initialize_mono, triangulate
from multimot_track_tpu_torch.solvers.ransac import HypothesisSampler, MultinomialSampler


@dataclasses.dataclass
class MonoState:
    uv: np.ndarray            # (N, 2) keypoints of the last frame
    desc: np.ndarray          # (N, 256) int8 sign form
    valid: np.ndarray         # (N,)
    Xw: Optional[np.ndarray]  # (N, 3) world points (None until bootstrap)
    Xw_valid: Optional[np.ndarray]
    Tcw: np.ndarray           # (4, 4)
    feats: tuple              # (uv, desc, valid) of the frame as device tensors


class MonoTracker:
    """Monocular tracker with the backend ladder (the reference's mono
    examples inherit the whole ORB-SLAM2 backend, src/System.cc:34-116):
    keyframes in a sensor-agnostic ``KeyframeStore``, per-frame local-map
    refinement (pure reprojection Gauss-Newton: the disparity rows switch
    themselves off at z = 0), relocalization on PnP failure, and
    ``fix_scale=False`` Sim3 loop closing that measures and redistributes
    the monocular scale drift (src/LoopClosing.cc:233 mbFixScale).

    ``device``: where the per-frame work runs (the card by default; without
    one the constructor raises, and ``device="cpu"`` runs on the CPU).
    ``sampler``: the hypothesis sampler (default: multinomial draws from a
    generator seeded with ``seed``).  ``match_backend``: K2's route
    (``"auto" | "cuda" | "torch"``) for the tracked-mode match and
    TrackLocalMap."""

    def __init__(self, cfg: PipelineConfig = DEFAULT_CONFIG, n_kp: int = 1024,
                 seed: int = 0, enable_backend: bool = True,
                 keyframe_gap: int = 5, loop_min_matches: int = 40,
                 loop_min_kf_separation: int = 3, device="cuda",
                 sampler: Optional[HypothesisSampler] = None,
                 match_backend: str = "auto"):
        self.device = torch.device(device)
        if self.device.type == "cuda" and not torch.cuda.is_available():
            raise RuntimeError("MonoTracker runs on the card by default and found no "
                               "CUDA device; pass device='cpu' to run on the CPU")
        if self.device.type == "cuda":
            # exact float32 products (Hamming distances, BRIEF's blur)
            torch.backends.cuda.matmul.allow_tf32 = False
            torch.backends.cudnn.allow_tf32 = False
        self.cfg = cfg
        self.n_kp = n_kp
        self.sampler = sampler or MultinomialSampler(
            torch.Generator(device=self.device).manual_seed(seed))
        self.match_backend = match_backend
        self.state: Optional[MonoState] = None
        self.poses: List[np.ndarray] = []     # Tcw per frame
        self.initialized = False
        self.init_frame: Optional[int] = None
        self._frame = 0
        self.loop_events: List[tuple] = []    # (frame, keyframe frame, inliers, scale)
        self.n_relocalizations = 0
        self.relocalized_frames: List[int] = []
        self.n_lost_frames = 0
        self.lost_frames: List[int] = []
        self.lm_accepted_frames: List[int] = []   # TrackLocalMap refinements applied
        # constant-velocity motion model (TrackWithMotionModel,
        # src/Tracking.cc): per-frame relative Tcw, identity until tracked
        self._velocity = np.eye(4, dtype=np.float32)
        self.loop_min_matches = loop_min_matches
        self.loop_min_kf_separation = loop_min_kf_separation
        self.keyframes = (
            KeyframeStore(capacity=cfg.backend.kf_capacity, min_gap=keyframe_gap,
                          device=self.device, match_backend=match_backend)
            if enable_backend else None
        )

    def _dev(self, arr) -> torch.Tensor:
        """A fresh (contiguous, aligned) device copy of a host array."""
        return torch.from_numpy(np.ascontiguousarray(arr)).to(self.device)

    def _frontend(self, gray: np.ndarray):
        """(uv, desc, valid) device tensors of one frame.  Descriptors are
        taken on the raw (distorted) image at the detected pixel and only
        the geometry coordinate is undistorted: the reference's mvKeys /
        mvKeysUn split (Frame::UndistortKeyPoints, src/Frame.cc:787-811)."""
        g = self._dev(np.asarray(gray, np.float32))
        fe = self.cfg.frontend
        # the pyramid accumulated in float64: the card detects the corners the
        # CPU does, and the bootstrap's PnP is sensitive to a changed corner
        kp = fast.detect_pyramid(g[None], threshold=float(fe.fast_threshold),
                                 min_threshold=float(fe.fast_min_threshold), n_levels=4,
                                 n_total=self.n_kp, accumulate=torch.float64)
        uv, valid = kp.uv[0].contiguous(), kp.valid[0].contiguous()
        desc, _ = orb.describe(g, uv)
        cam = self.cfg.camera
        if cam.has_distortion:
            uv = camera.undistort_points(uv, cam.fx, cam.fy, cam.cx, cam.cy,
                                         cam.k1, cam.k2, cam.p1, cam.p2, cam.k3)
        return uv.contiguous(), desc.contiguous(), valid

    def track(self, gray: np.ndarray) -> np.ndarray:
        """Feed a frame; returns the current Tcw estimate.  Raises
        ``ValueError`` for a frame whose size is not the camera config's."""
        cam = self.cfg.camera
        check_frame_size(cam, self._frame, gray=gray)
        fx, fy, cx, cy = cam.fx, cam.fy, cam.cx, cam.cy
        feats = self._frontend(gray)
        uv_d, desc_d, valid_d = feats
        uv = uv_d.cpu().numpy()
        desc = desc_d.cpu().numpy()
        valid = valid_d.cpu().numpy()
        frame = self._frame
        self._frame += 1

        if self.state is None:
            self.state = MonoState(uv, desc, valid, None, None, np.eye(4, dtype=np.float32),
                                   feats)
            self.poses.append(np.eye(4, dtype=np.float32))
            return self.poses[-1]

        st = self.state
        m = matching.match_descriptors(st.feats[1], desc_d, st.feats[2], valid_d)
        idx = m.idx.cpu().numpy()
        uv_prev = st.uv
        uv_cur = uv[idx]
        mvalid = m.valid.cpu().numpy()

        if not self.initialized:
            res = initialize_mono(st.feats[0], uv_d[m.idx], m.valid, fx, fy, cx, cy,
                                  sampler=self.sampler, frame=frame)
            if not bool(res.ok):
                # keep waiting for enough parallax (the reference re-tries too)
                self.state = MonoState(uv, desc, valid, None, None, st.Tcw, feats)
                self.poses.append(st.Tcw)
                return st.Tcw
            self.initialized = True
            self.init_frame = frame
            T21 = res.T21.cpu().numpy().copy()
            # normalise scale: median scene depth = 1 (the reference scales
            # the initial map by its median depth, Tracking.cc CreateInitialMap)
            X = res.points3d.cpu().numpy()
            inl = res.inliers.cpu().numpy()
            med = np.median(X[inl, 2]) if inl.any() else 1.0
            X = X / max(med, 1e-6)
            T21[:3, 3] /= max(med, 1e-6)
            Tcw = T21 @ st.Tcw
            # world points ride the CURRENT frame's keypoint slots
            Xw_cur = np.zeros((self.n_kp, 3), np.float32)
            Xw_vld = np.zeros(self.n_kp, bool)
            Xw_cur[idx[inl]] = X[inl]
            Xw_vld[idx[inl]] = True
            self.state = MonoState(uv, desc, valid, Xw_cur, Xw_vld, Tcw, feats)
            self.poses.append(Tcw.astype(np.float32))
            return self.poses[-1]

        # --- tracked mode: motion-model projected matching, then PnP ---
        # the map points projected under the constant-velocity prediction
        # and matched by descriptor within a radius (TrackWithMotionModel /
        # SearchByProjection, src/ORBmatcher.cc:1342): the 3D-2D count does
        # not depend on which slots survive detection churn.  Global
        # descriptor PnP stays as the fallback rung.
        Xw_prev = st.Xw[np.arange(len(uv_prev))]
        Tcw_pred = (self._velocity @ st.Tcw).astype(np.float32)
        Xc = (Tcw_pred[:3, :3] @ Xw_prev.T).T + Tcw_pred[:3, 3]
        z_pred = Xc[:, 2]
        with np.errstate(divide="ignore", invalid="ignore"):
            uv_pred = np.stack(
                [fx * Xc[:, 0] / z_pred + cx, fy * Xc[:, 1] / z_pred + cy], -1
            ).astype(np.float32)
        proj_valid = st.Xw_valid & (z_pred > 1e-6) & np.isfinite(uv_pred).all(1)
        mp = matching.match_projected_auto(
            st.feats[1], self._dev(uv_pred), self._dev(proj_valid), desc_d, uv_d, valid_d,
            radius=18.0, backend=self.match_backend,
        )
        mp_idx = mp.idx.cpu().numpy()
        mp_valid = mp.valid.cpu().numpy() & st.Xw_valid
        Xw_prev_d = self._dev(Xw_prev)
        sol = pnp.ransac_pnp(Xw_prev_d, uv_d[mp.idx], self._dev(mp_valid), fx, fy, cx, cy,
                             sampler=self.sampler, site=(frame, "pnp"))
        Tcw = sol.T.cpu().numpy()
        lost = int(sol.n_inliers) < 12
        if lost:
            # fallback rung: global descriptor matches (no prediction)
            sol2 = pnp.ransac_pnp(Xw_prev_d, uv_d[m.idx], self._dev(mvalid & st.Xw_valid),
                                  fx, fy, cx, cy, sampler=self.sampler,
                                  site=(frame, "pnp_fallback"))
            if int(sol2.n_inliers) > int(sol.n_inliers):
                sol = sol2
                Tcw = sol.T.cpu().numpy()
                lost = int(sol.n_inliers) < 12
        if lost:
            Tcw = st.Tcw   # LOST: constant pose
        # --- backend ladder (src/System.cc:34-116): relocalize when LOST,
        # refine against the map ---
        if self.keyframes is not None and self.keyframes.frames:
            if lost:
                T_reloc = self.keyframes.relocalize(self.sampler, (frame, "reloc"), desc_d,
                                                    uv_d, valid_d, fx, fy, cx, cy)
                if T_reloc is not None and np.isfinite(T_reloc).all():
                    Tcw = np.asarray(T_reloc, np.float32)
                    self.n_relocalizations += 1
                    self.relocalized_frames.append(frame)
                    lost = False
            if not lost:
                T_lm = self._track_local_map(Tcw, feats)
                if T_lm is not None:
                    Tcw = T_lm
                    self.lm_accepted_frames.append(frame)
        if lost:
            # keep the last good state untouched: the next frame matches
            # against the last tracked frame and its intact map
            # (triangulating at zero baseline would write garbage points;
            # the reference creates no map points without tracked motion,
            # src/LocalMapping.cc CreateNewMapPoints)
            self.n_lost_frames += 1
            self.lost_frames.append(frame)
            self.poses.append(st.Tcw.astype(np.float32))
            return self.poses[-1]
        # re-triangulate matched pairs for the next frame's structure
        Kmat = np.asarray([[fx, 0, cx], [0, fy, cy], [0, 0, 1]], np.float32)
        P1 = Kmat @ np.asarray(st.Tcw)[:3]
        P2 = Kmat @ Tcw[:3]
        X_new = triangulate(self._dev(P1), self._dev(P2), st.feats[0],
                            uv_d[m.idx]).cpu().numpy()
        # cheirality + match gating
        z1 = (np.asarray(st.Tcw)[:3, :3] @ X_new.T).T[:, 2] + np.asarray(st.Tcw)[2, 3]
        z2 = (Tcw[:3, :3] @ X_new.T).T[:, 2] + Tcw[2, 3]
        baseline = float(np.linalg.norm(
            np.linalg.inv(Tcw)[:3, 3] - np.linalg.inv(np.asarray(st.Tcw))[:3, 3]))
        good = (mvalid & (z1 > 0) & (z2 > 0) & np.isfinite(X_new).all(1)
                & (baseline > 1e-6))
        Xw_cur = np.zeros((self.n_kp, 3), np.float32)
        Xw_vld = np.zeros(self.n_kp, bool)
        Xw_cur[idx[good]] = X_new[good]
        Xw_vld[idx[good]] = True
        # existing map points persist across frames (the reference's
        # MapPoints live until culled, src/MapPoint.cc): re-triangulating
        # tracked points every frame lets the scale drift.  Both channels
        # carry points forward, the global descriptor matches and the
        # projection-guided ones, with no one-point-per-slot gate (as the
        # JAX package writes them)
        persist = mvalid & st.Xw_valid
        Xw_cur[idx[persist]] = Xw_prev[persist]
        Xw_vld[idx[persist]] = True
        Xw_cur[mp_idx[mp_valid]] = Xw_prev[mp_valid]
        Xw_vld[mp_idx[mp_valid]] = True
        self._velocity = (Tcw @ np.linalg.inv(st.Tcw)).astype(np.float32)
        self.state = MonoState(uv, desc, valid, Xw_cur, Xw_vld, Tcw.astype(np.float32), feats)
        self.poses.append(Tcw.astype(np.float32))
        if self.keyframes is not None:
            self._maybe_keyframe_and_close_loop(feats, uv, desc, valid, Xw_cur, Xw_vld,
                                                Tcw.astype(np.float32), frame)
        return self.poses[-1]

    # ------------------------------------------------------------------
    def _track_local_map(self, Tcw, feats, min_inliers: int = 20, max_corr: float = 0.35,
                         max_rot_deg: float = 2.0) -> Optional[np.ndarray]:
        """TrackLocalMap for mono: pure reprojection Gauss-Newton against the
        newest keyframes' triangulated points (z_cur = 0 switches the
        disparity rows off, so the map's own scale anchors the pose: the
        mechanism that slows scale drift between loop closures).  Applied
        only with ``min_inliers``, a finite pose and a correction within
        ``max_corr`` and ``max_rot_deg``."""
        cam = self.cfg.camera
        uv_d, desc_d, valid_d = feats
        T, n_inl, _ = self.keyframes.track_local_map(
            np.asarray(Tcw, np.float32), uv_d, desc_d, valid_d,
            torch.zeros(uv_d.shape[0], dtype=torch.float32, device=self.device),
            cam.fx, cam.fy, cam.cx, cam.cy, cam.width, cam.height, max(cam.bf, 1.0),
        )
        if n_inl < min_inliers or not np.isfinite(T).all():
            return None
        d = T @ np.linalg.inv(Tcw)
        if np.linalg.norm(d[:3, 3]) > max_corr:
            return None
        ang = np.degrees(np.arccos(np.clip((np.trace(d[:3, :3]) - 1.0) / 2.0, -1.0, 1.0)))
        if ang > max_rot_deg:
            return None
        return T.astype(np.float32)

    def _maybe_keyframe_and_close_loop(self, feats, uv, desc, valid, Xw, Xw_vld, Tcw,
                                       frame: int):
        cam = self.cfg.camera
        row = len(self.poses) - 1
        kf = Keyframe(index=row, Tcw=Tcw.copy(), uv=uv.astype(np.float32).copy(),
                      desc=np.asarray(desc).copy(), valid=np.asarray(valid).copy(),
                      Xw=np.asarray(Xw, np.float32).copy())
        # only triangulated points are 3-D consumers (local map, reloc, Sim3)
        kf.live = np.asarray(valid & Xw_vld)
        kf.bad = ~kf.live       # untriangulated: geometry untrustworthy
        if not self.keyframes.maybe_add(kf):
            return
        if len(self.keyframes.frames) < 4:
            return
        cand = self.keyframes.detect_loop(feats[1], feats[2], min_matches=self.loop_min_matches)
        if cand is None:
            return
        if len(self.keyframes.frames) - 1 - cand < self.loop_min_kf_separation:
            return
        traj = np.stack(self.poses).astype(np.float32)
        info = {}
        corrected, n = self.keyframes.close_loop(
            self.sampler, (frame, "sim3"), kf, cand, traj,
            [k.index for k in self.keyframes.frames], cam.fx, cam.fy, cam.cx, cam.cy,
            fix_scale=False, info=info,
        )
        if n == 0:
            return
        corrected = np.asarray(corrected)
        row_scale = info.get("row_scale", np.ones(len(corrected)))
        # re-anchor keyframe structure: camera-frame geometry is rescaled by
        # the row's cumulative drift correction, then moved with the
        # corrected pose (the mono version of CorrectLoop's map update)
        for k in self.keyframes.frames:
            c = float(row_scale[k.index])
            Xc = (k.Tcw[:3, :3] @ k.Xw.T).T + k.Tcw[:3, 3]
            Twc_new = np.linalg.inv(corrected[k.index])
            k.Xw = ((Twc_new[:3, :3] @ (c * Xc).T).T + Twc_new[:3, 3]).astype(np.float32)
            k.Tcw = corrected[k.index].astype(np.float32)
        self.keyframes._version += 1
        # the live tracker state follows the newest row's correction
        st = self.state
        c = float(row_scale[-1])
        Xc = (st.Tcw[:3, :3] @ st.Xw.T).T + st.Tcw[:3, 3]
        Twc_new = np.linalg.inv(corrected[-1])
        st.Xw = ((Twc_new[:3, :3] @ (c * Xc).T).T + Twc_new[:3, 3]).astype(np.float32)
        st.Tcw = corrected[-1].astype(np.float32)
        self.poses = [corrected[i].astype(np.float32) for i in range(len(corrected))]
        self.loop_events.append((row, self.keyframes.frames[cand].index, n,
                                 info.get("scale", 1.0)))
