"""The live RGB-D system: host orchestration of the per-frame device work.

Port of ``multimot_track_tpu.pipeline.system`` for the live path with
keyframes, fused TrackLocalMap, the trailing-window BA, map-point fusion
and culling, keyframe culling, the joint ego+object window BA,
relocalization on LOST and loop closing, in the synchronous and the
pipelined (one-frame-latency, async keyframe cadence) modes, with given
instance masks or with masks discovered from motion alone:

* per frame, ``tracker.full_step`` (frontend, pair build, ego and object
  solves; on the card replayed from the system's recorded CUDA graphs,
  ``pipeline/step_graph``) and the frame's FAST + ORB + depth features run
  on ``device``;
  the local-map refinement and its gates, then the trailing-window BA
  over the last ``window_size`` frames, follow on the device
  (``live_refine``), and the host reads the result once;
* the host keeps the tracking-state machine (LOST ladder: relocalization,
  constant-velocity fallback, reset), persistent track IDs, the evaluation
  stores and the trajectory savers;
* keyframe upkeep (capture, fuse scan, found-ratio culling, redundancy
  culling, the joint window BA) runs at keyframe cadence, synchronously or
  dispatched one frame ahead of its consumption;
* after a keyframe is added (or, pipelined, when its cadence is consumed)
  the loop ladder runs: place recognition, the consistency gate, Sim3
  RANSAC, the pose-graph correction of the whole trajectory and the global
  BA over the keyframe graph (``_maybe_close_loop``);
* the window's wire tensors stay on the device (``_win``), so the window
  refinements re-read the frames without another upload;
* mask-free mode (``discover_objects``): from frame 2 on, the frame's
  instance mask is synthesised on the device from the previous window
  entry's depth and flow and the constant-velocity ego motion
  (``motion_seg``), its connected components cut on the host.

Random draws: RANSAC, PnP and Sim3 hypotheses come from a
``ransac.HypothesisSampler`` with ``pair_id = frame_idx`` (the JAX package
folds the frame index into its key; the loop ladder draws at its
keyframe's frame; discovery at ``(frame_idx, "discover")``), and depth /
flow noise from a ``torch.Generator``.
"""

from __future__ import annotations

import dataclasses
import time
from typing import Dict, List, Optional

import numpy as np
import torch

from multimot_track_tpu_torch import state
from multimot_track_tpu_torch.config import DEFAULT_CONFIG, PipelineConfig
from multimot_track_tpu_torch.eval import metrics
from multimot_track_tpu_torch.frontend import fast, orb
from multimot_track_tpu_torch.geometry import camera as cam_g
from multimot_track_tpu_torch.io.frame import FrameData, check_frame
from multimot_track_tpu_torch.ops import wire
from multimot_track_tpu_torch.pipeline import frames as F
from multimot_track_tpu_torch.pipeline import motion_seg
from multimot_track_tpu_torch.pipeline import tracker
from multimot_track_tpu_torch.pipeline.keyframes import (
    Keyframe, KeyframeStore, _adjacent_match_counts, _batched_match_counts,
)
from multimot_track_tpu_torch.pipeline.live_refine import live_refine_step
from multimot_track_tpu_torch.solvers.ransac import HypothesisSampler, MultinomialSampler
from multimot_track_tpu_torch.utils.profiling import _StageCtx, count, span


def _describe_frame_device(gray_u8: torch.Tensor, depth_w: torch.Tensor, bf: float,
                           width: int):
    """Keyframe-grade features of one frame on its device: FAST (4 levels,
    1024 points) + ORB descriptors + per-keypoint depth.  Returns
    (uv, desc, valid, z)."""
    g = gray_u8.to(torch.float32)
    kp = fast.detect_pyramid(g[None], n_levels=4, n_total=1024)
    uv, kp_valid = kp.uv[0], kp.valid[0]
    desc, _ = orb.describe(g, uv)
    depth = cam_g.disparity_png_to_depth(wire._decode_depth(depth_w, width), bf)
    z = cam_g.nearest_sample(depth[None], uv[None])[0][0]
    valid = kp_valid & (z > 0) & (z < 60.0)
    # zero-disparity pixels carry +inf depth: keep them invalid and finite
    z = torch.where(torch.isfinite(z), z, torch.zeros_like(z))
    return uv, desc, valid, z


def _keyframe_payload(uv, desc, valid, z, Twc, fx, fy, cx, cy):
    """Keyframe capture: world points on the device, and everything but the
    descriptors in one f32 buffer [uv, Xw, valid] (``_split_payload``
    reads it).  Returns (desc, f32)."""
    Xc = cam_g.backproject(uv, z, fx, fy, cx, cy)
    Xw = (Twc[:3, :3] @ Xc.T).T + Twc[:3, 3]
    f32 = torch.cat([uv.reshape(-1), Xw.reshape(-1), valid.to(torch.float32)])
    return desc, f32


def _split_payload(f32, n: int):
    """(uv (n, 2), Xw (n, 3), valid (n,)) views of a payload buffer."""
    return f32[: 2 * n].reshape(n, 2), f32[2 * n: 5 * n].reshape(n, 3), f32[5 * n:] > 0.5


def joint_motion_init(obj_records, rows, poses_rel: np.ndarray, K: int):
    """Object motions that start the joint window BA: the P_lc of the
    record of (pair f's second frame ``rows[f + 1]``, label k + 1),
    re-anchored in the window's frame (``poses_rel`` (W, 4, 4), Tcw relative
    to window frame 0).  Returns (H_init (W-1, K, 4, 4), H_valid (W-1, K),
    {(pair, slot): record index})."""
    Wn = len(rows)
    H_init = np.tile(np.eye(4, dtype=np.float32), (Wn - 1, K, 1, 1))
    H_valid = np.zeros((Wn - 1, K), bool)
    rec_idx = {(rec.frame, rec.sem_label): i for i, rec in enumerate(obj_records)}
    used = {}
    for f in range(Wn - 1):
        for k in range(K):
            i = rec_idx.get((rows[f + 1], k + 1))
            if i is None or obj_records[i].P_lc is None:
                continue
            H_init[f, k] = np.linalg.inv(poses_rel[f + 1]) @ obj_records[i].P_lc @ poses_rel[f]
            H_valid[f, k] = True
            used[(f, k)] = i
    return H_init, H_valid, used


@dataclasses.dataclass
class ObjectRecord:
    frame: int
    track_id: int
    sem_label: int
    H: np.ndarray              # (4, 4) world-frame motion
    speed_est: float
    speed_gt: float
    t_rpe: float
    r_rpe: float
    t_rpe_rel: float
    r_rpe_rel: float
    speed_err_rel: float
    t_rpe_centred: float
    n_points: int
    n_inliers: int
    centre3d: np.ndarray
    bbox: np.ndarray
    has_gt: bool
    # camera-independent decomposition: P_lc maps last-camera coordinates
    # of an object point to its current-camera position; centre_pre_lc is
    # the solved members' centroid in last-camera coordinates
    P_lc: np.ndarray = None
    centre_pre_lc: np.ndarray = None


@dataclasses.dataclass
class MapState:
    """Evaluation stores (the reference's Map)."""

    camera_poses: List[np.ndarray] = dataclasses.field(default_factory=list)      # Twc
    camera_poses_raw: List[np.ndarray] = dataclasses.field(default_factory=list)  # pre-refine
    gt_poses: List[np.ndarray] = dataclasses.field(default_factory=list)
    gt_objs: List[dict] = dataclasses.field(default_factory=list)
    timestamps: List[float] = dataclasses.field(default_factory=list)
    cam_rpe_abs: List[np.ndarray] = dataclasses.field(default_factory=list)
    cam_rpe_rel: List[np.ndarray] = dataclasses.field(default_factory=list)
    obj_records: List[ObjectRecord] = dataclasses.field(default_factory=list)
    tot_obj_num: List[int] = dataclasses.field(default_factory=list)
    flow_hists: List[np.ndarray] = dataclasses.field(default_factory=list)
    frame_times: List[float] = dataclasses.field(default_factory=list)
    loop_events: List[tuple] = dataclasses.field(default_factory=list)


def _to_device(tree, device):
    return F.tree_map(lambda x: torch.from_numpy(np.array(x)).to(device), tree)


class MultiMotSystem:
    """End-to-end RGB-D multi-motion tracking (the reference's TrackRGBD).

    A pair whose ego solve keeps fewer than ``min_inliers`` inliers is LOST:
    relocalization against the keyframes is tried, else the pose falls back
    to the constant-velocity model; a LOST streak longer than
    ``max_lost_frames`` resets the track IDs.

    Loop closing (on by default with keyframes): a candidate must be at
    least ``loop_min_kf_separation`` keyframes old, score
    ``loop_min_matches`` descriptor matches, and be named by
    ``loop_consistency`` of the newest ``loop_consistency + 1`` keyframes.

    ``discover_objects``: synthesise the instance masks from motion instead
    of reading them (the frames' own masks are ignored from frame 2 on);
    it turns on the scene-flow reclassification of the static set
    (``sf_cam_gate = 0.35``) unless the caller set a gate.

    ``device``: where the per-frame work runs.  ``sampler``: the hypothesis
    sampler (default: multinomial draws from a generator seeded with
    ``seed``).  The flow-BA route is ``cfg.solver.flow_ba_backend``;
    ``match_backend``: the projected matcher's route (``"auto" | "cuda" |
    "torch"``).
    """

    STATE_OK = "OK"
    STATE_LOST = "LOST"

    def __init__(self, cfg: PipelineConfig = DEFAULT_CONFIG, seed: int = 0,
                 min_inliers: int = 10, max_lost_frames: int = 5,
                 enable_keyframes: bool = True, keyframe_gap: int = 5,
                 enable_loop_closing: bool = True, loop_min_matches: int = 40,
                 loop_min_kf_separation: int = 3, loop_consistency: int = 3,
                 discover_objects: bool = False, pipelined: bool = False,
                 device="cuda", sampler: Optional[HypothesisSampler] = None,
                 match_backend: str = "auto"):
        be = cfg.backend
        if pipelined and not be.fused_refine:
            raise ValueError("pipelined mode requires backend.fused_refine")
        # unmasked movers contaminate the static set, so mask-free mode
        # needs the scene-flow reclassification pass
        self.discover_objects = discover_objects
        if discover_objects and cfg.solver.sf_cam_gate == 0.0:
            cfg = dataclasses.replace(cfg, solver=dataclasses.replace(cfg.solver,
                                                                      sf_cam_gate=0.35))
        self.cfg = cfg
        self.seed = seed
        self.device = torch.device(device)
        if self.device.type == "cuda" and not torch.cuda.is_available():
            raise RuntimeError("MultiMotSystem runs on the card by default and found no "
                               "CUDA device; pass device='cpu' to run on the CPU")
        if self.device.type == "cuda":
            # exact float32 products and convolutions (BRIEF compares blurred values)
            torch.backends.cuda.matmul.allow_tf32 = False
            torch.backends.cudnn.allow_tf32 = False
        self.sampler = sampler or MultinomialSampler(
            torch.Generator(device=self.device).manual_seed(seed))
        self._noise_gen = torch.Generator(device=self.device).manual_seed(seed + 1)
        self.match_backend = match_backend
        # one-frame-latency serving: track_rgbd returns frame k-1's result;
        # the device odometry chain runs uncorrected and host refinements
        # ride the cumulative right-factor self._corr
        self.pipelined = pipelined
        self._pending = None
        self._flush_buffer: List = []   # results drained by an auto-flush, not yet returned
        self._kf_async = None           # deferred keyframe-cadence bundle
        self._last_kf_index = None
        self._corr = np.eye(4, dtype=np.float32)
        self.map = MapState()
        self._last_obs = None
        self._ctx: Optional[tracker.TrackContext] = None
        # the pair step's recorded CUDA graphs (``step_graph``), replayed
        # where they engage; ``reset`` drops them
        self._step_tape = tracker.StepTape()
        self._frame_idx = 0
        self._sem_to_track: Dict[int, int] = {}
        self._next_track_id = 1
        self.state = self.STATE_OK
        self.min_inliers = min_inliers
        self.max_lost_frames = max_lost_frames
        self._lost_streak = 0
        self._velocity = np.eye(4, dtype=np.float32)
        # host mirror of ctx.Tcw_last (the previous frame's final pose)
        self._Tcw_last_h = np.eye(4, dtype=np.float32)
        self._feat_cache = None         # (frame_idx, features): one extraction per frame
        self._dev_images = None         # (frame_idx, gray, depth) device tensors
        self.enable_keyframes = enable_keyframes
        self.enable_loop_closing = enable_loop_closing and enable_keyframes
        self.loop_min_matches = loop_min_matches
        self.loop_min_kf_separation = loop_min_kf_separation
        self.loop_consistency = loop_consistency
        self._loop_history: List[Optional[int]] = []   # candidate frame per keyframe
        # counters of the local-map refinement (the store counts its fuse
        # scans and fused / culled points)
        self.n_lm_dispatched = 0        # TrackLocalMap refinements run
        self.lm_accepted_frames: List[int] = []   # frames whose refinement was applied
        self.n_relocalized = 0          # LOST frames rescued by relocalization
        # counters of the trailing-window BA, and joint window BA runs
        self.n_win_dispatched = 0       # trailing-window refinements run
        self.win_accepted_frames: List[int] = []  # frames whose window was committed
        self.n_joint_refines = 0
        self.gba_stats: List[Optional[dict]] = []  # per global BA: stats, None if rejected
        self._win: List[dict] = []      # the trailing window's device tensors
        # per-span wall seconds (a list per span path); "upload" is there
        # from the start because a prefetch thread appends to it while the
        # live thread reads the dict
        self.stage_times: Dict[str, List[float]] = {"upload": []}
        # per-span event counts (a list per counter path, one entry a call:
        # ``record/slots_active``)
        self.stage_counts: Dict[str, List[int]] = {}
        self.keyframes = (
            KeyframeStore(capacity=be.kf_capacity, min_gap=keyframe_gap, device=self.device,
                          match_backend=match_backend)
            if enable_keyframes else None
        )

    # ------------------------------------------------------------------
    def _stage(self, name: str):
        """``with self._stage("relocalize"):`` accumulates wall time in
        ``stage_times`` under the stage's name (``profiling._StageCtx``);
        ``profiling.count`` inside it counts into ``stage_counts``."""
        return _StageCtx(self.stage_times, name, counts=self.stage_counts)

    def stage_report(self) -> Dict[str, Dict[str, float]]:
        """Aggregate stage_times: total seconds, call count, mean ms, of
        every span that ran."""
        return {
            k: {"total_s": round(float(np.sum(v)), 3), "n": len(v),
                "mean_ms": round(1e3 * float(np.mean(v)), 2)}
            for k, v in sorted(self.stage_times.items(), key=lambda kv: -float(np.sum(kv[1])))
            if v
        }

    def reset(self):
        self.__init__(
            self.cfg, seed=self.seed, min_inliers=self.min_inliers,
            max_lost_frames=self.max_lost_frames, enable_keyframes=self.enable_keyframes,
            keyframe_gap=self.keyframes.min_gap if self.keyframes else 5,
            enable_loop_closing=self.enable_loop_closing,
            loop_min_matches=self.loop_min_matches,
            loop_min_kf_separation=self.loop_min_kf_separation,
            loop_consistency=self.loop_consistency, discover_objects=self.discover_objects,
            pipelined=self.pipelined, device=self.device,
            sampler=self.sampler, match_backend=self.match_backend,
        )

    # ------------------------------------------------------------------
    def save_checkpoint(self, path):
        """Serialize the resumable state: tracking context, last frame's
        observation, evaluation stores, track IDs, the keyframe map."""
        import pickle

        self.flush()
        with open(path, "wb") as f:
            pickle.dump({
                "frame_idx": self._frame_idx,
                "ctx": state.result_to_numpy(self._ctx) if self._ctx is not None else None,
                "last_obs": (state.result_to_numpy(self._last_obs)
                             if self._last_obs is not None else None),
                "map": self.map,
                "sem_to_track": self._sem_to_track,
                "next_track_id": self._next_track_id,
                "state": self.state,
                "velocity": self._velocity,
                "corr": self._corr,
                "discover_objects": self.discover_objects,
                "keyframes": self.keyframes.frames if self.keyframes else None,
                "win": [{k: (v if k == "row" else v.cpu().numpy()) for k, v in w.items()}
                        for w in self._win],
            }, f)

    def load_checkpoint(self, path):
        """Restore a checkpoint written by :meth:`save_checkpoint` (a file
        this program wrote: it is unpickled)."""
        import pickle

        with open(path, "rb") as f:
            d = pickle.load(f)
        if d.get("discover_objects", False) != self.discover_objects:
            raise ValueError(f"the checkpoint was written with discover_objects="
                             f"{d.get('discover_objects', False)}; this system has "
                             f"{self.discover_objects}")
        self._frame_idx = d["frame_idx"]
        self._ctx = _to_device(d["ctx"], self.device) if d["ctx"] is not None else None
        self._last_obs = (_to_device(d["last_obs"], self.device)
                          if d["last_obs"] is not None else None)
        self.map = d["map"]
        self._sem_to_track = d["sem_to_track"]
        self._next_track_id = d["next_track_id"]
        self.state = d["state"]
        self._velocity = d["velocity"]
        self._corr = d.get("corr", np.eye(4, dtype=np.float32))
        self._pending = None
        if d.get("keyframes") is not None and self.keyframes is not None:
            self.keyframes.frames = d["keyframes"]
            self.keyframes._version += 1
            self.keyframes._struct_version += 1
        self._win = [{k: (v if k == "row" else torch.from_numpy(v).to(self.device))
                      for k, v in w.items()} for w in d.get("win", [])]
        self._feat_cache = None
        self._Tcw_last_h = (self._ctx.Tcw_last.cpu().numpy().astype(np.float32)
                            if self._ctx is not None else np.eye(4, dtype=np.float32))

    @staticmethod
    def _compact_images(fd: FrameData):
        """Host-side wire packing: gray8, 12-bit disparity, half-resolution
        12-bit flow, 4-bit labels."""
        gray = np.clip(np.nan_to_num(np.round(fd.gray)), 0, 255).astype(np.uint8)
        depth = wire.pack_depth12(np.clip(np.nan_to_num(fd.depth_raw), 0, 65535).astype(np.uint16))
        flow = wire.pack_flow12_half(fd.flow)
        sem = wire.pack_sem4(np.clip(fd.sem_mask, 0, 15))
        return gray, depth, flow, sem

    def upload(self, fd: FrameData):
        """Pack one frame and copy it to the device.  ``run_sequence`` calls
        this on a prefetch thread for the next frame while the current one
        is tracked.  Raises ``ValueError`` for a frame whose size is not the
        camera config's."""
        check_frame(fd, self.cfg.camera)
        with _StageCtx(self.stage_times, "upload"):
            return tuple(torch.from_numpy(np.ascontiguousarray(a)).to(self.device)
                         for a in self._compact_images(fd))

    def _gt(self, fd: FrameData):
        gt = F.make_gt_table(fd.pose_gt, fd.obj_ids_gt, fd.obj_poses_gt,
                             self.cfg.padding.k_obj_max)
        return F.GTTable(*(torch.from_numpy(x).to(self.device) for x in gt))

    def track_rgbd(self, fd: FrameData, uploaded=None) -> Optional[tracker.PairResult]:
        """Feed one frame; returns the (numpy) PairResult once a pair
        exists (in pipelined mode, the previous frame's).  ``uploaded``:
        optional device tensors from :meth:`upload`.  Raises ``ValueError``
        for a frame whose size is not the camera config's.  The call is the
        span ``track_rgbd``, whose profiler range carries the frame index."""
        with _StageCtx(self.stage_times, "track_rgbd", args=str(self._frame_idx),
                       counts=self.stage_counts):
            return self._track_rgbd(fd, uploaded)

    def _track_rgbd(self, fd: FrameData, uploaded):
        t0 = time.perf_counter()
        cfg = self.cfg
        check_frame(fd, cfg.camera)
        gt = self._gt(fd)
        if uploaded is not None:
            gray, depth, flow, sem = uploaded
        else:
            gray, depth, flow, sem = self.upload(fd)
        self._dev_images = (self._frame_idx, gray, depth)
        if self.discover_objects and self._pending is not None:
            # discovery reads the previous frame's window entry and velocity:
            # drain the in-flight frame first (its result is returned below)
            self.flush(_buffer=True)
        if self.discover_objects and self._win and self._frame_idx >= 2:
            # from frame 2 on: with T_rel = I the whole scene would fail
            # the ego-consistency gate and be flagged dynamic
            with self._stage("discover"):
                sem = self._discover_mask(depth)
        if self._last_obs is None:
            # first frame: pose = I, frontend only
            K = cfg.padding.k_obj_max
            self._ctx = F.tree_map(lambda x: x[0],
                                   tracker.initial_context(K, 1, self.device))
            self.map.camera_poses.append(np.eye(4, dtype=np.float32))
            self.map.camera_poses_raw.append(np.eye(4, dtype=np.float32))
            self.map.gt_poses.append(np.asarray(fd.pose_gt, np.float32))
            self.map.gt_objs.append(self._gt_objs(fd))
            self.map.timestamps.append(fd.timestamp)
            noise = (self._noise_gen
                     if cfg.solver.depth_noise or cfg.solver.flow_outliers else None)
            self._last_obs = tracker.first_step(gray, depth, flow, sem, gt, cfg, noise)
            self._push_window(gray, depth, flow, sem, 0)
            self._frame_idx += 1
            self.map.frame_times.append(time.perf_counter() - t0)
            return None

        with self._stage("dispatch_pair"):
            result, new_ctx, obs = tracker.full_step(
                self.sampler, self._frame_idx, self._last_obs, gray, depth, flow, sem, gt,
                self._ctx, cfg, generator=self._noise_gen, tape=self._step_tape)
        feats = None
        if self.enable_keyframes:
            with self._stage("features"):
                feats = self._frame_features(fd)
        pend = {
            "result": result, "new_ctx": new_ctx, "fd": fd, "frame_idx": self._frame_idx,
            "gray": gray, "depth": depth, "flow": flow, "sem": sem,
            "feats": feats,
            "corr": None,          # captured in _dispatch_refine, after the pending drain
            "refine": None, "use_lm": False, "use_win": False,
            "win_after": None, "Twc0_h": None,
        }
        # the device odometry chain advances at dispatch time; host
        # corrections enter the refinement as ``corr`` and the record
        self._ctx = new_ctx
        self._last_obs = obs
        self._frame_idx += 1

        if self.pipelined:
            result_prev = None
            if self._pending is not None:
                result_prev = self._process_frame(self._pending)
                self._pending = None
            elif self._flush_buffer:
                result_prev = self._flush_buffer.pop(0)
            self._dispatch_refine(pend)
            self._pending = pend
            self.map.frame_times.append(time.perf_counter() - t0)
            return result_prev

        self._dispatch_refine(pend)
        out = self._process_frame(pend)
        self.map.frame_times.append(time.perf_counter() - t0)
        return out

    def flush(self, _buffer: bool = False):
        """Drain the pipelined mode's in-flight frame (call at sequence
        end); returns its result.  No-op in synchronous mode.  ``_buffer``
        (internal, for summary() and the savers): keep the drained result
        for the next ``track_rgbd`` call instead."""
        if self._pending is not None:
            result = self._process_frame(self._pending)
            self._pending = None
            if _buffer and result is not None:
                self._flush_buffer.append(result)
            if self._kf_async is not None:
                self._consume_kf_async(None)
            return result
        if self._kf_async is not None:
            self._consume_kf_async(None)
        return None

    def _dispatch_refine(self, pend):
        """Run the fused local-map and trailing-window refinement of a frame
        whose pair solve is done.  In pipelined mode this runs after the
        previous frame drained, so every frame chains from the newest
        correction and the window's earlier rows exist."""
        be = self.cfg.backend
        pend["corr"] = self._corr.copy()
        if not be.fused_refine:
            return
        use_lm = bool(be.track_local_map and self.keyframes is not None
                      and self.keyframes.frames)
        win_after = None
        if be.window_refine or be.joint_window_refine:
            # the frame's trajectory row is its frame index (one row per frame)
            win_after = (self._win + [{"gray": pend["gray"], "depth": pend["depth"],
                                       "flow": pend["flow"], "sem": pend["sem"],
                                       "row": pend["frame_idx"]}])[-be.window_size:]
        use_win = bool(be.window_refine and win_after is not None
                       and len(win_after) == be.window_size)
        pend.update(use_lm=use_lm, use_win=use_win, win_after=win_after)
        if not (use_lm or use_win):
            return
        with _StageCtx(self.stage_times, "refine_prep", counts=self.stage_counts):
            feats, lmap = (None,) * 4, (None,) * 3
            if use_lm:
                feats = pend["feats"]
                lmap = self.keyframes.local_map(n_kf=be.local_map_kfs)
                self.n_lm_dispatched += 1
            poses_rel_prev = torch.zeros((0, 4, 4))
            Twc0_h = np.eye(4, dtype=np.float32)
            grays = depth0 = flows = sems = None
            if use_win:
                rows_prev = [w["row"] for w in win_after[:-1]]
                Twc0_h = np.asarray(self.map.camera_poses[rows_prev[0]], np.float32)
                poses_rel_prev = torch.from_numpy(np.stack([
                    np.linalg.inv(self.map.camera_poses[r]).astype(np.float32) @ Twc0_h
                    for r in rows_prev]))
                grays = torch.stack([w["gray"] for w in win_after])
                flows = torch.stack([w["flow"] for w in win_after[:-1]])
                sems = torch.stack([w["sem"] for w in win_after])
                depth0 = win_after[0]["depth"]
                self.n_win_dispatched += 1
            pend["Twc0_h"] = Twc0_h
            dev = lambda a: torch.as_tensor(a).to(self.device)
            poses_rel_prev_d, Twc0_d, corr_d = dev(poses_rel_prev), dev(Twc0_h), dev(pend["corr"])
        pend["refine"] = live_refine_step(
            pend["result"], *feats, *lmap, poses_rel_prev_d, Twc0_d,
            grays, depth0, flows, sems, corr_d, self.cfg, use_lm, use_win,
            self.min_inliers, match_backend=self.match_backend, stage=self._stage,
        )

    def _process_frame(self, pend):
        """Fetch one frame's solve and refinement and run every host-side
        decision: state machine, refinement acceptance, recording, keyframe
        cadence work."""
        cfg = self.cfg
        be = cfg.backend
        fd = pend["fd"]
        frame_idx = pend["frame_idx"]
        if self._kf_async is not None:
            with self._stage("kf_consume"):
                self._consume_kf_async(pend)
        corr = pend["corr"]
        use_lm, use_win = pend["use_lm"], pend["use_win"]
        win_after, Twc0_h = pend["win_after"], pend["Twc0_h"]
        new_ctx = pend["new_ctx"]
        with self._stage("fetch_result"):
            result = state.result_to_numpy(pend["result"])
            accept_lm, T1, poses_out, n_live = False, None, None, 0
            if pend["refine"] is not None:
                ref = pend["refine"]
                T1 = ref.T1.cpu().numpy().astype(np.float32)
                accept_lm = bool(ref.accept_lm)
                poses_out = ref.poses_out.cpu().numpy().astype(np.float32)
                n_live = int(ref.n_live)

        # the raw device chain's pose, and its correction into the recorded
        # world frame (identity in synchronous mode)
        Tcw_dev_flow = np.asarray(result.Tcw_cur, np.float32)
        result = result._replace(Tcw_cur=(Tcw_dev_flow @ corr).astype(np.float32))

        # --- tracking-state machine + constant-velocity fallback ---
        Tcw_last = self._Tcw_last_h
        flow_ok = int(result.n_static_inliers) >= self.min_inliers
        if not flow_ok:
            self.state = self.STATE_LOST
            self._lost_streak += 1
            Tcw_fallback = self._velocity @ Tcw_last
            with self._stage("relocalize"):
                T_reloc = self._try_relocalize(pend["feats"], frame_idx)
            if T_reloc is not None:
                Tcw_fallback = T_reloc
                self.state = self.STATE_OK
                self._lost_streak = 0
                self.n_relocalized += 1
            result = result._replace(Tcw_cur=Tcw_fallback)
            if self._lost_streak > self.max_lost_frames:
                self._sem_to_track.clear()
                self._lost_streak = 0
        else:
            self.state = self.STATE_OK
            self._lost_streak = 0
            self._velocity = np.asarray(result.Tcw_cur) @ np.linalg.inv(Tcw_last)

        # the pose the device's object motions were anchored on
        Tcw_online = np.asarray(result.Tcw_cur)

        def _fix_ctx(**kw):
            # synchronous mode corrects the device chain in place; the
            # pipelined chain stays raw (corrections ride ``corr``)
            nonlocal new_ctx
            if not self.pipelined:
                new_ctx = new_ctx._replace(**{
                    k: torch.from_numpy(np.asarray(v, np.float32)).to(self.device)
                    for k, v in kw.items()})

        # the local-map pose: fused, the gates the device evaluated (a LOST
        # frame discards them); else the host's local-map tracking
        T_lm = refined_last = None
        if be.fused_refine:
            if flow_ok and use_lm and accept_lm:
                T_lm = T1
        elif (be.track_local_map and self.keyframes is not None and self.keyframes.frames
              and self.state == self.STATE_OK):
            with self._stage("local_map"):
                T_lm = self._track_local_map(Tcw_online, pend["feats"], fd)
        if T_lm is not None:
            result = result._replace(Tcw_cur=T_lm)
            self._velocity = (T_lm @ np.linalg.inv(Tcw_last)).astype(np.float32)
            _fix_ctx(Tcw_last=T_lm, T_velocity=self._velocity)
            self.lm_accepted_frames.append(frame_idx)
        with self._stage("record"):
            self._record(result, fd, Tcw_online=Tcw_online, frame_idx=frame_idx)
            self._push_window(pend["gray"], pend["depth"], pend["flow"], pend["sem"],
                              len(self.map.camera_poses) - 1)
        if be.fused_refine:
            if (flow_ok and use_win and n_live >= be.min_window_tracks
                    and np.isfinite(poses_out).all()):
                # commit the refined window rows (anchored at its frame 0)
                Tcw0_abs = np.linalg.inv(Twc0_h).astype(np.float32)
                for f, r in enumerate(w["row"] for w in win_after):
                    self.map.camera_poses[r] = np.linalg.inv(
                        poses_out[f] @ Tcw0_abs).astype(np.float32)
                refined_last = (poses_out[-1] @ Tcw0_abs).astype(np.float32)
        elif be.window_refine and self.state == self.STATE_OK:
            with self._stage("window_refine"):
                refined_last = self._refine_window()
        if refined_last is not None:
            result = result._replace(Tcw_cur=refined_last)
            self._after_window_commit(refined_last, _fix_ctx)
            self.win_accepted_frames.append(frame_idx)

        if self.enable_keyframes and self.state == self.STATE_OK:
            if self.pipelined and be.async_keyframes:
                # dispatch the keyframe-cadence work now, consume it at the
                # next drain
                with self._stage("kf_dispatch"):
                    self._dispatch_kf_cadence(pend, np.asarray(result.Tcw_cur), frame_idx)
            else:
                with self._stage("keyframe_add"):
                    added = self._maybe_add_keyframe(fd, np.asarray(result.Tcw_cur),
                                                     pend["feats"], frame_idx)
                if added and be.joint_window_refine:
                    # joint ego+object window BA at keyframe cadence
                    with self._stage("joint_ba"):
                        joint_last = self._refine_joint_window()
                    if joint_last is not None:
                        result = result._replace(Tcw_cur=joint_last)
                        self._after_window_commit(joint_last, _fix_ctx)
                if added and self.enable_loop_closing:
                    # a closure rewrites the recorded trajectory
                    with self._stage("loop_ladder"):
                        corrected_last = self._maybe_close_loop(frame_idx)
                    if corrected_last is not None:
                        result = result._replace(Tcw_cur=corrected_last)
                        _fix_ctx(Tcw_last=corrected_last, T_velocity=self._velocity)
        if self.state == self.STATE_LOST:
            if self.pipelined and np.isfinite(Tcw_dev_flow).all():
                # the next frame is already in flight on the raw chain:
                # apply the fallback pose as the right-factor instead
                self._corr = (np.linalg.inv(Tcw_dev_flow)
                              @ np.asarray(result.Tcw_cur)).astype(np.float32)
            else:
                # rebuild the context from the fallback, anchored on the
                # last recorded pose
                self._ctx = self._next_context_host(result, Tcw_last)
                self._corr = np.eye(4, dtype=np.float32)
        elif not self.pipelined:
            self._ctx = new_ctx
            self._corr = np.eye(4, dtype=np.float32)
        else:
            self._corr = (np.linalg.inv(Tcw_dev_flow)
                          @ np.asarray(result.Tcw_cur)).astype(np.float32)
        self._Tcw_last_h = np.asarray(result.Tcw_cur, np.float32)
        return result

    def _next_context_host(self, result, Tcw_last: np.ndarray) -> tracker.TrackContext:
        """``tracker.next_context`` of a host-side result, with the previous
        pose replaced by ``Tcw_last``."""
        batch = lambda tree: F.tree_map(lambda x: x[None], tree)
        prev = self._ctx._replace(Tcw_last=torch.from_numpy(Tcw_last).to(self.device))
        nxt = tracker.next_context(batch(_to_device(result, self.device)), batch(prev),
                                   self.cfg.padding.k_obj_max)
        return F.tree_map(lambda x: x[0], nxt)

    # ------------------------------------------------------------------
    def _describe_frame(self, fd: FrameData):
        """Keyframe-grade features of the current frame, from the device
        images ``track_rgbd`` already uploaded when they are there."""
        if self._dev_images is not None and self._dev_images[0] == self._frame_idx:
            gray, depth = self._dev_images[1], self._dev_images[2]
        else:
            gray, depth = self.upload(fd)[:2]
        return _describe_frame_device(gray, depth, self.cfg.camera.bf, self.cfg.camera.width)

    def _frame_features(self, fd: FrameData):
        """Per-frame cache around ``_describe_frame``: local-map tracking,
        keyframe capture and relocalization share one extraction."""
        if self._feat_cache is not None and self._feat_cache[0] == self._frame_idx:
            return self._feat_cache[1]
        feats = self._describe_frame(fd)
        self._feat_cache = (self._frame_idx, feats)
        return feats

    def _track_local_map(self, Tcw_init: np.ndarray, feats=None, fd=None):
        """Refine the flow pose against the local map (the unfused path).
        Returns the refined Tcw, or None when a gate fails: too few inliers,
        non-finite, or a correction beyond the translation / rotation caps."""
        be, cam = self.cfg.backend, self.cfg.camera
        uv, desc, valid, z = feats if feats is not None else self._frame_features(fd)
        self.n_lm_dispatched += 1
        T, n_inl, _ = self.keyframes.track_local_map(
            Tcw_init, uv, desc, valid, z,
            cam.fx, cam.fy, cam.cx, cam.cy, cam.width, cam.height, cam.bf,
            n_kf=be.local_map_kfs, radius=be.local_map_radius_px,
            thresh=be.local_map_thresh_px,
        )
        if n_inl < be.local_map_min_inliers or not np.isfinite(T).all():
            return None
        d = T @ np.linalg.inv(Tcw_init)
        if np.linalg.norm(d[:3, 3]) > be.local_map_max_corr_m:
            return None
        ang = np.degrees(np.arccos(np.clip((np.trace(d[:3, :3]) - 1.0) / 2.0, -1.0, 1.0)))
        if ang > be.local_map_max_rot_deg:
            return None
        return T.astype(np.float32)

    # ------------------------------------------------------------------
    # Async keyframe cadence (pipelined mode, BackendConfig.async_keyframes):
    # the keyframe's capture, fuse scan and covisibility counts run at the
    # keyframe frame and are consumed one frame later.

    def _last_keyframe_index(self):
        last = self._last_kf_index
        if self.keyframes.frames:
            last = max(last if last is not None else -10 ** 9, self.keyframes.frames[-1].index)
        return last

    def _dispatch_kf_cadence(self, pend, Tcw_cur: np.ndarray, frame_idx: int):
        cam = self.cfg.camera
        last = self._last_keyframe_index()
        if last is not None and frame_idx - last < self.keyframes.min_gap:
            return
        uv, desc, valid, z = pend["feats"]
        Twc = torch.from_numpy(np.linalg.inv(Tcw_cur).astype(np.float32)).to(self.device)
        desc_k, f32 = _keyframe_payload(uv, desc, valid, z, Twc, cam.fx, cam.fy, cam.cx, cam.cy)
        n = int(desc.shape[0])
        uv_dev, Xw_dev, valid_dev = _split_payload(f32, n)
        fuse_handle, fuse_prevs = self.keyframes.dispatch_fuse(
            torch.from_numpy(np.asarray(Tcw_cur, np.float32)).to(self.device), desc_k, uv_dev,
            valid_dev, Xw_dev, cam.fx, cam.fy, cam.cx, cam.cy, cam.width, cam.height,
        )
        sim_handle = adj_handle = None
        stacked = self.keyframes._stacked_descriptors()
        if stacked is not None:
            sim_handle = _batched_match_counts(desc, valid, *stacked)
            adj_handle = _adjacent_match_counts(*stacked)
        joint = None
        if self.cfg.backend.joint_window_refine:
            joint = self._refine_joint_window(dispatch_only=True)
        self._kf_async = dict(
            frame_idx=frame_idx, Tcw=np.asarray(Tcw_cur, np.float32).copy(),
            desc=desc_k, f32=f32, n=n, fuse=fuse_handle, fuse_prevs=fuse_prevs,
            sim=sim_handle, adj=adj_handle, n_old=len(self.keyframes.frames),
            # score index -> keyframe object (membership may churn before consumption)
            frames_ref=list(self.keyframes.frames),
            joint=joint,
        )
        self._last_kf_index = frame_idx

    def _apply_right_factor(self, D: np.ndarray, pend, first_row: int):
        """Fold a retroactive Tcw right-factor (rows >= ``first_row`` move as
        Tcw @ D) into the recorded trajectory, the pipelined correction
        chain and the in-flight frame."""
        D = D.astype(np.float32)
        Dinv = np.linalg.inv(D).astype(np.float32)
        for r in range(first_row, len(self.map.camera_poses)):
            self.map.camera_poses[r] = (Dinv @ self.map.camera_poses[r]).astype(np.float32)
        self._corr = (self._corr @ D).astype(np.float32)
        self._Tcw_last_h = (self._Tcw_last_h @ D).astype(np.float32)
        if pend is not None and pend.get("corr") is not None:
            pend["corr"] = (pend["corr"] @ D).astype(np.float32)
        if pend is not None and pend.get("Twc0_h") is not None:
            pend["Twc0_h"] = (Dinv @ pend["Twc0_h"]).astype(np.float32)

    def _consume_kf_async(self, pend):
        """Fetch and apply one deferred keyframe-cadence bundle.  ``pend``
        is the frame being drained (None at flush)."""
        a, self._kf_async = self._kf_async, None
        n = a["n"]
        uv_h, Xw_h, valid_h = _split_payload(a["f32"].cpu().numpy(), n)
        kf = Keyframe(index=a["frame_idx"], Tcw=a["Tcw"], uv=uv_h.astype(np.float32),
                      desc=a["desc"].cpu().numpy(), valid=valid_h, Xw=Xw_h.astype(np.float32))
        if not self.keyframes.maybe_add(kf):
            return
        K_old = a["n_old"]
        if a["fuse"] is not None and a["fuse_prevs"]:
            self.keyframes.apply_fuse(a["fuse"].cpu().numpy(), a["fuse_prevs"],
                                      self.keyframes.frames[-1])
        # the dispatch-time covisibility counts index pairs of the
        # dispatch-time store; after any membership churn skip this cull
        aligned = (len(self.keyframes.frames) == K_old + 1
                   and all(self.keyframes.frames[i] is a["frames_ref"][i] for i in range(K_old)))
        if aligned and a["adj"] is not None and a["sim"] is not None and K_old >= 1:
            counts = np.concatenate([a["adj"].cpu().numpy()[: max(K_old - 1, 0)],
                                     a["sim"].cpu().numpy()[K_old - 1: K_old]])
            self.keyframes.cull_redundant(counts=counts)
        if a["joint"] is not None:
            # object measurements only (see _joint_window_apply)
            handle, jctx = a["joint"]
            self._joint_window_apply(jctx, *(x.cpu().numpy() for x in handle),
                                     commit_poses=False)
        if self.enable_loop_closing and a["sim"] is not None and K_old >= 2:
            # scores against the dispatch-time stack minus its newest entry:
            # the synchronous path's exclude_last=2
            scores = a["sim"].cpu().numpy()[: K_old - 1]
            cand = -1
            if scores.size and int(scores.max()) >= self.loop_min_matches:
                best = a["frames_ref"][int(scores.argmax())]
                # membership may have churned since dispatch
                cand = next((i for i, f in enumerate(self.keyframes.frames) if f is best), -1)
            if cand < 0:
                self._note_loop_candidate(None)
            else:
                old_last = np.linalg.inv(self.map.camera_poses[-1]).astype(np.float32)
                corrected_last = self._maybe_close_loop(a["frame_idx"], cand=cand)
                if corrected_last is not None:
                    # the ladder rewrote every recorded row; the chain, the
                    # in-flight frame and the anchors still need the fold
                    self._apply_right_factor(np.linalg.inv(old_last) @ corrected_last, pend,
                                             first_row=len(self.map.camera_poses))

    def _maybe_add_keyframe(self, fd: FrameData, Tcw: np.ndarray, feats=None,
                            frame_idx=None) -> bool:
        if frame_idx is None:
            frame_idx = self._frame_idx
        kfs = self.keyframes
        if kfs.frames and frame_idx - kfs.frames[-1].index < kfs.min_gap:
            return False
        cam = self.cfg.camera
        uv, desc, valid, z = feats if feats is not None else self._frame_features(fd)
        Twc = np.linalg.inv(Tcw).astype(np.float32)
        desc_k, f32 = _keyframe_payload(uv, desc, valid, z, torch.from_numpy(Twc).to(self.device),
                                        cam.fx, cam.fy, cam.cx, cam.cy)
        n = int(desc.shape[0])
        uv_h, Xw_h, valid_h = _split_payload(f32.cpu().numpy(), n)
        added = kfs.maybe_add(Keyframe(index=frame_idx, Tcw=Tcw.astype(np.float32),
                                       uv=uv_h.astype(np.float32), desc=desc_k.cpu().numpy(),
                                       valid=valid_h, Xw=Xw_h.astype(np.float32)))
        if added:
            # LocalMapping upkeep at keyframe cadence: duplicate fusion and
            # found-ratio culling, then keyframe redundancy culling
            kfs.fuse_and_cull(cam.fx, cam.fy, cam.cx, cam.cy, cam.width, cam.height)
            kfs.cull_redundant()
        return added

    # ------------------------------------------------------------------
    # The trailing window: its frames' device tensors, the unfused window
    # BA and the joint ego+object window BA.

    def _discover_mask(self, depth_cur: torch.Tensor) -> torch.Tensor:
        """The current frame's packed instance mask, from motion alone: the
        discovery runs on the previous frame's grid with the constant-velocity
        ego motion, and its labels are rasterised at their flow-shifted
        (current-frame) positions.  Instances are the connected components of
        the dilated dynamic raster, the largest ``k_obj_max - 1`` of at least
        640 px (one object may come out as several motion clusters)."""
        from scipy import ndimage

        cam = self.cfg.camera
        prev = self._win[-1]
        depth0 = cam_g.disparity_png_to_depth(wire._decode_depth(prev["depth"], cam.width),
                                              cam.bf)
        depth1 = cam_g.disparity_png_to_depth(wire._decode_depth(depth_cur, cam.width), cam.bf)
        flow0 = wire._decode_flow(prev["flow"], cam.height, cam.width)
        disc = motion_seg.discover_objects(
            self.sampler, (self._frame_idx, "discover"), depth0, depth1, flow0,
            torch.from_numpy(np.asarray(self._velocity, np.float32)).to(self.device),
            cam.fx, cam.fy, cam.cx, cam.cy)
        raster = motion_seg.rasterize_labels_at(disc.uv_cur, disc.labels, disc.valid,
                                                cam.height, cam.width, step=8).cpu().numpy()
        # dilate by one 8 px cell so near-adjacent fragments merge, then
        # undo the dilation on the labelled components
        binary = ndimage.binary_dilation(raster > 0, np.ones((17, 17), bool))
        comp, n_comp = ndimage.label(binary)
        comp = np.where(raster > 0, comp, 0)
        mask = np.zeros_like(raster)
        if n_comp:
            sizes = ndimage.sum_labels(raster > 0, comp, range(1, n_comp + 1))
            order = np.argsort(sizes)[::-1][:self.cfg.padding.k_obj_max - 1]
            for new_id, c in enumerate(order, start=1):
                # distant objects are small: gate loosely and leave the final
                # call to the tracker's min_obj_points
                if sizes[c] >= 640:
                    mask[comp == c + 1] = new_id
        return torch.from_numpy(wire.pack_sem4(np.clip(mask, 0, 15))).to(self.device)

    def _push_window(self, gray, depth, flow, sem, traj_row: int):
        """Keep the trailing window's device tensors for the window
        refinements and for discovery, which reads the previous frame."""
        be = self.cfg.backend
        if not (be.window_refine or be.joint_window_refine or self.discover_objects):
            return
        self._win.append({"gray": gray, "depth": depth, "flow": flow, "sem": sem,
                          "row": traj_row})
        if len(self._win) > be.window_size:
            self._win.pop(0)

    def _window_poses(self):
        """The window's rows, its Tcw relative to its frame 0 (W, 4, 4), and
        frame 0's absolute Tcw."""
        rows = [w["row"] for w in self._win]
        Tcw_abs = [np.linalg.inv(self.map.camera_poses[r]).astype(np.float32) for r in rows]
        Twc0 = np.linalg.inv(Tcw_abs[0]).astype(np.float32)
        return rows, np.stack([T @ Twc0 for T in Tcw_abs]), Tcw_abs[0]

    def _window_tensors(self):
        """(grays, depths, flows, sems) stacked over the window."""
        return (torch.stack([w["gray"] for w in self._win]),
                torch.stack([w["depth"] for w in self._win]),
                torch.stack([w["flow"] for w in self._win[:-1]]),
                torch.stack([w["sem"] for w in self._win]))

    def _after_window_commit(self, Tcw_last: np.ndarray, fix_ctx):
        """The current pose moved with a window commit: the context's last
        pose and the velocity follow it."""
        fix_ctx(Tcw_last=Tcw_last)
        if len(self.map.camera_poses) >= 2:
            # Tcw_cur @ Twc_prev (camera_poses stores Twc)
            self._velocity = (Tcw_last @ self.map.camera_poses[-2]).astype(np.float32)
            fix_ctx(T_velocity=self._velocity)

    def _refine_window(self) -> Optional[np.ndarray]:
        """Trailing-window BA over the buffered frames (the unfused path).
        Rewrites the window's rows of ``map.camera_poses`` and returns the
        refined current Tcw, or None below ``min_window_tracks`` live tracks
        or on a non-finite result."""
        from multimot_track_tpu_torch.pipeline import window_refine

        be = self.cfg.backend
        if len(self._win) < be.window_size:
            return None
        rows, poses_rel, Tcw0_abs = self._window_poses()
        grays, depths, flows, sems = self._window_tensors()
        self.n_win_dispatched += 1
        poses_out, n_live = window_refine.refine_trailing_window(
            torch.from_numpy(poses_rel).to(self.device), grays, depths[0], flows, sems, self.cfg)
        if int(n_live) < be.min_window_tracks:
            return None
        poses_out = poses_out.cpu().numpy()
        if not np.isfinite(poses_out).all():
            return None
        for f, r in enumerate(rows):
            self.map.camera_poses[r] = np.linalg.inv(poses_out[f] @ Tcw0_abs).astype(np.float32)
        return (poses_out[-1] @ Tcw0_abs).astype(np.float32)

    def _refine_joint_window(self, dispatch_only: bool = False):
        """Joint ego + multi-object BA over the trailing window, at keyframe
        cadence, initialised from the online poses and the records' object
        measurements (P_lc) re-anchored in the window's frame.  Skipped on a
        window that is not full, spans a LOST gap or holds no object.

        ``dispatch_only`` (async cadence): returns ((poses, motions) device
        tensors, context) for :meth:`_joint_window_apply`; otherwise applies
        the result and returns the refined current Tcw or None."""
        from multimot_track_tpu_torch.pipeline import window_refine

        if len(self._win) < self.cfg.backend.window_size:
            return None
        with span("problem"):
            rows, poses_rel, Tcw0_abs = self._window_poses()
            # a LOST gap breaks the pair <-> stored-flow alignment
            if any(rows[i + 1] - rows[i] != 1 for i in range(len(rows) - 1)):
                return None
            H_init, H_valid, used = joint_motion_init(self.map.obj_records, rows, poses_rel,
                                                      self.cfg.padding.k_obj_max)
            if not used:
                return None     # an ego-only window is the per-frame refiner's job
            self.n_joint_refines += 1
            dev = lambda a: torch.from_numpy(a).to(self.device)
            inputs = (dev(poses_rel), dev(H_init), dev(H_valid), *self._window_tensors())
        poses_out, motions_out, _ = window_refine.refine_joint_window(*inputs, self.cfg)
        jctx = dict(rows=rows, poses_rel=poses_rel, Tcw0_abs=Tcw0_abs, used=used)
        if dispatch_only:
            return (poses_out, motions_out), jctx
        with span("fetch"):
            return self._joint_window_apply(jctx, poses_out.cpu().numpy(),
                                            motions_out.cpu().numpy())

    def _joint_window_apply(self, jctx, poses_out: np.ndarray, motions_out: np.ndarray,
                            commit_poses: bool = True) -> Optional[np.ndarray]:
        """Gates and commits of a joint-window result: rejected when
        non-finite or when a pose moves by more than ``joint_max_corr_m``.
        Commits the window's rows (unless ``commit_poses`` is False, as on
        the async cadence, where the per-frame window refiner owns the rows)
        and the records' P_lc; returns the refined Tcw of the last row."""
        be = self.cfg.backend
        rows, poses_rel, Tcw0_abs = jctx["rows"], jctx["poses_rel"], jctx["Tcw0_abs"]
        if not (np.isfinite(poses_out).all() and np.isfinite(motions_out).all()):
            return None
        for f in range(len(rows)):
            d = poses_out[f] @ np.linalg.inv(poses_rel[f])
            if np.linalg.norm(d[:3, 3]) > be.joint_max_corr_m:
                return None
        if commit_poses:
            for f, r in enumerate(rows):
                self.map.camera_poses[r] = np.linalg.inv(poses_out[f] @ Tcw0_abs).astype(
                    np.float32)
        for (f, k), i in jctx["used"].items():
            self.map.obj_records[i].P_lc = (poses_out[f + 1] @ motions_out[f, k]
                                            @ np.linalg.inv(poses_out[f])).astype(np.float32)
        return (poses_out[-1] @ Tcw0_abs).astype(np.float32)

    def _maybe_close_loop(self, frame_idx: int, cand: Optional[int] = None):
        """The loop ladder on the newest keyframe: place recognition (or the
        async cadence's precomputed ``cand``), the temporal and consistency
        gates, Sim3 verification and the pose-graph correction of every
        recorded row, then (``global_ba_on_loop``) the global BA, whose
        keyframe corrections non-keyframe rows follow through their anchor
        keyframe.  Returns the corrected current Tcw when a loop is
        accepted, else None."""
        kfs = self.keyframes
        kf = kfs.frames[-1]
        if cand is None:
            cand = kfs.detect_loop(kfs._dev(kf.desc), kfs._dev(kf.valid),
                                   min_matches=self.loop_min_matches)
        # temporal guard: candidates too close in time are not loops
        if cand is None or len(kfs.frames) - 1 - cand < self.loop_min_kf_separation:
            self._note_loop_candidate(None)
            return None
        if not self._note_loop_candidate(kfs.frames[cand].index):
            return None
        cam, be = self.cfg.camera, self.cfg.backend
        traj_Tcw = np.stack([np.linalg.inv(p).astype(np.float32) for p in self.map.camera_poses])
        with self._stage("loop_sim3_pose_graph"):
            corrected, n_inl = kfs.close_loop(self.sampler, (frame_idx, "sim3"), kf, cand,
                                              traj_Tcw, [k.index for k in kfs.frames],
                                              cam.fx, cam.fy, cam.cx, cam.cy)
        if n_inl == 0:
            return None
        corrected = np.array(corrected)
        self.map.camera_poses = [np.linalg.inv(T).astype(np.float32) for T in corrected]
        # keyframes follow their rows, and their points are re-anchored
        kfs.correct_poses([corrected[k.index] for k in kfs.frames])
        if be.global_ba_on_loop:
            kf_rows = [k.index for k in kfs.frames]
            old_Tcw_kf = [corrected[r].copy() for r in kf_rows]
            with self._stage("loop_global_ba"):
                gba = kfs.global_ba(cam.fx, cam.fy, cam.cx, cam.cy, cam.bf,
                                    loop_pair=(cand, len(kfs.frames) - 1),
                                    max_obs=be.global_ba_max_obs, iters=be.global_ba_iters,
                                    max_corr_m=be.global_ba_max_corr_m)
            self.gba_stats.append(gba[1] if gba is not None else None)
            if gba is not None:
                new_Tcw_kf = gba[0]
                # non-keyframe rows keep their relative pose to the newest
                # keyframe at or before them
                anchor = 0
                for r in range(corrected.shape[0]):
                    while anchor + 1 < len(kf_rows) and kf_rows[anchor + 1] <= r:
                        anchor += 1
                    corrected[r] = (corrected[r] @ np.linalg.inv(old_Tcw_kf[anchor])
                                    @ new_Tcw_kf[anchor]).astype(np.float32)
                self.map.camera_poses = [np.linalg.inv(T).astype(np.float32)
                                         for T in corrected]
        if len(corrected) >= 2:
            self._velocity = (corrected[-1] @ np.linalg.inv(corrected[-2])).astype(np.float32)
        self.map.loop_events.append((frame_idx, kfs.frames[cand].index, n_inl))
        self._loop_history.clear()   # accepted: do not re-trigger on this revisit
        return corrected[-1]

    def _note_loop_candidate(self, cand_frame: Optional[int]) -> bool:
        """Record one keyframe's loop candidate (its frame index, or None);
        True when at least ``loop_consistency`` of the newest
        ``loop_consistency + 1`` detections lie within
        (loop_consistency + 1) x keyframe gap of this one.  The history is
        cleared only by an accepted closure, so a Sim3 or drift-gate
        rejection keeps the evidence for the next keyframe."""
        self._loop_history.append(cand_frame)
        need = self.loop_consistency
        if need <= 1:
            return cand_frame is not None
        if cand_frame is None:
            return False
        gap = self.keyframes.min_gap if self.keyframes else 5
        close = [x for x in self._loop_history[-(need + 1):]
                 if x is not None and abs(x - cand_frame) <= (need + 1) * gap]
        return len(close) >= need

    def _try_relocalize(self, feats, frame_idx: int):
        if feats is None or not self.keyframes.frames:   # no features without keyframes
            return None
        cam = self.cfg.camera
        uv, desc, valid, _ = feats
        return self.keyframes.relocalize(self.sampler, (frame_idx, "pnp"), desc, uv, valid,
                                         cam.fx, cam.fy, cam.cx, cam.cy)

    # ------------------------------------------------------------------
    @staticmethod
    def _gt_objs(fd: FrameData) -> dict:
        if fd.obj_ids_gt is None:
            return {}
        return {int(i): np.asarray(L, np.float32) for i, L in zip(fd.obj_ids_gt, fd.obj_poses_gt)}

    def _record(self, r: tracker.PairResult, fd: FrameData, Tcw_online=None, frame_idx=None):
        """Append one frame to the evaluation stores and associate track IDs.
        ``Tcw_online``: the device solve's pose before local-map refinement;
        it anchors the raw trajectory and the P_lc decomposition (the device
        solved the object motions against it).  Counts ``slots_active``, the
        object slots that carried a mover, from host values, in the
        innermost open span."""
        if frame_idx is None:
            frame_idx = self._frame_idx
        m = self.map
        if Tcw_online is None:
            Tcw_online = np.asarray(r.Tcw_cur)
        m.camera_poses.append(np.linalg.inv(np.asarray(r.Tcw_cur)).astype(np.float32))
        m.camera_poses_raw.append(np.linalg.inv(Tcw_online).astype(np.float32))
        m.gt_poses.append(np.asarray(fd.pose_gt, np.float32))
        m.timestamps.append(fd.timestamp)
        m.cam_rpe_abs.append(np.asarray([float(r.cam_t_rpe), float(r.cam_r_rpe)]))
        m.cam_rpe_rel.append(np.asarray([float(r.cam_t_rpe_rel), float(r.cam_r_rpe_rel)]))
        m.flow_hists.append(np.asarray(r.flow_hist))
        m.gt_objs.append(self._gt_objs(fd))
        ob = r.objects
        Tcw_cur_used = Tcw_online
        Twc_last_used = (m.camera_poses[-2] if len(m.camera_poses) >= 2
                         else np.eye(4, dtype=np.float32))
        Tcw_last_used = np.linalg.inv(Twc_last_used)
        active = np.asarray(ob.active)
        m.tot_obj_num.append(int(np.asarray(ob.seen).sum()))

        # persistent ID association
        new_map: Dict[int, int] = {}
        mode = np.asarray(ob.mode_last_label)
        for slot in range(len(active)):
            if not active[slot]:
                continue
            sem_label = slot + 1
            prev_sem = int(mode[slot])
            if prev_sem in self._sem_to_track and frame_idx > 1:
                tid = self._sem_to_track[prev_sem]
            else:
                tid = self._next_track_id
                self._next_track_id += 1
            new_map[sem_label] = tid
            H = np.asarray(ob.H[slot])
            m.obj_records.append(ObjectRecord(
                frame=frame_idx, track_id=tid, sem_label=sem_label, H=H,
                speed_est=float(ob.speed_est[slot]), speed_gt=float(ob.speed_gt[slot]),
                t_rpe=float(ob.t_rpe[slot]), r_rpe=float(ob.r_rpe[slot]),
                t_rpe_rel=float(ob.t_rpe_rel[slot]), r_rpe_rel=float(ob.r_rpe_rel[slot]),
                speed_err_rel=float(ob.speed_err_rel[slot]),
                t_rpe_centred=float(ob.t_rpe_centred[slot]),
                n_points=int(ob.n_points[slot]), n_inliers=int(ob.n_inliers[slot]),
                centre3d=np.asarray(ob.centre3d[slot]), bbox=np.asarray(ob.bbox[slot]),
                P_lc=(Tcw_cur_used @ H @ Twc_last_used).astype(np.float32),
                centre_pre_lc=(Tcw_last_used[:3, :3] @ np.asarray(ob.centre_pre[slot])
                               + Tcw_last_used[:3, 3]).astype(np.float32),
                has_gt=bool(ob.has_gt[slot]),
            ))
        self._sem_to_track = new_map
        count("slots_active", len(new_map))

    # ------------------------------------------------------------------
    def summary(self) -> dict:
        self.flush(_buffer=True)
        m = self.map
        cam = np.asarray(m.cam_rpe_rel) if m.cam_rpe_rel else np.zeros((0, 2))
        cam = cam[np.isfinite(cam).all(axis=1)] if len(cam) else cam
        objs = [o for o in m.obj_records if o.has_gt]
        return {
            "n_frames": self._frame_idx,
            "cam_t_rpe_rel_mean": float(cam[:, 0].mean()) if len(cam) else None,
            "cam_r_rpe_rel_mean": float(cam[:, 1].mean()) if len(cam) else None,
            "obj_t_rpe_rel_mean": float(np.nanmean([o.t_rpe_rel for o in objs])) if objs else None,
            "obj_r_rpe_rel_mean": float(np.nanmean([o.r_rpe_rel for o in objs])) if objs else None,
            "obj_speed_err_rel_mean": (float(np.nanmean([o.speed_err_rel for o in objs]))
                                       if objs else None),
            "obj_nonfinite_records": int(sum(not np.isfinite(o.t_rpe_rel) for o in objs)),
            "n_obj_estimates": len(m.obj_records),
            "n_loop_closures": len(m.loop_events),
            "ego_ate_rmse_m": self.ate(),
            "ego_ate_rmse_raw_m": self.ate(raw=True),
            "cam_t_rpe_refined_mean": self.refined_pair_rpe(),
            "obj_t_rpe_refined_mean": self.refined_obj_metrics()[0],
            "mean_frame_time_s": float(np.mean(m.frame_times)) if m.frame_times else None,
            "median_frame_time_s": float(np.median(m.frame_times)) if m.frame_times else None,
        }

    def ate(self, raw: bool = False):
        """Ego ATE-RMSE against ground truth after rigid alignment;
        ``raw=True`` evaluates the trajectory before refinement."""
        self.flush(_buffer=True)
        m = self.map
        poses = m.camera_poses_raw if raw else m.camera_poses
        if len(poses) < 2 or len(m.gt_poses) != len(poses):
            return None
        gt = np.stack(m.gt_poses)
        gt = np.einsum("ij,njk->nik", np.linalg.inv(gt[0]), gt)
        rmse, _ = metrics.absolute_trajectory_error(
            torch.from_numpy(np.stack(poses).astype(np.float32)),
            torch.from_numpy(gt.astype(np.float32)))
        return float(rmse)

    def refined_pair_rpe(self):
        """Per-pair camera t-RPE recomputed from the recorded trajectory."""
        m = self.map
        if len(m.camera_poses) < 2 or len(m.gt_poses) != len(m.camera_poses):
            return None
        t = lambda a: torch.from_numpy(np.asarray(a, np.float32))
        out = []
        for k in range(len(m.camera_poses) - 1):
            r = metrics.camera_rpe(
                t(np.linalg.inv(m.camera_poses[k + 1])), t(np.linalg.inv(m.camera_poses[k])),
                t(np.linalg.inv(m.gt_poses[k + 1])), t(np.linalg.inv(m.gt_poses[k])))
            out.append(float(r.t_rel))
        out = [v for v in out if np.isfinite(v)]
        return float(np.mean(out)) if out else None

    def refined_obj_metrics(self):
        """Object t-RPE and speed error recomputed against the recorded
        trajectory from each record's camera-independent P_lc."""
        m = self.map
        t = lambda a: torch.from_numpy(np.asarray(a, np.float32))
        t_rels, sp_errs = [], []
        for rec in m.obj_records:
            if not rec.has_gt or rec.P_lc is None:
                continue
            f = rec.frame
            if f < 1 or f >= len(m.camera_poses) or f >= len(m.gt_objs):
                continue
            gl, gc = m.gt_objs[f - 1], m.gt_objs[f]
            oid = rec.sem_label
            if oid not in gl or oid not in gc:
                continue
            Twc_l, Twc_c = m.camera_poses[f - 1], m.camera_poses[f]
            H = Twc_c @ rec.P_lc @ np.linalg.inv(Twc_l)
            L_w_p = m.gt_poses[f - 1] @ gl[oid]
            L_w_c = m.gt_poses[f] @ gc[oid]
            cpre_w = Twc_l[:3, :3] @ rec.centre_pre_lc + Twc_l[:3, 3]
            e = metrics.object_motion_error(t(H), t(L_w_c @ np.linalg.inv(L_w_p)), t(cpre_w),
                                            t(L_w_p[:3, 3]), t(L_w_c[:3, 3]))
            if np.isfinite(float(e.t_rel)):
                t_rels.append(float(e.t_rel))
                sp_errs.append(float(e.speed_err_rel))
        if not t_rels:
            return None, None
        return float(np.mean(t_rels)), float(np.mean(sp_errs))

    # ------------------------------------------------------------------
    def save_trajectory_kitti(self, path):
        """3x4 row-major Twc per line."""
        self.flush(_buffer=True)
        with open(path, "w") as f:
            for T in self.map.camera_poses:
                f.write(" ".join(f"{v:.9e}" for v in T[:3].reshape(-1)) + "\n")

    def save_trajectory_tum(self, path):
        """timestamp tx ty tz qx qy qz qw per line."""
        self.flush(_buffer=True)
        from scipy.spatial.transform import Rotation

        with open(path, "w") as f:
            for ts, T in zip(self.map.timestamps, self.map.camera_poses):
                q = Rotation.from_matrix(T[:3, :3]).as_quat()  # x y z w
                t = T[:3, 3]
                f.write(f"{ts:.6f} {t[0]:.7f} {t[1]:.7f} {t[2]:.7f} "
                        f"{q[0]:.7f} {q[1]:.7f} {q[2]:.7f} {q[3]:.7f}\n")

    def save_results(self, out_dir):
        """Camera trajectory, per-frame / per-object errors and object
        motions under ``out_dir``."""
        import pathlib

        out = pathlib.Path(out_dir)
        out.mkdir(parents=True, exist_ok=True)
        self.save_trajectory_kitti(out / "camera_pose.txt")
        with open(out / "metrics.txt", "w") as f:
            for k, v in self.summary().items():
                f.write(f"# {k}: {v}\n")
            for i, r in enumerate(self.map.cam_rpe_rel):
                f.write(f"cam_rpe {i + 1} {r[0]:.6f} {r[1]:.6f}\n")
            for o in self.map.obj_records:
                f.write(f"obj_rpe {o.frame} {o.track_id} {o.t_rpe_rel:.6f} "
                        f"{o.r_rpe_rel:.6f} {o.speed_err_rel:.6f}\n")
        with open(out / "object_motion.txt", "w") as f:
            for o in self.map.obj_records:
                f.write(f"{o.frame} {o.track_id} {o.sem_label} "
                        + " ".join(f"{v:.9e}" for v in o.H[:3].reshape(-1))
                        + f" {o.speed_est:.4f}\n")


def run_sequence(seq, cfg: PipelineConfig = DEFAULT_CONFIG, n_frames: Optional[int] = None,
                 verbose: bool = False, **system_kw):
    """Drive a sequence (anything with ``len`` and ``load_frame(i)``)
    through a ``MultiMotSystem(cfg, **system_kw)``; frame i+1 is loaded,
    packed and uploaded on a prefetch thread while frame i is tracked.
    Returns the system (call ``summary()``)."""
    from concurrent.futures import ThreadPoolExecutor

    sys_ = MultiMotSystem(cfg, **system_kw)
    n = len(seq) if n_frames is None else min(n_frames, len(seq))

    def prep(i):
        fd = seq.load_frame(i)
        return fd, sys_.upload(fd)

    with ThreadPoolExecutor(1) as pool:
        fut = pool.submit(prep, 0)
        for i in range(n):
            fd, handles = fut.result()
            if i + 1 < n:
                fut = pool.submit(prep, i + 1)
            r = sys_.track_rgbd(fd, uploaded=handles)
            if verbose and r is not None:
                print(f"frame {i}: cam RPE t={float(r.cam_t_rpe_rel) * 100:.4f}% "
                      f"R={float(r.cam_r_rpe_rel):.4f}deg/m "
                      f"inliers={int(r.n_static_inliers)}/{int(r.n_static)} "
                      f"objects={int(np.asarray(r.objects.active).sum())}")
    sys_.flush(_buffer=True)
    return sys_
