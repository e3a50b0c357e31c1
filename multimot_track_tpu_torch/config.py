"""Typed configuration for the whole framework.

The reference scatters these values as magic numbers through Tracking.cc /
Optimizer.cc / Frame.cc (see each field's citation).  Here they live in one
frozen dataclass so every stage is reproducible and sweepable.

All shape-determining fields (``n_static_max`` etc.) are static: every
padded tensor of the pipeline takes its size from them.

A copy of ``multimot_track_tpu.config`` (that package imports jax at import
time); tests/test_torch_geometry.py pins every field and default to the
original.  The comments' timings were measured on the JAX package's TPU
runs, not on this port.
"""

from __future__ import annotations

import dataclasses
from typing import Tuple


@dataclasses.dataclass(frozen=True)
class CameraConfig:
    """Pinhole intrinsics (reference: kitti_sample/kitti03.yaml)."""

    fx: float = 721.5377
    fy: float = 721.5377
    cx: float = 609.5593
    cy: float = 172.8540
    bf: float = 387.5744          # baseline * fx  (Camera.bf)
    width: int = 1242
    height: int = 375
    fps: float = 10.0
    depth_map_factor: float = 100.0   # DepthMapFactor (TUM-style depth pngs)
    # Brown-Conrady lens distortion (Camera.k1/k2/p1/p2/k3 in the OpenCV
    # settings YAML; reference undistorts keypoint coordinates only,
    # src/Frame.cc:787-811).  All-zero = pinhole (KITTI rectified).
    k1: float = 0.0
    k2: float = 0.0
    p1: float = 0.0
    p2: float = 0.0
    k3: float = 0.0

    @property
    def has_distortion(self) -> bool:
        return any(v != 0.0 for v in (self.k1, self.k2, self.p1, self.p2, self.k3))

    @property
    def K(self) -> Tuple[Tuple[float, float, float], ...]:
        return ((self.fx, 0.0, self.cx), (0.0, self.fy, self.cy), (0.0, 0.0, 1.0))


@dataclasses.dataclass(frozen=True)
class FrontendConfig:
    """Feature sampling (reference: src/Frame.cc:188-324)."""

    obj_sample_step: int = 4        # dense grid step on instance masks (Frame.cc:189)
    obj_max_depth: float = 25.0     # dense sample depth gate (Frame.cc:196)
    static_max_depth: float = 40.0  # static keypoint depth gate (Frame.cc:240)
    n_features: int = 4000          # ORBextractor.nFeatures
    n_levels: int = 8               # ORBextractor.nLevels
    scale_factor: float = 1.2       # ORBextractor.scaleFactor
    fast_threshold: int = 20        # ORBextractor.iniThFAST
    fast_min_threshold: int = 7     # ORBextractor.minThFAST
    grid_cols: int = 64             # spatial-uniformity grid for corner top-k
    grid_rows: int = 24             # (replaces DistributeOctTree, SURVEY §7)


@dataclasses.dataclass(frozen=True)
class PaddingConfig:
    """Static shapes: every dynamic count is padded to these and masked."""

    n_static_max: int = 2048        # static (background) tracked points
    n_obj_pts_max: int = 8192       # dense object points per frame
    # concurrent-object slots.  The KITTI-format masks clamp labels to
    # 1..3 (rgbd_tum.cc:335), but the reference's association tables
    # handle ~12 concurrent objects (src/Tracking.cc:704-748); 8 covers
    # the long multi-mover scenes (io/synth circuit/avenue) with margin —
    # the vmapped object ensemble scales linearly in K (PERF.md), so
    # raise/lower to trade device time for capacity
    k_obj_max: int = 8
    # per-object gather size for the motion solvers: close KITTI objects
    # carry ~3k dense samples at step 4, so 4096 keeps effectively all of
    # them while halving the padded-solver work
    n_per_obj_max: int = 4096
    # slots actually SOLVED per frame (0 = all k_obj_max).  The vmapped
    # ensemble solve is the dominant device cost and scales linearly in
    # the batch; association/bookkeeping capacity stays k_obj_max while
    # the solve batch covers the top-k populated labels — empty slots
    # solve to identity anyway, so k_obj_solve >= concurrent movers is
    # lossless.  Measured on-chip (KCURVE.json): (8 slots, solve 4) costs
    # 28.9 ms/pair == the old K=4 program's 28.7; solve 6 pays +36%,
    # solve 8 +82%.  Default 6 is picked from the dense-traffic A/B
    # (KOBJ_AB.json, 8 concurrent movers): solve 4 permanently LOSES the
    # lowest-ranked mover (7% coverage) and starves another (29%), while
    # solve 6 retains all 8 labels at >=66% coverage with flat accuracy;
    # solve 8 adds only +4% mean coverage for +34% more cost.  The
    # reference solves every object sequentially (Tracking.cc:1658-2253).
    k_obj_solve: int = 6


@dataclasses.dataclass(frozen=True)
class SolverConfig:
    """Flow-BA + RANSAC hyperparameters.

    The camera and object solvers share one kernel; only these numbers
    differ (reference: src/Optimizer.cc:396-601 PoseOptimizationFlow2Cam and
    src/Optimizer.cc:2170-2377 PoseOptimizationFlow2).
    """

    # --- flow bundle adjustment (Levenberg-Marquardt, Schur over flow) ---
    cam_rp_thres: float = 0.04      # camera chi2 inlier gate (Optimizer.cc:398)
    obj_rp_thres: float = 0.01      # object chi2 inlier gate (Optimizer.cc:2172)
    cam_flow_prior_info: float = 0.3  # unary flow prior weight (Optimizer.cc:502)
    obj_flow_prior_info: float = 0.5  # (Optimizer.cc:2278)
    reproj_info: float = 0.1        # binary reprojection edge weight (Optimizer.cc:465)
    # LM iteration caps.  The reference caps at 100/200 (Optimizer.cc:520,
    # :2296); with the rel_tol freeze our LM converges by ~10-20 iterations
    # on kitti_sample (tools/diag_iters.py: identical metrics down to 20/40)
    # — 50/100 keeps a 2x safety margin and cuts the device critical path
    # ~20% (PERF.md)
    cam_lm_iters: int = 50
    obj_lm_iters: int = 100
    lm_tau: float = 1e-5            # initial lambda = tau * max(diag H)
    # --- RANSAC initialisation (reference: Tracking.cc:4324-4443) ---
    ransac_iters: int = 500         # ego hypothesis count (Tracking.cc:4362)
    # objects benefit from more hypotheses than the reference's 500 —
    # batched generation/scoring is cheap on TPU and measurably improves
    # the inlier subset (PARITY.md: object RPE 13% -> ~6%); 1000 measured
    # equal-or-better than 2000 once the 3-stream seed ensemble provides
    # redundancy (obj 5.6% / speed 2.4% at 1000 vs 5.8% / 2.4% at 2000;
    # 500 degrades to 6.0% / 4.1%)
    obj_ransac_iters: int = 1000
    ransac_reproj_px: float = 0.3   # inlier reprojection gate (Tracking.cc:4363)
    # objects deviate from the reference's 0.3 px: flow on moving objects is
    # blurred, so 0.3 px keeps only 3-5% of points — too few/clustered to
    # constrain rotation.  1.0 px triples the inlier set and halves measured
    # object RPE (tools/diag_obj.py); final accuracy is restored by the
    # chi2 re-classification rounds below.
    obj_ransac_reproj_px: float = 1.0
    # use the propagated previous motion as an init-model alternative for
    # objects (GetInitModelObj); can be disabled to force pure RANSAC init
    obj_motion_model_init: bool = True
    # --- object seed ensemble + composite consensus (no reference
    # counterpart): run the full init->solve->reclassify chain under
    # independent RANSAC streams, project each candidate's members and
    # keep the motion whose members both photometrically register against
    # the last frame AND agree with the measured stereo 3-D.
    # The RANSAC stream is the dominant variance of the object solve
    # (3-11% RPE spread across seeds, tools/diag_obj.py); within-strategy
    # selection is robust where cross-strategy selection is gameable
    # (candidates that overfit one witness). ---
    obj_ensemble: bool = True
    obj_ensemble_seeds: int = 3
    # --- witness subsampling (device-time dominated by these two stages:
    # ablated 144 ms/pair -> ~105 ms is ensemble consensus patch scoring,
    # ~10 ms/stream is RANSAC hypothesis scoring over all members).  Both
    # stages estimate PROPORTIONS (registered-member fraction; inlier
    # count rank), so a strided subsample of the compacted members
    # suffices: at 512 samples the proportion std-error is ~2%, far
    # below the 5-10% inter-stream consensus gaps and the RANSAC ranking
    # margins.  The winner's inlier set and all solves still use every
    # member.  0 = use all members. ---
    obj_ransac_score_pts: int = 512
    obj_consensus_pts: int = 512
    obj_zncc_gate: float = 0.9      # member gate for photometric witnesses
    obj_consensus_zncc: float = 0.8  # patch-verification bar for scoring
    # after the first solve on the init-model inliers, re-classify ALL
    # member points by solver chi2 and re-solve (redescending iteration,
    # the batched analog of g2o's per-round outlier levels)
    obj_reclassify_rounds: int = 2
    refine_gn_iters: int = 10       # polish best hypothesis on inliers
    # --- camera-solve consensus pre-gate: restrict the flow-BA set to
    # points within this reprojection radius of the init pose (RANSAC or
    # motion model).  The reference protects its solves by EXCLUDING
    # chi2-outliers between optimization rounds (Optimizer.cc:539-565,
    # 4 rounds x 10 iters); without that exclusion a coherent near-object
    # cluster (a large unmasked mover) can walk the Huber LM out of the
    # static basin entirely (measured: 42 van points of 743 move the
    # solve 0.5 m, tools notes in tests/test_maskless_ego.py).  6 px is
    # ~4x the verified-flow noise and ~4x below a mover's discrepancy. ---
    cam_init_consensus_px: float = 6.0
    # --- depth-variance weighting of the ego reprojection edges: info
    # scale 1/(1 + (z/z0)^2), the reference's own noise model sigma_z ~ z^2
    # (Frame.cc:1089) turned into inverse-variance weights.  Measured: far
    # (z>15 m) provided-disparity depth is ~5% over-estimated on kitti and
    # stretches the translation scale +2% (tools/diag_scale_bias.py);
    # weighting removes the bias without discarding far points' rotation
    # information.  0 disables. ---
    cam_depth_weight_z0: float = 15.0
    # --- flow-BA backend: "auto" = the fused Pallas LM kernel on TPU
    # (solvers/flow_ba_pallas.py, 4.8x on the batched object path), pure
    # XLA elsewhere; "xla"/"pallas" force one side ---
    flow_ba_backend: str = "auto"
    # --- photometric flow verification (ops/photometric.py; no reference
    # counterpart — the reference trusts .flo unconditionally and pays for
    # it in coherent outlier clusters, measured in tools/diag_ego3.py) ---
    zncc_patch_radius: int = 2      # (2r+1)^2 intensity patch
    zncc_min: float = 0.9           # keep static points whose flow verifies
    min_gated_static: int = 100     # fall back to the ungated set below this
    # --- symmetric camera solve: fuse the forward solve (anchored on the
    # last frame's depth) with a backward solve (anchored on the current
    # frame's depth).  Cancels first-order per-frame depth bias; the
    # reference has the same idea dormant as PoseOptimizationForBack
    # (src/Optimizer.cc:2889) ---
    symmetric_cam: bool = True
    # --- scene-flow reclassification of the static set: after the first
    # camera solve, drop 'static' points whose 3-D scene flow exceeds
    # sf_cam_gate + sf_cam_depth_coeff * z^2 (metres, x-z norm like the
    # object classifier, Tracking.cc:1463) and re-solve.  The z^2 term
    # absorbs disparity noise (delta_z = z^2/bf * delta_d), so only points
    # moving beyond their depth-noise band are dropped.  0 = off.
    # Essential in mask-free mode, where moving-object points pass the
    # photometric gate (their flow is genuinely correct — for the object)
    # and contaminate the ego solve. ---
    sf_cam_gate: float = 0.0
    sf_cam_depth_coeff: float = 0.002
    # --- synthetic depth-noise injection (Frame.cc:1089, testing mechanism) ---
    depth_noise: bool = False       # sigma = z^2/(725*0.5)*scale when enabled
    depth_noise_scale: float = 0.15
    # --- synthetic outlier-flow injection (the reference's commented
    # robustness-study injector, Frame.cc:276-301): a random fraction of
    # flow pixels gets Gaussian outlier offsets ---
    flow_outliers: bool = False
    flow_outlier_frac: float = 0.1
    flow_outlier_mag: float = 15.0


@dataclasses.dataclass(frozen=True)
class SegmentationConfig:
    """Scene-flow-based motion segmentation (reference: Tracking.cc:1392-1635)."""

    boundary_margin_v: float = 25.0   # image-top/bottom margin (Tracking.cc:1437)
    boundary_margin_u: float = 50.0   # image-left/right margin
    boundary_frac: float = 0.5        # discard object if > frac on boundary
    min_obj_points: int = 100         # discard small objects (Tracking.cc:1447)
    sf_thres: float = 0.12            # scene-flow x-z magnitude gate (Tracking.cc:1463)
    sf_percent: float = 0.3           # static if > percent below sf_thres
    max_obj_depth: float = 25.0       # discard far objects (Tracking.cc:1523)


@dataclasses.dataclass(frozen=True)
class BackendConfig:
    """Live map-maintenance: trailing-window BA (LocalMapping role,
    src/LocalMapping.cc:48 + src/Optimizer.cc:3341)."""

    window_refine: bool = True      # run windowed BA inside the system loop
    window_size: int = 5            # frames per trailing window
    n_window_tracks: int = 2048     # keypoints chained from window frame 0
    window_ba_iters: int = 30
    min_window_tracks: int = 50     # skip the update below this survival
    # appearance changes over a 5-frame window, so the per-link photometric
    # gate is looser than the pairwise one (solver.zncc_min)
    window_zncc_min: float = 0.7
    # se(3) information of the online per-pair poses fused as odometry
    # prior edges (solvers/window_ba.WindowBAParams.odo_prior_weight)
    odo_prior_weight: float = 2500.0
    # TrackLocalMap (src/Tracking.cc:3189): per-frame pose refinement
    # against the accumulated keyframe map points (projection-guided
    # descriptor matching -> GN with inlier reclassification).  The
    # refined pose replaces the flow pose only past the acceptance gates
    # below; see pipeline/system._track_local_map for the measurement
    # that set the default.
    track_local_map: bool = True
    # Fuse TrackLocalMap + trailing-window BA into ONE device program
    # chained onto full_step's un-fetched output (pipeline/live_refine):
    # the live loop then blocks on a single device->host transfer per
    # frame instead of up to four.  Off = dispatch each refinement
    # separately (the reference-shaped control flow; same math).
    fused_refine: bool = True
    local_map_kfs: int = 3            # newest keyframes forming the local map
    local_map_radius_px: float = 12.0 # projection search radius
    local_map_thresh_px: float = 3.0  # inlier gate for the GN rounds
    local_map_min_inliers: int = 40   # accept only well-constrained refinements
    local_map_max_corr_m: float = 0.5   # reject translations larger than this
    local_map_max_rot_deg: float = 2.0  # ... and rotations larger than this
    # Joint ego+object sliding-window BA at keyframe cadence — the
    # LocalBundleAdjustment counterpart extended with per-object motions
    # (ref src/Optimizer.cc:3341 driven from src/LocalMapping.cc:48; the
    # object extension is the BASELINE.md "sliding-window multi-object BA"
    # target).  Observations are re-derived on device from the window's
    # buffered image tensors (zero extra upload); initialisation comes
    # from the online per-pair poses and object measurements (P_lc).
    joint_window_refine: bool = True
    joint_static_max: int = 1024      # static grid points per pair
    joint_static_stride: int = 12     # sampling stride for the static grid
    joint_obj_pts: int = 128          # object points per pair per slot
    joint_iters: int = 12             # LM iterations of the joint solve
    joint_w_smooth: float = 100.0     # constant-motion prior information
    # prior weights measured on kitti_sample (sweep in round-3 notes):
    # refined object t-RPE 0.0665 -> 0.0539 with camera RPE unchanged
    # (0.0541); weaker motion priors let the window's rawer object points
    # out-vote the online ensemble estimate and degrade it instead
    joint_w_odo: float = 4e4          # online-pose odometry prior
    joint_w_motion_prior: float = 800.0  # online object-motion prior
    joint_obj_gate_px: float = 1.5    # outlier gate at the online init
    joint_max_corr_m: float = 0.5     # acceptance gate on pose corrections
    # Post-loop global bundle adjustment (LoopClosing::RunGlobalBundleAdjustment,
    # src/LoopClosing.cc:647): after an accepted pose-graph correction,
    # jointly re-optimize ALL keyframe poses + matched landmarks against
    # the loop constraint (solvers/global_ba, dense-reduced Schur) and
    # propagate the keyframe deltas to every trajectory row.
    global_ba_on_loop: bool = True
    global_ba_iters: int = 25
    global_ba_max_obs: int = 6        # observations kept per landmark chain
    global_ba_max_corr_m: float = 2.0  # reject implausibly large corrections
    # Pipelined-mode async keyframe cadence: the keyframe-cadence device
    # work (payload capture, fuse scan, covisibility counts, place-
    # recognition scores, joint window BA) is DISPATCHED at the keyframe
    # frame and its results fetched one frame later, when the buffers are
    # long since ready — the fetches then cost transfer only, never
    # compute wait.  Corrections apply retroactively through the
    # cumulative right-factor (the same mechanism every pipelined
    # refinement rides).  This is the keyframe-cadence analog of the
    # reference's LocalMapping/LoopClosing background threads
    # (src/System.cc:92-97).  Ignored in synchronous mode.
    async_keyframes: bool = True
    # Keyframe store capacity.  The reference's Map is unbounded
    # (include/Map.h:43-90); here capacity bounds device memory/compiled
    # shapes, and overflow evicts by TEMPORAL SKELETON (keyframes.py
    # _evict_skeleton) rather than FIFO so the revisit anchor of a loop
    # longer than min_gap*capacity frames survives.  96 keyframes of
    # 1024x(32B desc + 3x4B Xw) ~ 4.3 MB host, ~17 GMAC/loop-query: cheap.
    kf_capacity: int = 96


@dataclasses.dataclass(frozen=True)
class PipelineConfig:
    camera: CameraConfig = dataclasses.field(default_factory=CameraConfig)
    frontend: FrontendConfig = dataclasses.field(default_factory=FrontendConfig)
    padding: PaddingConfig = dataclasses.field(default_factory=PaddingConfig)
    solver: SolverConfig = dataclasses.field(default_factory=SolverConfig)
    segmentation: SegmentationConfig = dataclasses.field(default_factory=SegmentationConfig)
    backend: BackendConfig = dataclasses.field(default_factory=BackendConfig)

    def replace(self, **kw) -> "PipelineConfig":
        return dataclasses.replace(self, **kw)


DEFAULT_CONFIG = PipelineConfig()
