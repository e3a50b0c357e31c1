#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port (multimot_track_tpu_torch) on one GPU.

    python3 chip_smoke.py

Phases, in order; any failure exits non-zero before the result lines:
  1. the card: ``nvidia-smi`` name and power limit, torch's device name;
  2. build kernels K1 (csrc/flow_ba_lm.cu) and K2 (csrc/match_projected.cu)
     with nvcc and the host sources (native/graphcut.cc, the exact graph-cut
     labeler; native/png_unfilter.cc, the PNG unfilter) with the host
     compiler, all four started together; print the build times and the
     compilers' register / shared-memory reports;
  3. K1 against its plain torch version on the card at the five path
     shapes (live camera 1 x 2048 and batched camera 11 x 2048 with point
     weights, live object 18 x 4096, batched object 198 x 4096, and a
     two-instance camera stage, 2 x 2048), inputs from a numpy seed; per shape the bare launch
     (outputs allocated once; CUDA events around back-to-back launches, and
     the profiler's kernel time), the wrapper-included call, the plain
     version, the LM iterations run (mean, max), the flop / byte bound and
     the share of it, and the device kernels the profiler sees per wrapper
     call; ``--k1-only`` stops after this phase;
  4. the slice: ``run_sequence_batched`` at DEFAULT_CONFIG (1242x375, 2048
     static / 8192 object points, 8 label slots, 6 solved, 3 seeds, 2
     reclassify rounds) on make_junction_frames(12) (7 movers per frame),
     once through the kernel (counting its launches) and once with the plain
     flow-BA, then ``run_sequence_streaming`` (chunk 4) once; ms per pair
     after a warm-up, peak memory, per-pair camera and object errors;
  5. K2 against its plain torch version on the card at its path shapes:
     3 x 1024 local-map queries against 1024 keypoints (r = 12), the fuse
     scan's 4 x 1024 against 1024 (r = 6), the window tracks' 3072 against
     3072 (r = 15), and the 1 x 1024 and 2 x 1024 local-map queries of the
     live run's first keyframes; seeded inputs with duplicate descriptors
     (ties), invalid rows and one all-masked row; best / second / index
     must be exactly equal, and the profiler must see exactly one device
     kernel for each call the wrapper counted; ms per call of both, the
     profiler's device time by kernel, the empty kernel on the same grid
     (the floor of one launch) and the bound from the gated pairs;
     ``--k2-only`` runs phases 1, 2 and 5 alone;
  6. the live system: ``MultiMotSystem`` at DEFAULT_CONFIG with its default
     arguments (trailing-window BA every frame, joint ego+object window BA
     at keyframe cadence, keyframes every 5 frames, fused TrackLocalMap,
     fusion and culling, keyframe culling, relocalization and loop closing
     on) on the same junction frames, synchronous and then pipelined with
     the async keyframe cadence, after one uncounted warm-up run: ms per
     frame (host clock and CUDA events around the loop), stage means (the
     loop ladder's among them), peak memory, mean camera t-RPE, ATE, refined
     object t-RPE, keyframes, fused / culled points, local-map and window
     refinements dispatched and accepted, joint window refines, K1 and K2
     launches (K2 must equal the local-map refinements plus the fuse scans,
     and be > 0; a window refinement per frame from the first full window,
     at least one accepted; at least one joint refine in sync; no loop
     event: the junction never revisits); then the synchronous run once
     more with the plain matcher, whose trajectory must agree with the
     kernel run to 1e-4, and once with both windows off;
  7. the window solvers: ``refine_trailing_window`` and
     ``refine_joint_window`` on frames 0-4 with the synchronous run's poses
     and object measurements, on the card and on the CPU (poses and
     motions within 1e-3, live tracks within 2), ms per call of both; then
     ``build_window_tracks`` on frames 0-4 through K2 and through the plain
     matcher (identical tracks, 4 K2 launches);
  8. the live loop ladder: a shuttle at the KITTI camera with
     ``default_movers()`` (forward 0.3 m per frame over SHUTTLE_N positions,
     then back over the same path) through ``MultiMotSystem`` at
     DEFAULT_CONFIG with ``keyframe_gap=2`` and ``loop_consistency=1``:
     synchronous, pipelined, then synchronous with loop closing off, on the
     same uploaded frames; per run ms per frame (host clock and CUDA
     events), the ladder's stage mean, the loop events (frame, keyframe
     frame, Sim3 inliers), each global BA's verdict and stats, ATE and
     refined t-RPE, K1 and K2 launches and peak memory.  The synchronous
     run must close a loop (frame - keyframe frame >= 4, >= 20 inliers);
     every output finite, accuracy inside phase 6's bounds, K2 launches ==
     local-map refinements + fuse scans;
  8b. the ladder's solvers at full size, card against CPU on seeded
     problems: ``ransac_sim3`` (N = 1024, 300 hypotheses from one fixed
     index array), ``optimize_pose_graph`` (M = 256, the dense / CG switch),
     ``optimize_pose_graph_cg`` (M = 1000; its agreement checked in float64,
     as float32 CG there sits at its own rounding floor) and
     ``solve_global_ba`` (K = 24, 2048 landmark rows, O = 6, 25 iterations);
     rotations and scale within 1e-3, translations and landmarks within
     1e-3 of the problem's extent, Sim3 inliers within 2; ms per call on
     each device (float32);
  9. BoW place recognition at scale, the card against the CPU: a store of
     520 keyframes x 1024 keypoints x 256 bits (capacity 1024, ~136 MB of
     descriptors on the card) with one fixed vocabulary-seed array, queried
     with a noisy revisit of keyframe 137.  Fails unless the vocabulary
     words and every signature agree within 1e-5, the shortlists and exact
     scores are equal, and ``detect_loop`` finds 137 on both; ms of
     ``similarity_scores`` on the card: the first call (training the
     vocabulary), a warm call at 520 keyframes, the exact batched path at
     48 keyframes;
  9b. phase 8's synchronous shuttle once more with ``bow_threshold = 3``
     (every place recognition from the fourth keyframe on is two-stage; the
     shortlist of 8 covers the at most 7 keyframes).  Fails unless the
     vocabulary was trained and the loop events (frame, keyframe frame,
     inliers) and keyframe frames equal phase 8's; ms per frame;
  10. mask-free discovery.  (a) ``motion_seg.discover_objects`` on junction
     frames 1 -> 2 at 1242x375 (step 8, n_max 1024, 24 hypotheses from one
     fixed seed array, the constant-velocity ego motion of the ground truth
     0 -> 1), on the card and on the CPU; fails unless the candidate masks
     are identical, labels agree on >= 99.5 % of them and the energies
     within rtol 1e-4; ms per call on each device (the card's split into
     the problem and the labeler, and its device busy time and kernels a
     call under the profiler), the rasteriser and the host's component
     labelling, and ``discover_objects_exact``'s energy beside the
     relaxation's.  (b) ``MultiMotSystem(discover_objects=True)`` at
     DEFAULT_CONFIG (windows on) on the junction frames, sync and
     pipelined: ms per frame, discovered instances per frame, object
     records with ground truth, track IDs, mean camera t-RPE, ATE, K1 and
     K2 launches, peak memory; fails unless some frame has an instance,
     some record has ground truth, mean camera t-RPE < 0.10, every output
     is finite and K2 launches == local-map refinements + fuse scans;
  11. the sequence entry points.  (a) The junction frames written as a
     KITTI tree (8-bit RGB PNG through ``write_png``, 16-bit depth PNG,
     .flo, mask text, poses, times) under build/scratch/entry/ (~66 MB,
     removed afterwards), read back through ``KittiSequence``: frames equal
     to the rendered ones up to the 8-bit rounding; the native PNG unfilter
     equal to its plain version; ms per frame of PNG decode, .flo, mask
     text and ``load_frame``.  (b) ``cli.run`` (the body
     of ``cli.main``) on that tree at DEFAULT_CONFIG: K1 > 0, K2 ==
     refinements + fuse scans, t-RPE < 0.05, ATE < 0.5 m, ms per frame
     beside phase 6's.  (c) A 14-frame stereo tree at the KITTI camera
     through ``--stereo --discover-objects`` and ``--stereo --quad-stereo``
     (the same launch checks, quad matches > 0; accuracy reported: the LK
     flow loses frames 8-12 of that tree in the JAX package too);
     ``dense_disparity`` and ``dense_flow`` on the card against the CPU
     (integer disparities equal, sub-pixel within 1e-4, flow within the
     CPU tests' bounds) and their ms a call with the quad gate's; then
     ``tools/measure_quad_ab.py``'s configuration (640x384, 1024 / 4096
     points, ``max_disp=64``, both textures, quad off and on), each row
     replaying the JAX package's hypotheses (``tools/quad_ab_draws/``),
     beside ``QUAD_AB.json``: ATE < 0.5 m where that file's row meets it;
     the default quad-on row on the port's own draws reported.  (d) A
     6-frame TUM tree through ``--tum --discover-objects``, and 4 frames of
     the KITTI tree served through ``serve_connection`` over a socketpair,
     with and without flow arrays: every reply equal to an in-process
     ``track_rgbd`` to 1e-6.  The CLI's own output goes to
     entry_cli_*.log under ``--logs DIR`` (default
     build/scratch/smoke_logs/); ``--entry-only`` runs phases 1, 2 and 11.
  12. monocular tracking: ``MonoTracker`` on the mono-junction-8 cell
     (``make_junction_frames(43, cam=KITTI_SYNTH_CAM, texture="distinct",
     times=range(0, 43, 6))``), every run on the JAX package's seed-0
     hypotheses replayed (``tools/mono_draws/``, written by
     ``tools/mono_draws.py record``).  (a) The 8 frames with the backend
     on (``keyframe_gap=2``) and off: initialisation frame, LOST frames,
     keyframes, TrackLocalMap accepts, each step's direction cosine and
     scale ratio against the ground truth, ms per frame, K2 launches;
     fails unless initialised at frame 1 with no LOST frame, every cosine
     > 0.9 and K2 launched.  (a') The 15-frame shuttle (forward, then back
     to the start) on the card, then on the CPU (one thread): fails unless
     the card closes a loop and both runs have the same events (LOST,
     relocalizations, keyframes, accepts, loops with their inliers, scales
     within 1e-3) and poses within 1e-3; ``close_loop`` ms.  (b) The
     shuttle through the plain matcher: the same events, poses within
     1e-4; K2 against its plain version on the tracker's own last
     tracked-mode match (1024 vs 1024, r = 18) and TrackLocalMap match (r =
     12), exactly equal and one device kernel a call, with the profiler's
     device ms, the wrapper's ms, the plain version's and the bound.  The
     8 frames on host-generator draws (seed 0), reported.  (c) The CLI on
     the card: ``--mono`` over the frames as a KITTI tree, ``--euroc`` over
     an EuRoC tree and ``--tum --mono`` over a TUM tree (its intrinsics
     guessed), under build/scratch/mono/ (removed afterwards): the
     summary, the initialisation frame, ms per frame, K2; the trajectory
     file must hold a finite pose per frame.  ``--mono-only`` runs phases
     1, 2 and 12.
  13. the rest of the single-card surface.  (a) Frames 0-23 of the
     220-frame circuit (``make_circuit_frames(220, times=range(25))`` at
     the KITTI camera) through ``MultiMotSystem`` at DEFAULT_CONFIG, live
     and synchronous: render time, ms per frame, K1 and K2 launches;
     fails unless every pose is finite, camera t-RPE mean < 0.02 and ATE
     < 0.60 m (tests/test_long_seq.py's circuit bounds), K1 > 0 and K2 ==
     refinements + fuse scans.  (e) Frame 24 through the same system and
     SIFT on it, inside ``utils/profiling.trace`` (a Chrome trace under
     build/profile/) and a ``StageTimer``: the trace must hold both
     annotated names and device kernels.  (b) ``frontend/sift.extract_sift``
     on that 1242x375 frame at n_max 1024, the card against the CPU: >= 99
     % of the valid keypoints identical in position and scale, an angle
     that differs only where the CPU's orientation histogram ties the two
     bins, descriptors within 1e-4 (of the CPU's descriptor at the card's
     angle where they differ); ms a call.  (c) ``solve_flow_depth_ba`` at
     N = 4096 (seeded), the card against the CPU: max |dT| <= 1e-4, equal
     inliers; ms a call.  (d) The CLI with ``--viz --out`` on frames 0-3
     as a KITTI tree: speed_000001-3.png at 1242x375 and a traj.png with
     drawn pixels, read back with ``io/png.read_png``.
     ``--surface-only`` runs phases 1, 2 and 13.
Then the loop figures' JSON line, the JSON lines of phases 9-10, 11, 12 and 13, one JSON
line of kernel figures (K1's launches from the synchronous live run, K2's
from it and, as ``mono_launches``, from phase 12's 8 frames with the
backend on; as ``circuit_launches``, each kernel's from phase 13(a)), the
nvidia-smi line, and the final ``{"ok": true, "device": ...}`` line.
Imports nothing of JAX.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys
import time

import numpy as np

REPO = os.path.dirname(os.path.abspath(__file__))
KERNELS = ("flow_ba_lm", "match_projected")
# native/<name>.cc, built with the host compiler: the exact graph-cut
# labeler and the PNG unfilter
NATIVE = ("graphcut", "png_unfilter")
ENTRY_DIR = os.path.join(REPO, "build", "scratch", "entry")
LOG_DIR = os.path.join(REPO, "build", "scratch", "smoke_logs")  # default of --logs
STEREO_N, TUM_N, SERVE_N = 14, 6, 4     # phase 11's stereo, TUM and served frames

# K1 contract with its plain version (the Pallas-vs-XLA contract of the JAX
# package, tests/test_flow_ba_pallas.py): float32 sums in another order
T_ATOL, INLIER_TOL, REPROJ_RTOL = 2e-4, 2, 0.05
# the live system through K2 against the plain matcher: K2 is exact, so any
# difference comes from elsewhere (float32 solves repeat run to run)
LIVE_T_ATOL = 1e-4


def log(*a):
    print(*a, flush=True)


def nvidia_smi() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    )
    return out.stdout.strip().splitlines()[0]


def make_flow_ba_problem(rng, M, N, xi_scale, n_valid_frac=0.85, outlier_frac=0.1):
    """M seeded flow-BA instances at KITTI intrinsics: points at 4-30 m,
    a per-instance true motion, 0.05 px flow noise, 10 % gross outliers."""
    import torch

    from multimot_track_tpu_torch.geometry import camera, se3
    from multimot_track_tpu_torch.config import CameraConfig

    c = CameraConfig()
    uv = np.stack([rng.uniform(50, 1150, (M, N)), rng.uniform(50, 330, (M, N))], -1)
    depth = rng.uniform(4.0, 30.0, (M, N))
    valid = rng.uniform(size=(M, N)) < n_valid_frac
    xi = rng.normal(0, 1, (M, 6)) * xi_scale
    t = lambda a: torch.from_numpy(np.asarray(a, np.float32))
    T_true = se3.exp_se3(t(xi))
    X = camera.backproject(t(uv), t(depth), c.fx, c.fy, c.cx, c.cy)
    uv1 = camera.project(se3.transform(T_true, X), c.fx, c.fy, c.cx, c.cy).numpy()
    flow = uv1 - uv + rng.normal(0, 0.05, (M, N, 2))
    out = rng.uniform(size=(M, N)) < outlier_frac
    flow[out] += rng.normal(0, 20.0, (int(out.sum()), 2))
    eye = np.tile(np.eye(4, dtype=np.float32), (M, 1, 1))
    return dict(T_init=t(eye), Twl=t(eye), obs=t(uv), flow_meas=t(flow), depth=t(depth),
                valid=torch.from_numpy(valid), fx=c.fx, fy=c.fy, cx=c.cx, cy=c.cy)


def time_ms(fn, rounds, reps):
    """Median over ``rounds`` of the mean ms per call of ``fn``, each round
    ``reps`` calls issued back to back between two CUDA events, after one
    warm-up call.  Back to back, the device's queue stays fed whenever the
    host enqueues faster than the device runs, so host jitter between calls
    drops out."""
    import torch

    fn()
    ts = []
    for _ in range(rounds):
        a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        torch.cuda.synchronize()
        a.record()
        for _ in range(reps):
            fn()
        b.record()
        b.synchronize()
        ts.append(a.elapsed_time(b) / reps)
    return float(np.median(ts))


# K1's bound, counted from the algorithm (csrc/flow_ba_lm.cu's note has the
# breakdown): float32 operations per point per LM iteration (pass 1:
# linearise, Schur terms, 21 + 6 products; pass 2: back-substitution, trial
# objective), and once per solve (back-projection, lambda seed, initial
# objective; final chi2 and inlier sums)
K1_FLOPS_PER_POINT_ITER = 295
K1_FLOPS_PER_POINT_ONCE = 120
H100_FP32_FLOPS = 67e12        # published peak outside the tensor cores
H100_BYTES_PER_S = 3.35e12     # HBM3


def k1_stages():
    """K1's five path shapes: (name, M, N, weighted, camera stage)."""
    return (("live camera 1 x 2048 (point weights)", 1, 2048, True, True),
            ("live object 18 x 4096", 18, 4096, False, False),
            ("batched camera 11 x 2048 (point weights)", 11, 2048, True, True),
            ("batched object 198 x 4096", 198, 4096, False, False),
            ("two-instance camera 2 x 2048 (point weights)", 2, 2048, True, True))


def k1_bound_us(args, out, iters):
    """The least time the card could take for one solve on these inputs:
    the larger of the flops the LM loop needs (its valid points at the
    iterations each instance ran, every point once), over the fp32 peak,
    and each input read once and each output written once, over the memory
    rate.  Returns (us, 'bytes' or 'operations', flop us, byte us)."""
    import torch

    M, N = args["obs"].shape[:2]
    n_valid = (args["valid"] & (args["depth"] > 0)).sum(1).float().cpu()   # the LM skips the rest
    flops = K1_FLOPS_PER_POINT_ONCE * M * N + K1_FLOPS_PER_POINT_ITER * float((n_valid * iters).sum())
    tensors_in = [v for v in args.values() if isinstance(v, torch.Tensor)]
    byts = sum(t.numel() * t.element_size() for t in tensors_in)
    byts += sum(t.numel() * t.element_size() for t in out if isinstance(t, torch.Tensor))
    t_ops, t_bytes = flops / H100_FP32_FLOPS, byts / H100_BYTES_PER_S
    return (1e6 * max(t_ops, t_bytes), "operations" if t_ops >= t_bytes else "bytes",
            1e6 * t_ops, 1e6 * t_bytes)


PROFILE_WARMUP = 3             # untimed calls in the profiler's warm-up step
PROFILE_PAD_S = 0.002          # host idle time at either end of the counted calls


def kernel_split(fn, reps=10):
    """{device kernel name: (launches per call, mean device us per launch)}
    of ``fn`` over ``reps`` calls under the profiler (CUPTI's kernel
    records), after one call outside the profiler and PROFILE_WARMUP in its
    warm-up step, with PROFILE_PAD_S of idle host time between the counted
    calls and either end of the recorded step.  Without the warm-up step,
    sessions that followed the junction scene's render lost the kernel
    records of their first calls; without the pads, a session now and then
    lost one record at an end of its window."""
    import torch
    from torch.profiler import ProfilerActivity, profile, schedule

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA],
                 schedule=schedule(wait=0, warmup=1, active=1, repeat=1)) as prof:
        for _ in range(PROFILE_WARMUP):
            fn()
        torch.cuda.synchronize()
        prof.step()
        time.sleep(PROFILE_PAD_S)
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
        time.sleep(PROFILE_PAD_S)
        prof.step()
    split = {}
    for e in prof.events():
        if e.device_type == torch.autograd.DeviceType.CUDA \
                and not e.name.startswith(("Memcpy", "Memset", "ProfilerStep")):
            n, us = split.get(e.name, (0, 0.0))
            split[e.name] = (n + 1, us + e.time_range.elapsed_us())
    return {k: (n / reps, us / n) for k, (n, us) in split.items()}


def one_kernel_split(fn, sessions=3):
    """(kernel_split of ``fn``, profiler sessions taken) for an ``fn`` that
    launches one device kernel a call.  A session whose records come back
    fewer than the calls is repeated, up to ``sessions`` in all: CUPTI was
    seen to lose records now and then, never to add one, so a second
    kernel still reads above one a call."""
    for k in range(1, sessions + 1):
        split = kernel_split(fn)
        if sum(n for n, _ in split.values()) >= 1:
            break
        log(f"[profiler] session {k} returned {split} for one kernel a call; again")
    return split, k


def per_call_us(split) -> float:
    """Device us per call from a kernel split: each kernel's mean time per
    launch times its launches per call."""
    return sum(us * n for n, us in split.values())


def short_name(kernel: str) -> str:
    """A device kernel's name without namespace, template and arguments."""
    name = kernel.replace("(anonymous namespace)::", "").removeprefix("void ")
    return name.split("<")[0].split("(")[0].split("::")[-1]


def device_kernels(fn, reps=10):
    """(device kernels per call, device us per call) of ``fn``."""
    split = kernel_split(fn, reps)
    return sum(n for n, _ in split.values()), per_call_us(split)


def phase_kernel_vs_plain(dev):
    import torch

    from multimot_track_tpu_torch.config import SolverConfig
    from multimot_track_tpu_torch.solvers import flow_ba, flow_ba_cuda
    from multimot_track_tpu_torch.solvers.flow_ba_cuda import solve_flow_ba_cuda

    lib = flow_ba_cuda._lib()
    per_sm = {P: lib.flow_ba_lm_ctas_per_sm(P) for P in flow_ba_cuda.CTAS_PER_SM}
    log(f"[K1] CTAs per SM by held points per thread, as the card reports them: {per_sm} "
        f"(the cluster plan assumes {flow_ba_cuda.CTAS_PER_SM})")
    if per_sm != flow_ba_cuda.CTAS_PER_SM:
        raise SystemExit("K1's occupancy differs from what its cluster plan assumes")
    sol = SolverConfig()
    rng = np.random.default_rng(0)
    cam_xi = np.array([0.004, 0.004, 0.004, 0.1, 0.05, 0.5])
    obj_xi = np.array([0.01, 0.01, 0.01, 0.2, 0.05, 0.4])
    figures = []
    for name, M, N, weighted, is_cam in k1_stages():
        prob = make_flow_ba_problem(rng, M, N, cam_xi if is_cam else obj_xi)
        prob["point_weight"] = (1.0 / (1.0 + (prob["depth"] / sol.cam_depth_weight_z0) ** 2)
                                if weighted else None)
        params = flow_ba.FlowBAParams(
            reproj_info=sol.reproj_info,
            prior_info=sol.cam_flow_prior_info if is_cam else sol.obj_flow_prior_info,
            rp_thres=sol.cam_rp_thres if is_cam else sol.obj_rp_thres,
            iters=sol.cam_lm_iters if is_cam else sol.obj_lm_iters, tau=sol.lm_tau)
        args = {k: (v.to(dev) if isinstance(v, torch.Tensor) else v) for k, v in prob.items()}
        run_k = lambda: solve_flow_ba_cuda(**args, params=params)
        run_p = lambda: flow_ba.solve_flow_ba(**args, params=params)
        out_k = run_k()
        torch.cuda.synchronize()
        out_p = run_p()
        torch.cuda.synchronize()
        dT = float((out_k.T - out_p.T).abs().max())
        dn = int((out_k.n_inliers - out_p.n_inliers).abs().max())
        rel = float(((out_k.mean_reproj - out_p.mean_reproj).abs()
                     / out_p.mean_reproj.abs().clamp(min=1e-12)).max())
        finite = bool(torch.isfinite(out_k.T).all() and torch.isfinite(out_k.chi2).all())
        bare = flow_ba_cuda._launcher(**args, params=params)
        iters = bare().float().cpu()
        torch.cuda.synchronize()
        ms_bare = time_ms(bare, rounds=5, reps=20)
        ms_k = time_ms(run_k, rounds=5, reps=10)
        ms_p = time_ms(run_p, rounds=3, reps=2)
        n_kern, _ = device_kernels(run_k)
        _, us_dev = device_kernels(bare)
        bound_us, bound_by, ops_us, bytes_us = k1_bound_us(args, out_k, iters)
        log(f"[K1] {name}: cluster plan (C, P) {flow_ba_cuda.cluster_plan(M, N)}; "
            f"max|dT|={dT:.3e} (atol {T_ATOL}) max|d n_inliers|={dn} "
            f"(tol {INLIER_TOL}) max rel d mean_reproj={rel:.3e} (rtol {REPROJ_RTOL})")
        log(f"[K1] {name}: bare launch {ms_bare:.4f} ms (CUDA events), {us_dev / 1e3:.4f} ms "
            f"(profiler kernel time), wrapper "
            f"{ms_k:.4f} ms/call, plain {ms_p:.4f} ms | LM iterations mean "
            f"{float(iters.mean()):.2f} max {int(iters.max())} | bound {bound_us:.2f} us by "
            f"{bound_by} (flops {ops_us:.3f} us, bytes {bytes_us:.3f} us), "
            f"{100 * bound_us / (1e3 * ms_bare):.2f} % of bound | {n_kern} device kernel(s) "
            f"per wrapper call")
        if not (finite and dT <= T_ATOL and dn <= INLIER_TOL and rel <= REPROJ_RTOL):
            raise SystemExit(f"K1 disagrees with its plain version on {name}")
        figures.append(dict(stage=name, max_abs_err=dT, ms=us_dev / 1e3, events_ms=ms_bare,
                            wrapper_ms=ms_k, plain_ms=ms_p, bound_ms=bound_us / 1e3,
                            bound_by=bound_by, kernels_per_call=n_kern))
    return figures


def finite_tree(res) -> bool:
    from multimot_track_tpu_torch.pipeline.frames import tree_map

    ok = []
    tree_map(lambda x: ok.append(bool(np.all(np.isfinite(x)))
                                 if np.issubdtype(np.asarray(x).dtype, np.floating)
                                 else True), res)
    return all(ok)


def phase_slice(dev, frames):
    import torch

    from multimot_track_tpu_torch.config import DEFAULT_CONFIG
    from multimot_track_tpu_torch.pipeline import batch
    from multimot_track_tpu_torch.solvers.flow_ba_cuda import solve_flow_ba_cuda

    cfg = DEFAULT_CONFIG
    n_pairs = len(frames) - 1
    n_chunks = -(-n_pairs // 16)

    solve_flow_ba_cuda.launches = 0
    torch.cuda.reset_peak_memory_stats(dev)
    t0 = time.perf_counter()
    Tcw, res_k, rec_k = batch.run_sequence_batched(frames, cfg, seed=0, device=dev)
    torch.cuda.synchronize(dev)
    first_s = time.perf_counter() - t0
    launches = solve_flow_ba_cuda.launches
    peak = torch.cuda.max_memory_allocated(dev)
    log(f"[slice] batched (kernel): {first_s:.2f} s first run, K1 launches {launches} "
        f"({n_chunks} chunk(s), expect {5 * n_chunks}), peak {peak / 2**30:.3f} GiB")
    if launches != 5 * n_chunks:
        raise SystemExit(f"expected {5 * n_chunks} K1 launches, saw {launches}")
    if Tcw.shape != (len(frames), 4, 4) or len(res_k.cam_t_rpe_rel) != n_pairs:
        raise SystemExit(f"unexpected output shapes: Tcw {Tcw.shape}, "
                         f"{len(res_k.cam_t_rpe_rel)} pair results for {n_pairs} pairs")
    if not (np.all(np.isfinite(Tcw)) and finite_tree(res_k)):
        raise SystemExit("non-finite output from the kernel run")

    Tcw_p, res_p, _ = batch.run_sequence_batched(frames, cfg, seed=0, device=dev,
                                                 backend="torch")
    rpe_k = float(np.mean(res_k.cam_t_rpe_rel))
    rpe_p = float(np.mean(res_p.cam_t_rpe_rel))
    log(f"[slice] mean cam t-RPE: kernel {rpe_k:.5f}, plain {rpe_p:.5f}, "
        f"max|dTcw| kernel vs plain {np.abs(Tcw - Tcw_p).max():.3e}")
    if not (abs(rpe_k - rpe_p) < 0.01 and rpe_k < 0.05):
        raise SystemExit("camera RPE out of bounds")

    solve_flow_ba_cuda.launches = 0
    Tcw_s, res_s, rec_s = batch.run_sequence_streaming(frames, cfg, seed=0, chunk=4,
                                                       device=dev)
    log(f"[slice] streaming chunk 4: K1 launches {solve_flow_ba_cuda.launches}, "
        f"mean cam t-RPE {float(np.mean(res_s.cam_t_rpe_rel)):.5f}, "
        f"finite {bool(np.all(np.isfinite(Tcw_s)) and finite_tree(res_s))}")
    if not (np.all(np.isfinite(Tcw_s)) and finite_tree(res_s)):
        raise SystemExit("non-finite output from the streaming run")

    # steady state: the first run above was the warm-up
    ts = []
    for _ in range(3):
        torch.cuda.synchronize(dev)
        a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        t0 = time.perf_counter()
        a.record()
        batch.run_sequence_batched(frames, cfg, seed=0, device=dev)
        b.record()
        b.synchronize()
        ts.append((a.elapsed_time(b), (time.perf_counter() - t0) * 1e3))
    ev = float(np.median([t[0] for t in ts]))
    host = float(np.median([t[1] for t in ts]))
    log(f"[slice] batched steady state: {ev / n_pairs:.2f} ms/pair (CUDA events), "
        f"{host / n_pairs:.2f} ms/pair (host clock), {n_pairs} pairs, "
        f"peak {peak / 2**30:.3f} GiB")

    ob = res_k.objects
    act = np.asarray(ob.active)
    for k in range(n_pairs):
        trel = np.asarray(ob.t_rpe_rel[k])[act[k] & np.asarray(ob.has_gt[k])]
        log(f"[slice] pair {k}: cam t-RPE {float(res_k.cam_t_rpe_rel[k]):.5f} "
            f"r-RPE {float(res_k.cam_r_rpe_rel[k]):.5f} | {int(act[k].sum())} objects, "
            f"median obj t-RPE {float(np.median(trel)) if trel.size else float('nan'):.4f}")
    ids = sorted({r["track_id"] for r in rec_k})
    log(f"[slice] {len(rec_k)} object records, track ids {ids}")
    return dict(launches=launches, ms_per_pair=ev / n_pairs, peak_bytes=peak)


def make_match_problem(rng, L, N, M, radius):
    """Seeded K2 inputs at KITTI width: descriptors drawn from a pool of 32
    (exact ties), 2 % bit noise on half of them, 10 % invalid rows on both
    sides, queries near a reference (four exactly on the radius), and one
    query whose every candidate is out of range."""
    import torch

    pool = np.where(rng.uniform(size=(32, 256)) < 0.5, 1, -1).astype(np.int8)

    def draw(n):
        d = pool[rng.integers(32, size=n)].copy()
        flip = (rng.uniform(size=(n, 256)) < 0.02) & (rng.uniform(size=(n, 1)) < 0.5)
        return np.where(flip, -d, d).astype(np.int8)

    uv_b = np.round(rng.uniform(0, [1242, 375], (M, 2))).astype(np.float32)
    uv_a = (uv_b[rng.integers(M, size=(L, N))]
            + rng.normal(0, radius / 2, (L, N, 2))).astype(np.float32)
    uv_a[0, :4] = uv_b[:4] + np.array([radius, 0.0], np.float32)
    uv_a[-1, -1] = (1e4, 1e4)
    arrays = (draw(L * N).reshape(L, N, 256), uv_a, rng.uniform(size=(L, N)) < 0.9,
              draw(M), uv_b, rng.uniform(size=M) < 0.9)
    return tuple(torch.from_numpy(np.ascontiguousarray(a)) for a in arrays)


def k2_shapes():
    """K2's path shapes: (name, L, N, M, radius).  TrackLocalMap matches
    against 1, 2 or 3 keyframes of 1024 keypoints; the live run's keyframes
    [1, 6, 11] give it 1024 rows on frames 2-5 and 2048 on frames 7-10."""
    return (("local map 3x1024 vs 1024, r=12", 1, 3072, 1024, 12.0),
            ("fuse scan 4 x 1024 vs 1024, r=6", 4, 1024, 1024, 6.0),
            ("window tracks 3072 vs 3072, r=15", 1, 3072, 3072, 15.0),
            ("local map 1x1024 vs 1024, r=12", 1, 1024, 1024, 12.0),
            ("local map 2x1024 vs 1024, r=12", 1, 2048, 1024, 12.0))


def k2_empty_launch(dev, rows, M):
    """A callable launching the empty kernel on the grid K2's plan gives
    (rows, M): the floor one launch of that grid costs."""
    import torch

    from multimot_track_tpu_torch.ops import match_cuda

    C = match_cuda.match_plan(rows, M)
    lib = match_cuda._lib()

    def empty():
        rc = lib.match_projected_empty_launch(rows, C, torch.cuda.current_stream(dev).cuda_stream)
        if rc != 0:
            raise SystemExit(f"the empty launch failed with CUDA error {rc}")
    return empty


def phase_match_kernel(dev, strict=True):
    """K2 against its plain version at its path shapes.  ``strict``: the
    kernel must be one device kernel per call, and the empty launch on its
    grid is timed beside it (tools/k2_ab.py passes False to time earlier
    trees' kernels the same way)."""
    import torch

    from multimot_track_tpu_torch.ops import matching
    from multimot_track_tpu_torch.ops.match_cuda import match_projected_cuda

    if strict:
        from multimot_track_tpu_torch.ops import match_cuda

        held = {C: match_cuda._lib().match_projected_max_clusters(C) for C in match_cuda.RESIDENT}
        log(f"[K2] clusters the card holds at once, by cluster size: {held} "
            f"(the plan assumes {match_cuda.RESIDENT})")
        if held != match_cuda.RESIDENT:
            raise SystemExit("K2's cluster residency differs from what its plan assumes")
    rng = np.random.default_rng(1)
    figures = []
    for name, L, N, M, radius in k2_shapes():
        args = [a.to(dev) for a in make_match_problem(rng, L, N, M, radius)]
        run_k = lambda: match_projected_cuda(*args, radius=radius)
        run_p = lambda: matching.match_projected_plain(*args, radius=radius)
        bk, sk, ik = run_k()
        torch.cuda.synchronize()
        bp, sp, ip = run_p()
        torch.cuda.synchronize()
        n_diff = int((bk != bp).sum() + (sk != sp).sum() + (ik != ip).sum())
        err = float(torch.maximum((bk - bp).abs().max(), (sk - sp).abs().max()))
        ties = int(((bk == sk) & (bk < 1e9)).sum())
        ms_k = time_ms(run_k, rounds=5, reps=20)
        ms_p = time_ms(run_p, rounds=5, reps=5)
        before = match_projected_cuda.launches
        split, sessions = one_kernel_split(run_k) if strict else (kernel_split(run_k), 1)
        counted = match_projected_cuda.launches - before
        calls = sessions * (1 + PROFILE_WARMUP + 10)    # each session: kernel_split's calls
        n_kern = sum(n for n, _ in split.values())
        us_dev = per_call_us(split)
        bound_us, bound_by, n_pairs = k2_bound_us(args, (bk, sk, ik), radius)
        log(f"[K2] {name}: {n_diff} differing outputs of {3 * L * N} (must be 0), "
            f"max|d dist| {err:.1f}, {ties} rows with a tied best/second | kernel "
            f"{ms_k:.4f} ms/call (wrapper, CUDA events), {us_dev / 1e3:.4f} ms device "
            f"({n_kern:.1f} kernels per call, profiler), plain {ms_p:.4f} ms/call | bound "
            f"{bound_us:.3f} us by {bound_by} ({n_pairs} gated pairs), "
            f"{100 * bound_us / max(us_dev, 1e-9):.2f} % of bound")
        log(f"[K2] {name}: device kernels per call x mean us: "
            + "; ".join(f"{short_name(k)} x{n:.1f} {us:.2f}" for k, (n, us) in split.items()))
        fig = dict(stage=name, max_abs_err=err, ms=us_dev / 1e3, wrapper_ms=ms_k,
                   plain_ms=ms_p, bound_ms=bound_us / 1e3, bound_by=bound_by,
                   kernels_per_call=n_kern,
                   split={short_name(k): (n, us / 1e3) for k, (n, us) in split.items()})
        if n_diff:
            raise SystemExit(f"K2 disagrees with its plain version on {name}")
        if strict:
            # exactly one kernel for each call the wrapper counted
            if (n_kern != 1 or any("match_projected_kernel" not in k for k in split)
                    or counted != calls):
                raise SystemExit(f"K2 ran {n_kern} device kernels per call on {name}: {split}; "
                                 f"the wrapper counted {counted} launches for {calls} calls")
            empty, _ = one_kernel_split(k2_empty_launch(dev, L * N, M))
            n_empty = sum(n for n, _ in empty.values())
            fig["empty_ms"] = per_call_us(empty) / 1e3 if n_empty == 1 else None
            C = match_cuda.match_plan(L * N, M)
            q = match_cuda.THREADS // match_cuda.THREADS_PER_QUERY
            log(f"[K2] {name}: plan C = {C} CTAs per cluster, {-(-L * N // q) * C} CTAs; "
                f"the empty kernel on the same grid " + (
                    f"{fig['empty_ms']:.4f} ms device (profiler)" if n_empty == 1 else
                    f"not measured (the profiler returned {n_empty} records per call)"))
        figures.append(fig)
    return figures


H100_INT8_OPS = 1979e12        # published dense int8 tensor-core peak


def k2_bound_us(args, outs, radius):
    """K2's least time on these inputs: a 256-wide +-1 dot product (512
    int8 operations) for every valid query / valid reference pair inside
    the gate, over the int8 peak, against each input read once and each
    output written once.  Returns (us, 'bytes' or 'operations', pairs)."""
    import torch

    desc_a, uv_a, va, desc_b, uv_b, vb = args
    d2 = ((uv_a[..., None, :] - uv_b) ** 2).sum(-1)            # (L, N, M)
    n_pairs = int(((d2 <= radius * radius) & va[..., None] & vb).sum())
    byts = sum(t.numel() * t.element_size() for t in (*args, *outs))
    t_ops, t_bytes = 512 * n_pairs / H100_INT8_OPS, byts / H100_BYTES_PER_S
    return 1e6 * max(t_ops, t_bytes), ("operations" if t_ops >= t_bytes else "bytes"), n_pairs


def live_config(windows: bool = True):
    """The live system at DEFAULT_CONFIG (trailing-window BA over 5 frames,
    joint ego+object window BA at keyframe cadence); ``windows=False`` turns
    both off, the configuration of the earlier live figures."""
    import dataclasses

    from multimot_track_tpu_torch.config import DEFAULT_CONFIG as D

    if windows:
        return D
    return dataclasses.replace(D, backend=dataclasses.replace(
        D.backend, window_refine=False, joint_window_refine=False))


def run_live(dev, frames, cfg, prepare=None, **kw):
    """One live run; returns (system, delivered results, host s, event ms).
    ``prepare(system)`` runs after construction, before the first frame."""
    import torch

    from multimot_track_tpu_torch.pipeline.system import MultiMotSystem

    s = MultiMotSystem(cfg, seed=0, device=dev, **kw)
    if prepare is not None:
        prepare(s)
    ups = [s.upload(fd) for fd in frames]          # uploads are set-up, not the loop
    torch.cuda.synchronize(dev)
    a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    t0 = time.perf_counter()
    a.record()
    out = [s.track_rgbd(fd, uploaded=u) for fd, u in zip(frames, ups)]
    out.append(s.flush())
    b.record()
    b.synchronize()
    return s, [r for r in out if r is not None], time.perf_counter() - t0, a.elapsed_time(b)


def phase_live(dev, frames):
    import torch

    from multimot_track_tpu_torch.ops.match_cuda import match_projected_cuda
    from multimot_track_tpu_torch.solvers.flow_ba_cuda import solve_flow_ba_cuda

    n = len(frames)
    cfg = live_config()
    n_win = n - cfg.backend.window_size + 1     # every frame from the first full window
    t0 = time.perf_counter()
    run_live(dev, frames, cfg)       # warm-up: library handles, allocator, first calls
    log(f"[live] warm-up run (synchronous, windows on, not counted) in "
        f"{time.perf_counter() - t0:.1f} s")
    runs = {}
    for mode, kw in (("sync", {}), ("pipelined", dict(pipelined=True))):
        solve_flow_ba_cuda.launches = 0
        match_projected_cuda.launches = 0
        torch.cuda.reset_peak_memory_stats(dev)
        s, res, host_s, ev_ms = run_live(dev, frames, cfg, **kw)
        k1, k2 = solve_flow_ba_cuda.launches, match_projected_cuda.launches
        peak = torch.cuda.max_memory_allocated(dev)
        kf = s.keyframes
        summ = s.summary()
        stages = s.stage_report()
        log(f"[live {mode}] {n} frames: {1e3 * host_s / n:.2f} ms/frame (host clock), "
            f"{ev_ms / n:.2f} ms/frame (CUDA events), peak {peak / 2**30:.3f} GiB")
        log(f"[live {mode}] mean cam t-RPE {summ['cam_t_rpe_rel_mean']:.5f} (refined "
            f"{summ['cam_t_rpe_refined_mean']:.5f}), ATE {summ['ego_ate_rmse_m']:.5f} m (raw "
            f"{summ['ego_ate_rmse_raw_m']:.5f} m), refined obj t-RPE "
            f"{summ['obj_t_rpe_refined_mean']}, {summ['n_obj_estimates']} object records, "
            f"state {s.state}")
        log(f"[live {mode}] keyframes {[k.index for k in kf.frames]}, fuse scans "
            f"{kf.n_fuse_scans}, fused {kf.n_fused}, culled {kf.n_culled}, live points "
            f"{kf.n_live_points()}; local-map refinements {s.n_lm_dispatched} dispatched, "
            f"{len(s.lm_accepted_frames)} accepted (frames {s.lm_accepted_frames}); "
            f"relocalized {s.n_relocalized}")
        log(f"[live {mode}] window refinements {s.n_win_dispatched} dispatched (expect "
            f"{n_win}), {len(s.win_accepted_frames)} accepted (frames "
            f"{s.win_accepted_frames}); joint window refines {s.n_joint_refines}")
        log(f"[live {mode}] launches: K1 {k1}, K2 {k2} "
            f"(expect {s.n_lm_dispatched} + {kf.n_fuse_scans})")
        log(f"[live {mode}] loop events {s.map.loop_events}; loop_ladder stage mean "
            f"{stages.get('loop_ladder', {}).get('mean_ms')} ms "
            f"({stages.get('loop_ladder', {}).get('n', 0)} calls)")
        log(f"[live {mode}] stages: {json.dumps(stages)}")
        if s.map.loop_events:
            raise SystemExit(f"live {mode}: loop events {s.map.loop_events} on a scene that "
                             "never revisits")
        if len(res) != n - 1 or len(s.map.camera_poses) != n:
            raise SystemExit(f"live {mode}: {len(res)} results for {n - 1} pairs")
        if not np.all(np.isfinite(np.stack(s.map.camera_poses))) or not finite_tree(res[-1]):
            raise SystemExit(f"live {mode}: non-finite output")
        if mode == "sync" and k1 != 5 * (n - 1):          # five flow-BA stages per pair
            raise SystemExit(f"live sync: K1 launched {k1} times for {n - 1} pairs")
        if not (k2 == s.n_lm_dispatched + kf.n_fuse_scans and k2 > 0 and k1 > 0):
            raise SystemExit(f"live {mode}: K2 launched {k2} times for "
                             f"{s.n_lm_dispatched} refinements + {kf.n_fuse_scans} fuse scans")
        if not (summ["cam_t_rpe_rel_mean"] < 0.05 and summ["ego_ate_rmse_m"] < 0.5):
            raise SystemExit(f"live {mode}: tracking accuracy out of bounds")
        # an accepted window had at least min_window_tracks live tracks
        if s.n_win_dispatched != n_win or not s.win_accepted_frames \
                or "window_refine" not in stages:
            raise SystemExit(f"live {mode}: window refinements {s.n_win_dispatched} "
                             f"dispatched (expect {n_win}), {s.win_accepted_frames} accepted")
        if mode == "sync" and not (s.lm_accepted_frames and s.n_joint_refines >= 1
                                   and "joint_ba" in stages):
            raise SystemExit(f"live sync: local-map accepts {s.lm_accepted_frames}, "
                             f"joint window refines {s.n_joint_refines}")
        runs[mode] = dict(system=s, k1=k1, k2=k2, ms_per_frame=1e3 * host_s / n)

    s_p, _, host_p, _ = run_live(dev, frames, cfg, match_backend="torch")
    s_k = runs["sync"]["system"]
    dT = float(np.abs(np.stack(s_k.map.camera_poses) - np.stack(s_p.map.camera_poses)).max())
    log(f"[live sync, plain matcher] {1e3 * host_p / n:.2f} ms/frame (host clock); "
        f"max|dT| against the K2 run {dT:.3e} (tol {LIVE_T_ATOL}); accepted "
        f"{s_p.lm_accepted_frames}, windows {s_p.win_accepted_frames}")
    if dT > LIVE_T_ATOL:
        raise SystemExit("live: the K2 run and the plain-matcher run disagree")

    torch.cuda.reset_peak_memory_stats(dev)
    s_o, _, host_o, ev_o = run_live(dev, frames, live_config(windows=False))
    summ = s_o.summary()
    log(f"[live sync, windows off] {1e3 * host_o / n:.2f} ms/frame (host clock), "
        f"{ev_o / n:.2f} ms/frame (CUDA events), peak "
        f"{torch.cuda.max_memory_allocated(dev) / 2**30:.3f} GiB; mean cam t-RPE "
        f"{summ['cam_t_rpe_rel_mean']:.5f}, ATE {summ['ego_ate_rmse_m']:.5f} m, refined obj "
        f"t-RPE {summ['obj_t_rpe_refined_mean']}; stages {json.dumps(s_o.stage_report())}")
    if not (summ["cam_t_rpe_rel_mean"] < 0.05 and summ["ego_ate_rmse_m"] < 0.5):
        raise SystemExit("live, windows off: tracking accuracy out of bounds")
    return dict(k1_launches=runs["sync"]["k1"], k2_launches=runs["sync"]["k2"], system=s_k,
                ms_per_frame=runs["sync"]["ms_per_frame"])


def host_ms(fn, reps):
    """Mean wall ms per call of ``fn`` over ``reps`` calls, after one
    warm-up call (the card synchronised around the loop)."""
    import torch

    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(reps):
        fn()
    torch.cuda.synchronize()
    return 1e3 * (time.perf_counter() - t0) / reps


def phase_window(dev, frames, s):
    """The window solvers on the card against the same calls on the CPU, on
    the first window of the junction scene with the synchronous run's poses
    and object measurements; then the window tracks through K2 and through
    the plain matcher."""
    import torch

    from multimot_track_tpu_torch.frontend import tracks
    from multimot_track_tpu_torch.geometry import camera
    from multimot_track_tpu_torch.ops.match_cuda import match_projected_cuda
    from multimot_track_tpu_torch.pipeline import window_refine
    from multimot_track_tpu_torch.pipeline.system import joint_motion_init

    cfg = s.cfg
    Wn = cfg.backend.window_size
    win = frames[:Wn]
    rows = list(range(Wn))
    Twc0 = s.map.camera_poses[0]
    poses_rel = np.stack([np.linalg.inv(s.map.camera_poses[r]) @ Twc0
                          for r in rows]).astype(np.float32)
    H_init, H_valid, used = joint_motion_init(s.map.obj_records, rows, poses_rel,
                                              cfg.padding.k_obj_max)
    wire_h = [s._compact_images(fd) for fd in win]
    out = {}
    for where in ("cuda", "cpu"):
        d = dev if where == "cuda" else torch.device("cpu")
        up = lambda a: torch.from_numpy(np.ascontiguousarray(a)).to(d)
        g, dp, fl, sm = (up(np.stack([w[i] for w in (wire_h[:-1] if i == 2 else wire_h)]))
                         for i in range(4))
        P, H, V = up(poses_rel), up(H_init), up(H_valid)
        trail = lambda: window_refine.refine_trailing_window(P, g, dp[0], fl, sm, cfg)
        joint = lambda: window_refine.refine_joint_window(P, H, V, g, dp, fl, sm, cfg)
        P_t, n_live = trail()
        P_j, M_j, _ = joint()
        reps = 5 if where == "cuda" else 1
        out[where] = dict(P_t=P_t.cpu().numpy(), n_live=int(n_live), P_j=P_j.cpu().numpy(),
                          M_j=M_j.cpu().numpy(), ms_t=host_ms(trail, reps),
                          ms_j=host_ms(joint, reps))
    c, h = out["cuda"], out["cpu"]
    dP_t = float(np.abs(c["P_t"] - h["P_t"]).max())
    dP_j = float(np.abs(c["P_j"] - h["P_j"]).max())
    dM_j = float(np.abs(c["M_j"] - h["M_j"]).max())
    moved = float(np.abs(c["P_t"] - poses_rel).max())
    log(f"[window] trailing window BA, frames 0-{Wn - 1}: n_live cuda {c['n_live']} cpu "
        f"{h['n_live']} (tol 2), max|dPose| {dP_t:.3e} (tol 1e-3), moved the poses by "
        f"{moved:.3e} | cuda {c['ms_t']:.2f} ms/call, cpu {h['ms_t']:.2f} ms/call")
    log(f"[window] joint window BA ({len(used)} object slots on {Wn - 1} pairs): "
        f"max|dPose| {dP_j:.3e}, max|dMotion| {dM_j:.3e} (tol 1e-3) | cuda "
        f"{c['ms_j']:.2f} ms/call, cpu {h['ms_j']:.2f} ms/call")
    if not (np.isfinite(c["P_t"]).all() and np.isfinite(c["P_j"]).all()
            and np.isfinite(c["M_j"]).all() and used):
        raise SystemExit("window solvers: non-finite output or no object in the window")
    if abs(c["n_live"] - h["n_live"]) > 2 or c["n_live"] < cfg.backend.min_window_tracks:
        raise SystemExit(f"window BA: n_live {c['n_live']} on the card, {h['n_live']} on the CPU")
    if max(dP_t, dP_j, dM_j) > 1e-3:
        raise SystemExit("window solvers: the card and the CPU disagree")

    fl = lambda a: torch.from_numpy(np.stack(a).astype(np.float32)).to(dev)
    grays, flows = fl([fd.gray for fd in win]), fl([fd.flow for fd in win[:-1]])
    sems = torch.from_numpy(np.stack([fd.sem_mask for fd in win]).astype(np.int32)).to(dev)
    depth0 = camera.disparity_png_to_depth(fl([win[0].depth_raw])[0], cfg.camera.bf)
    build = lambda b: tracks.build_window_tracks(grays, flows, depth0, sems, backend=b)
    match_projected_cuda.launches = 0
    tr_k, z_k = build("cuda")
    launches = match_projected_cuda.launches
    tr_p, z_p = build("torch")
    same = bool(torch.equal(tr_k.uv, tr_p.uv) and torch.equal(tr_k.alive, tr_p.alive)
                and torch.equal(z_k, z_p))
    ms_k, ms_p = host_ms(lambda: build("cuda"), 3), host_ms(lambda: build("torch"), 3)
    log(f"[window] build_window_tracks frames 0-{Wn - 1} (3072 keypoints, r = 15): K2 "
        f"launches {launches} (expect {Wn - 1}), identical to the plain matcher: {same}, "
        f"{int(tr_k.alive[-1].sum())} of {int(tr_k.alive[0].sum())} tracks alive at the end "
        f"| K2 {ms_k:.2f} ms/call, plain {ms_p:.2f} ms/call")
    if not same or launches != Wn - 1:
        raise SystemExit("window tracks: K2 and the plain matcher disagree")


SHUTTLE_N = 8               # forward positions of the loop scene: 2 * 8 - 1 = 15 frames
LOOP_KW = dict(keyframe_gap=2, loop_consistency=1)   # the scene's cuts from the defaults


def shuttle_frames(n: int = SHUTTLE_N, step: float = 0.3):
    """The loop scene: the camera drives forward ``step`` m per frame over
    ``n`` positions and back over the same path (order [0..n-1] +
    [n-2..0], the order ``io/synth.build`` plays a sequence in), at the
    KITTI camera (1242x375) with ``default_movers()``; 2n - 1 frames."""
    from multimot_track_tpu_torch.io.synth import KITTI_SYNTH_CAM, _build_frames, default_movers

    order = list(range(n)) + list(range(n - 2, -1, -1))

    def Twc_at(t):
        T = np.eye(4)
        T[2, 3] = step * order[t]
        return T

    return _build_frames(dict(KITTI_SYNTH_CAM), Twc_at, default_movers(), len(order), box=False)


def phase_loop(dev, frames):
    """The live loop ladder on the shuttle: sync, pipelined, then sync with
    loop closing off, on the same uploaded frames."""
    import torch

    from multimot_track_tpu_torch.ops.match_cuda import match_projected_cuda
    from multimot_track_tpu_torch.solvers.flow_ba_cuda import solve_flow_ba_cuda

    n = len(frames)
    cfg = live_config()
    figures = {}
    for mode, kw in (("sync", {}), ("pipelined", dict(pipelined=True)),
                     ("sync, loop closing off", dict(enable_loop_closing=False))):
        solve_flow_ba_cuda.launches = 0
        match_projected_cuda.launches = 0
        torch.cuda.reset_peak_memory_stats(dev)
        s, res, host_s, ev_ms = run_live(dev, frames, cfg, **LOOP_KW, **kw)
        k1, k2 = solve_flow_ba_cuda.launches, match_projected_cuda.launches
        peak = torch.cuda.max_memory_allocated(dev)
        kf = s.keyframes
        summ = s.summary()
        stages = s.stage_report()
        ladder = stages.get("loop_ladder", {})
        events = [tuple(int(v) for v in e) for e in s.map.loop_events]
        log(f"[loop {mode}] {n} frames: {1e3 * host_s / n:.2f} ms/frame (host clock), "
            f"{ev_ms / n:.2f} ms/frame (CUDA events), peak {peak / 2**30:.3f} GiB; "
            f"loop_ladder stage mean {ladder.get('mean_ms')} ms ({ladder.get('n', 0)} calls), "
            f"kf_consume mean {stages.get('kf_consume', {}).get('mean_ms')} ms")
        log(f"[loop {mode}] loop events (frame, keyframe frame, Sim3 inliers) {events}; "
            f"global BA per closure (None = rejected): {s.gba_stats}")
        log(f"[loop {mode}] ATE {summ['ego_ate_rmse_m']:.5f} m (raw "
            f"{summ['ego_ate_rmse_raw_m']:.5f} m), refined cam t-RPE "
            f"{summ['cam_t_rpe_refined_mean']:.5f}, mean cam t-RPE "
            f"{summ['cam_t_rpe_rel_mean']:.5f}; keyframes {[k.index for k in kf.frames]}; "
            f"K1 {k1}, K2 {k2} (expect {s.n_lm_dispatched} + {kf.n_fuse_scans}); state {s.state}")
        log(f"[loop {mode}] within the ladder: Sim3 and pose graph "
            f"{stages.get('loop_sim3_pose_graph')}, global BA {stages.get('loop_global_ba')}")
        log(f"[loop {mode}] stages: {json.dumps(stages)}")
        if len(res) != n - 1 or len(s.map.camera_poses) != n:
            raise SystemExit(f"loop {mode}: {len(res)} results for {n - 1} pairs")
        if not np.all(np.isfinite(np.stack(s.map.camera_poses))) or not finite_tree(res[-1]):
            raise SystemExit(f"loop {mode}: non-finite output")
        if not (k2 == s.n_lm_dispatched + kf.n_fuse_scans and k2 > 0 and k1 > 0):
            raise SystemExit(f"loop {mode}: K2 launched {k2} times for {s.n_lm_dispatched} "
                             f"refinements + {kf.n_fuse_scans} fuse scans")
        if not (summ["cam_t_rpe_rel_mean"] < 0.05 and summ["ego_ate_rmse_m"] < 0.5):
            raise SystemExit(f"loop {mode}: tracking accuracy out of bounds")
        if mode == "sync" and not any(f - k >= 4 and m >= 20 for f, k, m in events):
            raise SystemExit(f"loop sync: no loop closed on the revisit ({events})")
        if "off" in mode and events:
            raise SystemExit(f"loop closing off, yet loop events {events}")
        figures[mode] = dict(ms_per_frame=1e3 * host_s / n, events_ms_per_frame=ev_ms / n,
                             loop_ladder_ms=ladder.get("mean_ms"), loop_events=events,
                             keyframes=[k.index for k in kf.frames],
                             global_ba=s.gba_stats, ate_m=summ["ego_ate_rmse_m"],
                             t_rpe_refined=summ["cam_t_rpe_refined_mean"], k1_launches=k1,
                             k2_launches=k2, peak_gib=peak / 2**30)
    return figures


class FixedSampler:
    """A hypothesis sampler returning one fixed (iters, k) index array, so
    that the card and the CPU score the same hypotheses."""

    def __init__(self, idx: np.ndarray):
        self.idx = idx

    def __call__(self, p, iters, sites, k=3):
        import torch

        idx = torch.from_numpy(self.idx).to(p.device)
        return idx[None].expand(p.shape[0], -1, -1)


class HostSampler:
    """Multinomial draws from a host ``torch.Generator``: on the card, the
    draws the port makes on the CPU at the same seed."""

    def __init__(self, seed: int):
        import torch

        from multimot_track_tpu_torch.solvers.ransac import MultinomialSampler

        self.inner = MultinomialSampler(torch.Generator().manual_seed(seed))

    def __call__(self, p, iters, sites, k=3):
        return self.inner(p.cpu(), iters, sites, k).to(p.device)


class ReplaySampler:
    """Replays recorded hypotheses (``tools/torch_quad_trace.py record``:
    the JAX package's draws, keyed ``repr(site)#occurrence``).  A site the
    recording lacks draws from a host generator and counts as missed."""

    def __init__(self, path, seed: int = 0):
        d = np.load(path)
        self.table = {str(k): d[f"s{n}"] for n, k in enumerate(d["keys"])}
        self.seen, self.hits, self.misses = {}, 0, 0
        self.fallback = HostSampler(seed)

    def __call__(self, p, iters, sites, k=3):
        import torch

        rows = []
        for m, site in enumerate(sites):
            key = repr(tuple(site))
            self.seen[key] = self.seen.get(key, -1) + 1
            a = self.table.get(f"{key}#{self.seen[key]}")
            if a is not None and a.shape == (iters, k):
                self.hits += 1
                rows.append(torch.from_numpy(a.astype(np.int64)).to(p.device))
            else:
                self.misses += 1
                rows.append(self.fallback(p[m:m + 1], iters, [site], k)[0])
        return torch.stack(rows)


def se3_exp(xi) -> np.ndarray:
    """(4, 4) float64 exp of a 6-vector (omega, upsilon)."""
    import torch

    from multimot_track_tpu_torch.geometry import se3

    return se3.exp_se3(torch.tensor(xi, dtype=torch.float64)).numpy()


def drift_chain(M, rel_xi, drift_xi, w_loop):
    """A drifted odometry chain of M poses with the true loop edge from the
    last pose to the first (the fixture of tests/test_loop_closing.py).
    Returns numpy (poses, edges, Z, weights)."""
    true_rel, drift = se3_exp(rel_xi), se3_exp(drift_xi)
    poses, true_poses = [np.eye(4)], [np.eye(4)]
    for _ in range(1, M):
        poses.append(drift @ true_rel @ poses[-1])
        true_poses.append(true_rel @ true_poses[-1])
    poses = np.stack(poses).astype(np.float32)
    ij = np.stack([np.arange(1, M), np.arange(M - 1)], -1)
    Z = np.einsum("eij,ejk->eik", poses[1:], np.linalg.inv(poses[:-1]))
    ij = np.concatenate([ij, [[M - 1, 0]]]).astype(np.int32)
    Z = np.concatenate([Z, (true_poses[-1] @ np.linalg.inv(true_poses[0]))[None]])
    w = np.concatenate([np.ones(M - 1), [w_loop]])
    return poses, ij, Z.astype(np.float32), w.astype(np.float32)


def gba_problem(rng, K=24, L_rows=2048, O=6):
    """A seeded global BA at the KITTI camera: K keyframes 0.6 m apart with
    drift growing to ~2 cm, each landmark seen by a run of up to O
    consecutive keyframes among those that see it (a chain of consecutive
    matches, as the store builds them; 0.5 px and 2 % disparity noise),
    inits 0.1 m off, padded to ``L_rows`` rows.  Returns
    (args for solve_global_ba without the intrinsics, intrinsics)."""
    from multimot_track_tpu_torch.config import CameraConfig

    c = CameraConfig()
    step = se3_exp([0.0, 0.01, 0.0, 0.05, 0.0, 0.6])
    T_true = [np.eye(4)]
    for _ in range(K - 1):
        T_true.append(step @ T_true[-1])
    T_stored = np.stack([se3_exp(0.02 * k / K * rng.normal(size=6)) @ T
                         for k, T in enumerate(T_true)])
    n_cand = 4 * L_rows
    X = np.stack([rng.uniform(-12, 12, n_cand), rng.uniform(-3, 1.5, n_cand),
                  rng.uniform(8, 40, n_cand)], -1)
    obs_kf = np.zeros((L_rows, O), np.int32)
    obs_uv = np.zeros((L_rows, O, 2), np.float32)
    obs_disp = np.full((L_rows, O), c.bf / 20.0, np.float32)
    obs_w = np.zeros((L_rows, O), np.float32)
    X0 = np.zeros((L_rows, 3), np.float32)
    X0[:, 2] = 20.0
    l = 0
    for x in X:
        Xc = np.einsum("kij,j->ki", np.stack(T_true)[:, :3, :3], x) + np.stack(T_true)[:, :3, 3]
        u = c.fx * Xc[:, 0] / Xc[:, 2] + c.cx
        v = c.fy * Xc[:, 1] / Xc[:, 2] + c.cy
        seen = np.nonzero((Xc[:, 2] > 1.0) & (u > 0) & (u < c.width) & (v > 0)
                          & (v < c.height))[0]
        if len(seen) < 2:
            continue
        start = rng.integers(0, max(len(seen) - O, 0) + 1)
        seen = seen[start:start + O]
        for o, k in enumerate(seen):
            obs_kf[l, o] = k
            obs_uv[l, o] = (u[k], v[k]) + rng.normal(0, 0.5, 2)
            obs_disp[l, o] = c.bf / Xc[k, 2] * (1.0 + rng.normal(0, 0.02))
            obs_w[l, o] = 1.0
        X0[l] = x + rng.normal(0, 0.1, 3)
        l += 1
        if l == L_rows - 48:        # the rest stays padding, as the store pads
            break
    arrays = (T_stored.astype(np.float32), X0, obs_kf, obs_uv, obs_disp, obs_w)
    return arrays, (c.fx, c.fy, c.cx, c.cy, c.bf), l


def agreement(a, b, extent):
    """(rotation / scale max |d|, translation max |d| over ``extent``) of two
    pose stacks (..., 4, 4)."""
    return (float(np.abs(a[..., :3, :3] - b[..., :3, :3]).max()),
            float(np.abs(a[..., :3, 3] - b[..., :3, 3]).max()) / max(1.0, extent))


def phase_loop_solvers(dev):
    """The loop ladder's solvers at full size, card against CPU."""
    import torch

    from multimot_track_tpu_torch.config import CameraConfig
    from multimot_track_tpu_torch.solvers import global_ba, pose_graph, sim3

    cpu = torch.device("cpu")
    c = CameraConfig()
    rng = np.random.default_rng(8)
    figures = {}

    def both(fn, reps_cuda, warm=True):
        """{"cuda" | "cpu": (fn's result, wall ms per call)}: on the card the
        mean of ``reps_cuda`` calls, after an untimed one when ``warm``, on
        the CPU one call."""
        if warm:
            fn(dev)
        out = {}
        for where, d, reps in (("cuda", dev, reps_cuda), ("cpu", cpu, 1)):
            torch.cuda.synchronize(dev)
            t0 = time.perf_counter()
            for _ in range(reps):
                res = fn(d)
            torch.cuda.synchronize(dev)
            out[where] = (res, 1e3 * (time.perf_counter() - t0) / reps)
        return out

    # --- Sim3 RANSAC: a keyframe's 1024 points, 300 hypotheses ---
    N = 1024
    uv = np.stack([rng.uniform(50, 1190, N), rng.uniform(30, 345, N)], -1)
    z = rng.uniform(4.0, 35.0, N)
    X1 = np.stack([(uv[:, 0] - c.cx) * z / c.fx, (uv[:, 1] - c.cy) * z / c.fy, z], -1)
    T12 = se3_exp([0.01, -0.03, 0.005, 0.3, -0.05, 0.4])
    X2 = X1 @ T12[:3, :3].T + T12[:3, 3] + rng.normal(0, 0.01, X1.shape)
    X2[: N // 4] += rng.normal(0, 1.0, (N // 4, 3))
    valid = rng.uniform(size=N) < 0.9
    sampler = FixedSampler(rng.choice(np.nonzero(valid)[0], (300, 3)).astype(np.int64))
    t = lambda a, d: torch.from_numpy(np.ascontiguousarray(a)).to(d)
    r = both(lambda d: sim3.ransac_sim3(
        t(X1.astype(np.float32), d), t(X2.astype(np.float32), d), t(valid, d),
        c.fx, c.fy, c.cx, c.cy, sampler=sampler, site=(0, "sim3")), reps_cuda=10)
    (rk, ms_k), (rc, ms_c) = r["cuda"], r["cpu"]
    d_rot = float((rk.R.cpu() - rc.R).abs().max())
    d_tr = float((rk.t.cpu() - rc.t).abs().max()) / float(np.abs(X2).max())
    d_inl = abs(int(rk.n_inliers) - int(rc.n_inliers))
    d_s = abs(float(rk.scale) - float(rc.scale))
    log(f"[loop solvers] ransac_sim3 N = {N}, 300 hypotheses: inliers cuda "
        f"{int(rk.n_inliers)} cpu {int(rc.n_inliers)} (tol 2), max|dR| {d_rot:.3e}, "
        f"max|dt| / extent {d_tr:.3e}, |ds| {d_s:.3e} (tol 1e-3) | cuda {ms_k:.3f} ms/call, "
        f"cpu {ms_c:.3f} ms/call")
    ok = d_inl <= 2 and max(d_rot, d_tr, d_s) <= 1e-3
    figures["ransac_sim3"] = dict(cuda_ms=ms_k, cpu_ms=ms_c, max_err=max(d_rot, d_tr, d_s))

    # --- pose graphs: dense at the switch, CG at the JAX test's size.  The
    # float32 CG at M = 1000 sits at its own rounding floor (card and CPU
    # land ~1e-3 of the chain's extent apart, each ~4e-4 from float64), so
    # its card / CPU agreement is checked in float64 and its float32
    # figures are printed beside ---
    for name, solve, M, rel, check in (
            ("optimize_pose_graph", pose_graph.optimize_pose_graph, 256,
             [0, 0.01, 0, 0, 0, 0.5], np.float32),
            ("optimize_pose_graph_cg", pose_graph.optimize_pose_graph_cg, 1000,
             [0, 0.003, 0, 0, 0, 1.0], np.float64)):
        g = drift_chain(M, rel, [0, 0.0005, 0, 0.002, 0, 0.004], 100.0)
        # the CG (tens of seconds a call, its ops warmed by the dense solve)
        # runs without the untimed call
        run = lambda dtype: both(lambda d: solve(*(t(a.astype(dtype) if a.dtype.kind == "f"
                                                      else a, d) for a in g)
                                                ).poses.cpu().numpy(), reps_cuda=1,
                                 warm=check is np.float32)
        r = run(np.float32)
        (Pk, ms_k), (Pc, ms_c) = r["cuda"], r["cpu"]
        extent = float(np.abs(Pc[:, :3, 3]).max())
        d32 = agreement(Pk, Pc, extent)
        if check is np.float64:
            r64 = run(np.float64)
            d_rot, d_tr = agreement(r64["cuda"][0], r64["cpu"][0], extent)
            f32_off = agreement(Pk, r64["cpu"][0], extent)
            detail = (f"float64 card / CPU max|dR| {d_rot:.3e}, max|dt| / extent {d_tr:.3e} "
                      f"(tol 1e-3); float32 card / CPU {d32[0]:.3e}, {d32[1]:.3e}, float32 "
                      f"card / float64 {f32_off[0]:.3e}, {f32_off[1]:.3e}")
        else:
            d_rot, d_tr = d32
            detail = f"max|dR| {d_rot:.3e}, max|dt| / extent {d_tr:.3e} (tol 1e-3)"
        log(f"[loop solvers] {name} M = {M} (extent {extent:.1f} m): {detail}, finite "
            f"{bool(np.isfinite(Pk).all())} | float32 cuda {ms_k:.2f} ms/call, cpu "
            f"{ms_c:.2f} ms/call")
        ok = ok and np.isfinite(Pk).all() and max(d_rot, d_tr) <= 1e-3
        figures[name] = dict(cuda_ms=ms_k, cpu_ms=ms_c, max_err=max(d_rot, d_tr),
                             float32_err=max(d32))

    # --- global BA: 24 keyframes, 2048 landmark rows, O = 6 ---
    arrays, intr, L = gba_problem(rng)
    r = both(lambda d: global_ba.solve_global_ba(
        *(t(a, d) for a in arrays), *intr), reps_cuda=2)
    (gk, ms_k), (gc, ms_c) = r["cuda"], r["cpu"]
    Pk, Pc = gk.poses.cpu().numpy(), gc.poses.cpu().numpy()
    Xk, Xc = gk.X.cpu().numpy(), gc.X.cpu().numpy()
    extent = float(np.abs(Xc[:L]).max())
    d_rot, d_tr = agreement(Pk, Pc, extent)
    d_X = float(np.abs(Xk - Xc).max()) / extent
    log(f"[loop solvers] solve_global_ba K = 24, L = {L} landmarks in {len(Xc)} rows, O = 6: "
        f"chi2 {float(gc.chi2_init):.1f} -> cuda {float(gk.chi2):.3f} cpu {float(gc.chi2):.3f}; "
        f"max|dR| {d_rot:.3e}, max|dt| / extent ({extent:.1f} m) {d_tr:.3e}, max|dX| / extent "
        f"{d_X:.3e} (tol 1e-3) | cuda {ms_k:.2f} ms/call, cpu {ms_c:.2f} ms/call")
    ok = ok and np.isfinite(Pk).all() and np.isfinite(Xk).all() and max(d_rot, d_tr, d_X) <= 1e-3
    figures["solve_global_ba"] = dict(cuda_ms=ms_k, cpu_ms=ms_c, max_err=max(d_rot, d_tr, d_X))
    if not ok:
        raise SystemExit("loop solvers: the card and the CPU disagree")
    return figures

BOW_KF, BOW_KP, BOW_TARGET = 520, 1024, 137   # the store of tests/test_bow_scale.py, live width


def bow_store(dev, descs, seed_idx, n_kf):
    """A store of ``n_kf`` keyframes of the given descriptors whose
    vocabulary seeds are ``seed_idx``."""
    import torch

    from multimot_track_tpu_torch.pipeline.keyframes import Keyframe, KeyframeStore

    st = KeyframeStore(capacity=1024, min_gap=1, device=dev,
                       vocab_seed=lambda p, n: torch.from_numpy(seed_idx[:n]))
    zeros_uv, zeros_X = np.zeros((BOW_KP, 2), np.float32), np.zeros((BOW_KP, 3), np.float32)
    for i in range(n_kf):
        st.maybe_add(Keyframe(index=i, Tcw=np.eye(4, dtype=np.float32), uv=zeros_uv,
                              desc=descs[i], valid=np.ones(BOW_KP, bool), Xw=zeros_X))
    return st


def phase_bow(dev):
    """Phase 9: BoW place recognition at scale, the card against the CPU."""
    import torch

    rng = np.random.default_rng(11)
    descs = (rng.integers(0, 2, (BOW_KF, BOW_KP, 256), dtype=np.int8) * 2 - 1).astype(np.int8)
    seed_idx = rng.choice(8 * BOW_KP, 256, replace=False).astype(np.int64)
    q = descs[BOW_TARGET].copy()
    q[rng.random(q.shape) < 0.05] *= -1
    runs = {}
    for name, d in (("cuda", dev), ("cpu", torch.device("cpu"))):
        st = bow_store(d, descs, seed_idx, BOW_KF)
        qd, vd = torch.from_numpy(q).to(d), torch.ones(BOW_KP, dtype=torch.bool, device=d)
        t0 = time.perf_counter()
        scores = st.similarity_scores(qd, vd)
        first_ms = 1e3 * (time.perf_counter() - t0)
        cand = st.detect_loop(qd, vd)
        sigs = torch.stack([st._sigs[id(kf)][1] for kf in st.frames[:BOW_KF - 2]]).cpu()
        runs[name] = dict(store=st, scores=scores, cand=cand, first_ms=first_ms, sigs=sigs,
                          words=st._voc.words.cpu(), q=(qd, vd))
    k, c = runs["cuda"], runs["cpu"]
    warm_ms = host_ms(lambda: k["store"].similarity_scores(*k["q"]), reps=5)
    cpu_warm_ms = host_ms(lambda: c["store"].similarity_scores(*c["q"]), reps=2)
    st48 = bow_store(dev, descs, seed_idx, 48)
    exact48_ms = host_ms(lambda: st48.similarity_scores(*k["q"]), reps=5)
    d_words = float((k["words"] - c["words"]).abs().max())
    d_sigs = float((k["sigs"] - c["sigs"]).abs().max())
    short_k, short_c = np.flatnonzero(k["scores"]), np.flatnonzero(c["scores"])
    same = bool(np.array_equal(k["scores"], c["scores"]))
    log(f"[bow] {BOW_KF} keyframes x {BOW_KP} keypoints x 256 bits "
        f"({descs.nbytes / 1e6:.0f} MB of descriptors), capacity 1024: max|dWords| "
        f"{d_words:.2e}, max|dSig| {d_sigs:.2e} (tol 1e-5); shortlist cuda {short_k.tolist()} "
        f"cpu {short_c.tolist()}; exact scores equal {same}; detect_loop cuda {k['cand']} "
        f"cpu {c['cand']} (expect {BOW_TARGET}); score of {BOW_TARGET}: "
        f"{int(k['scores'][BOW_TARGET])}")
    log(f"[bow] similarity_scores on the card: first call (trains the vocabulary, "
        f"{BOW_KF - 2} signatures) {k['first_ms']:.1f} ms, warm {warm_ms:.2f} ms at "
        f"{BOW_KF} keyframes, exact batched path at 48 keyframes {exact48_ms:.2f} ms | CPU: "
        f"first {c['first_ms']:.1f} ms, warm {cpu_warm_ms:.2f} ms")
    if not (d_words <= 1e-5 and d_sigs <= 1e-5 and same and k["cand"] == c["cand"] == BOW_TARGET
            and len(short_k) <= k["store"].bow_shortlist):
        raise SystemExit("bow: the card and the CPU disagree, or the revisit was not found")
    return dict(first_ms=k["first_ms"], warm_ms=warm_ms, exact48_ms=exact48_ms,
                cpu_first_ms=c["first_ms"], cpu_warm_ms=cpu_warm_ms, max_err_words=d_words,
                max_err_sigs=d_sigs, candidate=k["cand"])


def phase_bow_live(dev, frames, loop):
    """Phase 9b: phase 8's synchronous shuttle with ``bow_threshold = 3``."""
    import torch

    from multimot_track_tpu_torch.ops.match_cuda import match_projected_cuda
    from multimot_track_tpu_torch.solvers.flow_ba_cuda import solve_flow_ba_cuda

    def low_threshold(s):
        s.keyframes.bow_threshold = 3

    n = len(frames)
    solve_flow_ba_cuda.launches = 0
    match_projected_cuda.launches = 0
    torch.cuda.reset_peak_memory_stats(dev)
    s, res, host_s, ev_ms = run_live(dev, frames, live_config(), prepare=low_threshold,
                                     **LOOP_KW)
    k1, k2 = solve_flow_ba_cuda.launches, match_projected_cuda.launches
    events = [tuple(int(v) for v in e) for e in s.map.loop_events]
    kfs = [k.index for k in s.keyframes.frames]
    ref = loop["sync"]
    log(f"[bow live] shuttle, bow_threshold 3: {1e3 * host_s / n:.2f} ms/frame (host clock), "
        f"{ev_ms / n:.2f} ms/frame (CUDA events), peak "
        f"{torch.cuda.max_memory_allocated(dev) / 2**30:.3f} GiB; loop events {events} "
        f"(phase 8: {ref['loop_events']}); keyframes {kfs} (phase 8: {ref['keyframes']}); "
        f"vocabulary trained {s.keyframes._voc is not None}; K1 {k1}, K2 {k2}")
    if s.keyframes._voc is None or events != ref["loop_events"] or kfs != ref["keyframes"]:
        raise SystemExit("bow live: the BoW path did not reproduce phase 8's loop events")
    if not np.all(np.isfinite(np.stack(s.map.camera_poses))) or not finite_tree(res[-1]):
        raise SystemExit("bow live: non-finite output")
    return dict(ms_per_frame=1e3 * host_s / n, events_ms_per_frame=ev_ms / n,
                loop_events=events, k1_launches=k1, k2_launches=k2)


def discovery_inputs(frames, dev):
    """Junction frames 1 -> 2 as the live system decodes them: metric depth
    of both, the flow 1 -> 2, and the constant-velocity ego motion of the
    ground-truth pair 0 -> 1."""
    import torch

    from multimot_track_tpu_torch.config import DEFAULT_CONFIG
    from multimot_track_tpu_torch.geometry import camera as cam_g
    from multimot_track_tpu_torch.ops import wire
    from multimot_track_tpu_torch.pipeline.system import MultiMotSystem

    cam = DEFAULT_CONFIG.camera
    packed = [MultiMotSystem._compact_images(fd) for fd in frames[:3]]
    up = lambda a: torch.from_numpy(np.ascontiguousarray(a)).to(dev)
    depth = [cam_g.disparity_png_to_depth(wire._decode_depth(up(p[1]), cam.width), cam.bf)
             for p in packed[1:3]]
    flow = wire._decode_flow(up(packed[1][2]), cam.height, cam.width)
    Twc0, Twc1 = (np.asarray(fd.pose_gt, np.float64) for fd in frames[:2])
    vel = torch.from_numpy((np.linalg.inv(Twc1) @ Twc0).astype(np.float32)).to(dev)
    return (depth[0], depth[1], flow, vel, cam.fx, cam.fy, cam.cx, cam.cy)


def phase_discovery(dev, frames):
    """Phase 10(a): ``discover_objects`` at the KITTI camera, the card
    against the CPU, on one fixed hypothesis-seed array."""
    import torch
    from scipy import ndimage

    from multimot_track_tpu_torch.ops import graphcut
    from multimot_track_tpu_torch.pipeline import motion_seg

    cpu = torch.device("cpu")
    args = {"cuda": discovery_inputs(frames, dev), "cpu": discovery_inputs(frames, cpu)}
    site = (2, "discover")
    # the seeds: 24 fixed indices into the candidates the CPU finds
    n_cand = int(motion_seg._discovery_problem(FixedSampler(np.zeros((24, 1), np.int64)), site,
                                               *args["cpu"])[4].sum())
    sampler = FixedSampler(np.random.default_rng(3).integers(0, max(n_cand, 1), (24, 1)))
    disc = {d: motion_seg.discover_objects(sampler, site, *args[d]) for d in args}
    k, c = disc["cuda"], disc["cpu"]
    same_mask = bool(torch.equal(k.valid.cpu(), c.valid))
    v = c.valid.numpy()
    agree = float((k.labels.cpu().numpy()[v] == c.labels.numpy()[v]).mean()) if v.any() else 1.0
    e_k, e_c = float(k.energy), float(c.energy)
    ms_k = host_ms(lambda: motion_seg.discover_objects(sampler, site, *args["cuda"]), reps=10)
    ms_c = host_ms(lambda: motion_seg.discover_objects(sampler, site, *args["cpu"]), reps=3)
    prob = lambda: motion_seg._discovery_problem(sampler, site, *args["cuda"])
    ms_prob = host_ms(prob, reps=10)
    _, uv1, D, graph, _ = prob()
    ms_seg = host_ms(lambda: graphcut.segment(D, graph), reps=10)
    split = kernel_split(lambda: motion_seg.discover_objects(sampler, site, *args["cuda"]),
                         reps=5)
    dev_ms = per_call_us(split) / 1e3
    top = sorted(split.items(), key=lambda kv: -kv[1][0] * kv[1][1])[:4]
    ms_raster = host_ms(lambda: motion_seg.rasterize_labels_at(
        k.uv_cur, k.labels, k.valid, 375, 1242).cpu(), reps=10)
    raster = motion_seg.rasterize_labels_at(k.uv_cur, k.labels, k.valid, 375, 1242).cpu().numpy()
    t0 = time.perf_counter()
    for _ in range(3):
        comp, n_comp = ndimage.label(ndimage.binary_dilation(raster > 0, np.ones((17, 17), bool)))
        ndimage.sum_labels(raster > 0, np.where(raster > 0, comp, 0), range(1, n_comp + 1))
    ms_host = 1e3 * (time.perf_counter() - t0) / 3
    t0 = time.perf_counter()
    ex = motion_seg.discover_objects_exact(sampler, site, *args["cuda"])
    ms_exact = 1e3 * (time.perf_counter() - t0)
    n_lab = len(np.unique(c.labels.numpy()[v]))
    log(f"[discovery] junction 1 -> 2 at 1242x375, step 8, n_max 1024, 24 hypotheses: "
        f"{int(v.sum())} candidates, masks identical {same_mask}, labels agree on "
        f"{100 * agree:.2f} % (gate 99.5 %), {n_lab} labels used; energy cuda {e_k:.3f} cpu "
        f"{e_c:.3f} (rtol 1e-4); exact alpha-expansion energy {float(ex.energy):.3f} "
        f"({ms_exact:.1f} ms on the host)")
    log(f"[discovery] ms per call: cuda {ms_k:.2f} (problem {ms_prob:.2f}, mean-field + ICM "
        f"{ms_seg:.2f}), cpu {ms_c:.2f}; rasterise + copy {ms_raster:.2f} ms, host "
        f"components {ms_host:.2f} ms")
    log(f"[discovery] profiler: device busy {dev_ms:.3f} ms of the card's call, "
        f"{sum(n for n, _ in split.values()):.0f} kernels a call, idle share "
        f"{1 - dev_ms / ms_k:.3f}; top {[(short_name(k), n, round(us, 2)) for k, (n, us) in top]} "
        f"(kernel, launches a call, us each)")
    if not (same_mask and agree >= 0.995 and abs(e_k - e_c) <= 1e-4 * max(abs(e_c), 1e-6)
            and v.any() and np.isfinite(e_k)):
        raise SystemExit("discovery: the card and the CPU disagree")
    return dict(cuda_ms=ms_k, cpu_ms=ms_c, device_busy_ms=dev_ms, problem_ms=ms_prob,
                segment_ms=ms_seg,
                raster_ms=ms_raster, host_components_ms=ms_host, exact_ms=ms_exact,
                n_candidates=int(v.sum()), label_agreement=agree, energy_cuda=e_k,
                energy_cpu=e_c, energy_exact=float(ex.energy))


def phase_discovery_live(dev, frames):
    """Phase 10(b): the live system in mask-free mode at DEFAULT_CONFIG."""
    import torch

    from multimot_track_tpu_torch.config import DEFAULT_CONFIG
    from multimot_track_tpu_torch.ops import wire
    from multimot_track_tpu_torch.ops.match_cuda import match_projected_cuda
    from multimot_track_tpu_torch.solvers.flow_ba_cuda import solve_flow_ba_cuda

    n, W = len(frames), DEFAULT_CONFIG.camera.width
    figures = {}
    for mode, kw in (("sync", {}), ("pipelined", dict(pipelined=True))):
        instances = {}

        def record(s):
            inner = s._discover_mask

            def recording(depth):
                out = inner(depth)
                lab = wire.unpack_sem4(out, W).cpu().numpy()
                instances[s._frame_idx] = len(np.unique(lab[lab > 0]))
                return out

            s._discover_mask = recording

        solve_flow_ba_cuda.launches = 0
        match_projected_cuda.launches = 0
        torch.cuda.reset_peak_memory_stats(dev)
        s, res, host_s, ev_ms = run_live(dev, frames, live_config(), prepare=record,
                                         discover_objects=True, **kw)
        k1, k2 = solve_flow_ba_cuda.launches, match_projected_cuda.launches
        peak = torch.cuda.max_memory_allocated(dev)
        kf = s.keyframes
        summ = s.summary()
        recs = [r for r in s.map.obj_records if r.has_gt]
        tids = sorted({r.track_id for r in s.map.obj_records})
        stages = s.stage_report()
        log(f"[discovery live {mode}] {n} frames: {1e3 * host_s / n:.2f} ms/frame (host "
            f"clock), {ev_ms / n:.2f} ms/frame (CUDA events), peak {peak / 2**30:.3f} GiB; "
            f"discover stage mean {stages.get('discover', {}).get('mean_ms')} ms")
        log(f"[discovery live {mode}] instances per frame {instances}; object records "
            f"{len(s.map.obj_records)} ({len(recs)} with ground truth), track IDs {tids}; "
            f"mean cam t-RPE {summ['cam_t_rpe_rel_mean']:.5f}, ATE {summ['ego_ate_rmse_m']:.5f} "
            f"m; K1 {k1}, K2 {k2} (expect {s.n_lm_dispatched} + {kf.n_fuse_scans}); "
            f"sf_cam_gate {s.cfg.solver.sf_cam_gate}")
        log(f"[discovery live {mode}] stages: {json.dumps(stages)}")
        if not (any(instances.values()) and recs and summ["cam_t_rpe_rel_mean"] < 0.10):
            raise SystemExit(f"discovery live {mode}: no instance discovered, no record with "
                             "ground truth, or camera t-RPE >= 0.10")
        if len(res) != n - 1 or not np.all(np.isfinite(np.stack(s.map.camera_poses))) \
                or not finite_tree(res[-1]):
            raise SystemExit(f"discovery live {mode}: missing or non-finite output")
        if not (k2 == s.n_lm_dispatched + kf.n_fuse_scans and k2 > 0 and k1 > 0):
            raise SystemExit(f"discovery live {mode}: K2 launched {k2} times for "
                             f"{s.n_lm_dispatched} refinements + {kf.n_fuse_scans} fuse scans")
        figures[mode] = dict(ms_per_frame=1e3 * host_s / n, events_ms_per_frame=ev_ms / n,
                             discover_ms=stages.get("discover", {}).get("mean_ms"),
                             instances=instances, n_records=len(s.map.obj_records),
                             n_records_gt=len(recs), track_ids=tids,
                             cam_t_rpe=summ["cam_t_rpe_rel_mean"], ate_m=summ["ego_ate_rmse_m"],
                             k1_launches=k1, k2_launches=k2, peak_gib=peak / 2**30)
    return figures


# ---------------------------------------------------------------------------
# Phase 11: the entry points on the card


def _counters():
    from multimot_track_tpu_torch.ops.match_cuda import match_projected_cuda
    from multimot_track_tpu_torch.solvers.flow_ba_cuda import solve_flow_ba_cuda

    return solve_flow_ba_cuda, match_projected_cuda


def reset_launches():
    for fn in _counters():
        fn.launches = 0


def read_launches():
    return tuple(fn.launches for fn in _counters())


def run_cli_logged(argv, log_path):
    """``cli.run(argv)`` with its per-frame lines into ``log_path``; returns
    (system, sequence, summary, wall s, K1 launches, K2 launches)."""
    import contextlib

    import torch

    from multimot_track_tpu_torch import cli

    os.makedirs(os.path.dirname(log_path), exist_ok=True)
    reset_launches()
    t0 = time.perf_counter()
    with open(log_path, "w") as f, contextlib.redirect_stdout(f):
        s, seq, summ = cli.run(argv)
    torch.cuda.synchronize()
    return (s, seq, summ, time.perf_counter() - t0) + read_launches()


def check_cli_run(tag, s, summ, k1, k2, n, ate_max=None, rpe_max=None):
    """The checks every CLI run of phase 11 shares."""
    kf = s.keyframes
    poses = np.stack(s.map.camera_poses)
    log(f"[entry {tag}] K1 {k1}, K2 {k2} (expect {s.n_lm_dispatched} local-map refinements "
        f"+ {kf.n_fuse_scans} fuse scans); keyframes {[k.index for k in kf.frames]}; "
        f"cam t-RPE {summ['cam_t_rpe_rel_mean']}, ATE {summ['ego_ate_rmse_m']} m, "
        f"{summ['n_obj_estimates']} object records, state {s.state}")
    if summ["n_frames"] != n or len(poses) != n or not np.all(np.isfinite(poses)):
        raise SystemExit(f"entry {tag}: {summ['n_frames']} frames of {n}, or non-finite poses")
    if not (k1 > 0 and k2 == s.n_lm_dispatched + kf.n_fuse_scans and k2 > 0):
        raise SystemExit(f"entry {tag}: K1 {k1}, K2 {k2} launches for {s.n_lm_dispatched} "
                         f"refinements + {kf.n_fuse_scans} fuse scans")
    if ate_max is not None and not (summ["ego_ate_rmse_m"] < ate_max):
        raise SystemExit(f"entry {tag}: ATE {summ['ego_ate_rmse_m']} m, bound {ate_max}")
    if rpe_max is not None and not (summ["cam_t_rpe_rel_mean"] < rpe_max):
        raise SystemExit(f"entry {tag}: cam t-RPE {summ['cam_t_rpe_rel_mean']}, bound {rpe_max}")


def host_ms_each(fn, items):
    """Wall ms per item of ``fn(item)`` over ``items`` (one pass), and the
    results."""
    t0 = time.perf_counter()
    out = [fn(x) for x in items]
    return 1e3 * (time.perf_counter() - t0) / len(items), out


def phase_entry_readers(dev, frames):
    """Phase 11(a): a KITTI tree of the frames read back by ``KittiSequence``."""
    import shutil
    import zlib

    from multimot_track_tpu_torch.io import kitti, png
    from multimot_track_tpu_torch.io.flowio import read_flo
    from multimot_track_tpu_torch.io.synth import write_kitti_tree

    root = os.path.join(ENTRY_DIR, "kitti")
    shutil.rmtree(root, ignore_errors=True)
    t0 = time.perf_counter()
    write_kitti_tree(root, frames)
    log(f"[entry readers] wrote the {len(frames)}-frame KITTI tree (8-bit RGB image/, 16-bit "
        f"depth/, flow/*.flo, semantic/*.txt) in {time.perf_counter() - t0:.1f} s")
    py = kitti.KittiSequence(root, device=dev)
    n = len(py)
    paths = [py.frame_paths(i) for i in range(n)]
    ms_png, _ = host_ms_each(lambda p: (png.read_png(p["image"]), png.read_png(p["depth"])),
                             paths)
    ms_flo, _ = host_ms_each(lambda p: read_flo(p["flow"]), paths)
    H, W = frames[0].gray.shape
    ms_mask, _ = host_ms_each(lambda p: kitti.load_mask_txt(p["semantic"], H, W), paths)
    ms_py, fd_py = host_ms_each(py.load_frame, range(n))
    log(f"[entry readers] ms per frame: PNG decode (RGB image + 16-bit depth) {ms_png:.2f}, "
        f".flo {ms_flo:.2f}, mask text {ms_mask:.2f}; load_frame {ms_py:.2f}")
    for i, (fd, src) in enumerate(zip(fd_py, frames)):
        sem = np.where(src.sem_mask < 4, src.sem_mask, 0)
        depth = np.clip(np.round(src.depth_raw), 0, 65535).astype(np.float32)
        if not (np.array_equal(fd.flow, src.flow) and np.array_equal(fd.sem_mask, sem)
                and np.array_equal(fd.depth_raw, depth)
                and np.abs(fd.gray - src.gray).max() <= 0.5 + 1e-3):
            raise SystemExit(f"entry readers: frame {i} does not round-trip the tree")
    rng = np.random.default_rng(11)
    rows = rng.integers(0, 256, (375, 1 + 1242 * 3), dtype=np.uint8)
    rows[:, 0] = rng.integers(0, 5, 375)
    if not np.array_equal(png.unfilter_native(rows, 3), png.unfilter_plain(rows, 3)):
        raise SystemExit("entry readers: the native PNG unfilter disagrees with its plain version")
    # the decode's parts on one image of the tree: inflate, then unfilter
    with open(paths[0]["image"], "rb") as f:
        data = f.read()
    raw = b"".join(body for kind, body in png._chunks(data, f.name) if kind == b"IDAT")
    ms_inflate, _ = host_ms_each(zlib.decompress, [raw] * 10)
    img_rows = np.frombuffer(zlib.decompress(raw), np.uint8).reshape(H, -1)
    ms_unfilter, _ = host_ms_each(lambda r: png.unfilter_native(r, 3), [img_rows] * 10)
    log(f"[entry readers] the {n}-frame tree round-trips; native PNG unfilter == plain on "
        f"375 rows of 1242 RGB pixels; one RGB image: inflate {ms_inflate:.2f} ms, native "
        f"unfilter {ms_unfilter:.2f} ms")
    return root, dict(png_ms=ms_png, flo_ms=ms_flo, mask_ms=ms_mask, load_frame_ms=ms_py,
                      inflate_ms=ms_inflate, unfilter_ms=ms_unfilter)


def flow_agreement(a, b):
    """(median, 99.9th percentile, share beyond 0.05 px) of |a - b| per pixel."""
    e = np.abs(a - b).max(-1)
    return float(np.median(e)), float(np.percentile(e, 99.9)), float((e > 0.05).mean())


def phase_entry_stereo(dev, log_dir):
    """Phase 11(c): the stereo CLI, disparity and flow card against CPU, and
    the quad A/B configuration."""
    import dataclasses

    import torch

    from multimot_track_tpu_torch.config import DEFAULT_CONFIG
    from multimot_track_tpu_torch.frontend import optical_flow, stereo
    from multimot_track_tpu_torch.io import kitti
    from multimot_track_tpu_torch.io.png import read_png
    from multimot_track_tpu_torch.io.stereo_seq import StereoKittiSequence
    from multimot_track_tpu_torch.io.synth import (KITTI_SYNTH_CAM, synth_camera_config,
                                                   write_stereo_tree)
    from multimot_track_tpu_torch.pipeline.system import MultiMotSystem

    n = STEREO_N
    root = os.path.join(ENTRY_DIR, "stereo")
    t0 = time.perf_counter()
    write_stereo_tree(root, n_frames=n, cam=dict(KITTI_SYNTH_CAM), texture="distinct")
    log(f"[entry stereo] rendered the {n}-frame stereo tree at the KITTI camera in "
        f"{time.perf_counter() - t0:.1f} s")
    out = {}
    for mode, extra in (("discover", ["--discover-objects"]), ("quad", ["--quad-stereo"])):
        s, seq, summ, wall, k1, k2 = run_cli_logged(
            [root, "--stereo", *extra], os.path.join(log_dir, f"entry_cli_stereo_{mode}.log"))
        log(f"[entry stereo {mode}] {n} frames: {1e3 * wall / n:.2f} ms/frame end to end "
            f"(disparity, flow and the gate in the reader), track_rgbd "
            f"{1e3 * summ['mean_frame_time_s']:.2f} ms/frame; n_quad_matched "
            f"{summ.get('n_quad_matched')}; flows estimated {seq.n_flow_estimated}")
        # accuracy is reported, not gated: on this tree the LK flow loses
        # frames 8-12 (rotational flow beyond its capture range) in the JAX
        # package as well, and what is left is the RANSAC draw's (the JAX
        # package's CLI on the CPU: ATE 1.73 m with discovery, 1.38 m with
        # the quad gate; with the quad gate 0.94-2.60 m over seeds 0-2, and
        # the card 1.38 m on the JAX package's seed-0 draws:
        # tools/torch_stereo_reference.py, tools/torch_quad_trace.py)
        check_cli_run(f"stereo {mode}", s, summ, k1, k2, n)
        if mode == "quad" and not summ["n_quad_matched"] > 0:
            raise SystemExit("entry stereo: the quad gate matched nothing")
        out[mode] = dict(ms_per_frame=1e3 * wall / n, track_ms=1e3 * summ["mean_frame_time_s"],
                         cam_t_rpe=summ["cam_t_rpe_rel_mean"], ate_m=summ["ego_ate_rmse_m"],
                         n_quad_matched=summ.get("n_quad_matched"), k1=k1, k2=k2)

    # disparity and flow on the card against the CPU, one frame pair
    p = StereoKittiSequence(root, device="cpu")
    g = [kitti._rgb_to_gray(read_png(p.frame_paths(i)[k])) for i, k in
         ((0, "image"), (0, "right"), (1, "image"), (1, "right"))]
    gc = [torch.from_numpy(x) for x in g]
    gd = [x.to(dev) for x in gc]
    t0 = time.perf_counter()
    disp_c = stereo.dense_disparity(gc[0], gc[1]).numpy()
    flow_c = optical_flow.dense_flow(gc[0], gc[2]).numpy()
    cpu_s = time.perf_counter() - t0
    disp_d = stereo.dense_disparity(gd[0], gd[1])
    flow_d = optical_flow.dense_flow(gd[0], gd[2])
    dd, fd = disp_d.cpu().numpy(), flow_d.cpu().numpy()
    same_int = bool(np.array_equal(np.floor(dd), np.floor(disp_c))
                    and np.array_equal(dd > 0, disp_c > 0))
    d_sub = float(np.abs(dd - disp_c).max())
    f_med, f_999, f_far = flow_agreement(fd, flow_c)
    log(f"[entry stereo] card vs CPU (CPU {cpu_s:.1f} s): integer disparities equal {same_int}, "
        f"valid {float((dd > 0).mean()):.4f}, max |d disparity| {d_sub:.3e} (tol 1e-4); flow "
        f"|d| median {f_med:.3e} (tol 5e-4), 99.9 % {f_999:.3e} (tol 2e-2), beyond 0.05 px "
        f"{f_far:.2e} (tol 1e-3)")
    if not (same_int and d_sub <= 1e-4 and f_med <= 5e-4 and f_999 <= 2e-2 and f_far <= 1e-3):
        raise SystemExit("entry stereo: disparity or flow disagree between the card and the CPU")
    disp1 = stereo.dense_disparity(gd[2], gd[3])
    ms_disp = host_ms(lambda: stereo.dense_disparity(gd[0], gd[1]), 5)
    ms_flow = host_ms(lambda: optical_flow.dense_flow(gd[0], gd[2]), 5)
    ms_quad = host_ms(lambda: stereo.quad_temporal_matches(gd[0], gd[1], gd[2], gd[3], disp_d,
                                                           disp1, flow_d), 5)
    log(f"[entry stereo] ms a call on the card (1242x375, synchronised): dense_disparity "
        f"(128 disparities) {ms_disp:.2f}, dense_flow (5 levels x 8 iterations) {ms_flow:.2f}, "
        f"quad_temporal_matches (512 keypoints) {ms_quad:.2f}")
    out.update(disparity_ms=ms_disp, flow_ms=ms_flow, quad_ms=ms_quad, flow_median=f_med,
               flow_p999=f_999, disparity_max_abs=d_sub)

    # tools/measure_quad_ab.py's configuration beside its QUAD_AB.json rows.
    # Each row replays the JAX package's RANSAC / PnP hypotheses (seed 0,
    # tools/quad_ab_draws/, recorded by tools/torch_quad_trace.py), so that it
    # scores what QUAD_AB.json's row scored: with other draws a row's ATE is
    # the draw's (the JAX package's default quad-on row: 0.21 to 2.29 m over
    # seeds 0-4).  ATE < 0.5 m is gated where QUAD_AB.json meets it; the
    # default quad-on row on the port's own draws is reported beside them.
    D = DEFAULT_CONFIG
    ab_cfg = dataclasses.replace(
        D, camera=synth_camera_config(),
        padding=dataclasses.replace(D.padding, n_static_max=1024, n_obj_pts_max=4096),
        solver=dataclasses.replace(D.solver, ransac_iters=200, cam_lm_iters=60,
                                   obj_lm_iters=100))
    with open(os.path.join(REPO, "QUAD_AB.json")) as f:
        ref = {(r["texture"], r["quad_gate"]): r for r in json.load(f) if "texture" in r}
    ab = []
    for tex in ("default", "distinct"):
        troot = write_stereo_tree(os.path.join(ENTRY_DIR, f"ab_{tex}"), n_frames=n, texture=tex)
        for quad, draws in ((False, "jax"), (True, "jax")) + (((True, "own"),)
                                                             if tex == "default" else ()):
            row = f"ab-{tex}-{'on' if quad else 'off'}"
            sampler = (ReplaySampler(os.path.join(REPO, "tools", "quad_ab_draws", f"{row}.npz"))
                       if draws == "jax" else None)
            seq = StereoKittiSequence(troot, max_disp=64, quad_gate=quad, device=dev)
            s = MultiMotSystem(ab_cfg, device=dev, sampler=sampler)
            for i in range(len(seq)):
                s.track_rgbd(seq.load_frame(i))
            summ = s.summary()
            r = ref[(tex, quad)]
            log(f"[entry quad A/B] texture {tex}, quad {quad}, "
                + (f"the JAX package's draws ({sampler.hits} replayed, {sampler.misses} "
                   f"drawn afresh)" if sampler else "the port's own draws") + ": cam t-RPE "
                f"{summ['cam_t_rpe_rel_mean']:.4f} (QUAD_AB.json {r['cam_t_rpe_rel_mean']:.4f}), "
                f"ATE {summ['ego_ate_rmse_m']:.4f} m ({r['ego_ate_rmse_m']:.4f}), quad matches "
                f"{seq.n_quad_matched} ({r['n_quad_matched']})")
            poses = np.stack(s.map.camera_poses)
            if not (np.all(np.isfinite(poses)) and np.isfinite(summ["ego_ate_rmse_m"])):
                raise SystemExit(f"entry quad A/B {row}: non-finite trajectory")
            if sampler and r["ego_ate_rmse_m"] < 0.5 and not summ["ego_ate_rmse_m"] < 0.5:
                raise SystemExit(f"entry quad A/B {row} on the JAX package's draws: ATE "
                                 f"{summ['ego_ate_rmse_m']} m, QUAD_AB.json "
                                 f"{r['ego_ate_rmse_m']} m, bound 0.5 m")
            ab.append(dict(row=row, draws=draws, cam_t_rpe=summ["cam_t_rpe_rel_mean"],
                           ate_m=summ["ego_ate_rmse_m"], n_quad_matched=seq.n_quad_matched,
                           replayed=sampler and sampler.hits, missed=sampler and sampler.misses))
    out["quad_ab"] = ab
    return out


def serve_frames(fds, with_flow, dev):
    """Phase 11(d): ``serve_connection`` in a thread over a socketpair at
    DEFAULT_CONFIG on the card; returns its replies."""
    import socket
    import threading

    from multimot_track_tpu_torch.io import stream

    a, b = socket.socketpair()
    box = {}

    def server():
        try:
            box["sys"] = stream.serve_connection(b, device=dev)
        except Exception as e:              # reported by the caller
            box["error"] = e
        finally:
            b.close()

    th = threading.Thread(target=server)
    th.start()
    replies = []
    try:
        for fd in fds:
            stream.send_frame(a, np.clip(fd.gray, 0, 255).astype(np.uint8),
                              np.clip(fd.depth_raw, 0, 65535).astype(np.uint16),
                              flow=fd.flow.astype(np.float16) if with_flow else None,
                              sem=fd.sem_mask.astype(np.uint8), frame=fd.index,
                              timestamp=fd.timestamp)
            if with_flow:
                replies.append(stream.recv_result(a))
        a.shutdown(socket.SHUT_WR)
        if not with_flow:
            replies = [stream.recv_result(a) for _ in fds]
    finally:
        a.close()
        th.join(timeout=600)
    if th.is_alive() or "error" in box:
        raise SystemExit(f"entry server: the server thread failed: {box.get('error')!r}")
    return replies


def in_process_replies(fds, with_flow, dev):
    """What the server should answer: the same frames, rebuilt as the
    server rebuilds them, through ``track_rgbd``."""
    from multimot_track_tpu_torch.config import DEFAULT_CONFIG
    from multimot_track_tpu_torch.io.frame import FrameData
    from multimot_track_tpu_torch.io.kitti import lk_flow
    from multimot_track_tpu_torch.pipeline.system import MultiMotSystem

    s = MultiMotSystem(DEFAULT_CONFIG, device=dev)
    grays = [np.clip(fd.gray, 0, 255).astype(np.uint8).astype(np.float32) for fd in fds]
    out = []
    for i, fd in enumerate(fds):
        if with_flow:
            flow = fd.flow.astype(np.float16).astype(np.float32)
        elif i + 1 < len(fds):
            flow = lk_flow(grays[i], grays[i + 1], dev)
        else:
            flow = np.zeros(fd.gray.shape + (2,), np.float32)
        r = s.track_rgbd(FrameData(
            index=fd.index, timestamp=fd.timestamp, gray=grays[i],
            depth_raw=np.clip(fd.depth_raw, 0, 65535).astype(np.uint16).astype(np.float32),
            flow=flow, sem_mask=fd.sem_mask.astype(np.uint8).astype(np.int32),
            pose_gt=np.eye(4, dtype=np.float32), obj_ids_gt=np.zeros(0, np.int32),
            obj_poses_gt=np.zeros((0, 4, 4), np.float32),
            obj_bboxes_gt=np.zeros((0, 4), np.float32)))
        out.append(r)
    return out


def phase_entry_tum_server(dev, frames, kitti_root, log_dir):
    """Phase 11(d): the TUM CLI and the socket server."""
    from multimot_track_tpu_torch.io import kitti
    from multimot_track_tpu_torch.io.synth import KITTI_SYNTH_CAM, write_tum_tree

    n = TUM_N
    root = write_tum_tree(os.path.join(ENTRY_DIR, "rgbd_dataset_freiburg1_junction"),
                          frames[:n], bf=KITTI_SYNTH_CAM["bf"])
    s, seq, summ, wall, k1, k2 = run_cli_logged([str(root), "--tum", "--discover-objects"],
                                                os.path.join(log_dir, "entry_cli_tum.log"))
    log(f"[entry tum] {n} frames: {1e3 * wall / n:.2f} ms/frame end to end, flows estimated "
        f"{seq.n_flow_estimated}, camera {seq.camera_config()} (the TUM reader's own "
        f"intrinsics, not the frames': accuracy is reported, not gated)")
    check_cli_run("tum", s, summ, k1, k2, n)
    if seq.n_flow_estimated != n - 1:
        raise SystemExit(f"entry tum: {seq.n_flow_estimated} flows estimated for {n} frames")
    out = dict(tum_ms_per_frame=1e3 * wall / n, tum_cam_t_rpe=summ["cam_t_rpe_rel_mean"])

    fds = [kitti.KittiSequence(kitti_root, device=dev).load_frame(i) for i in range(SERVE_N)]
    for with_flow in (True, False):
        t0 = time.perf_counter()
        replies = serve_frames(fds, with_flow, dev)
        serve_s = time.perf_counter() - t0
        ref = in_process_replies(fds, with_flow, dev)
        worst = 0.0
        for i, (rep, r) in enumerate(zip(replies, ref)):
            if rep["frame"] != fds[i].index:
                raise SystemExit(f"entry server: reply {i} is for frame {rep['frame']}")
            if r is None:
                continue
            worst = max(worst, float(np.abs(np.reshape(rep["Tcw"], (4, 4)) - r.Tcw_cur).max()))
            active = np.flatnonzero(np.asarray(r.objects.active)).tolist()
            if [o["slot"] for o in rep["objects"]] != active:
                raise SystemExit(f"entry server: frame {i} active slots differ")
            for o in rep["objects"]:
                worst = max(worst, float(np.abs(np.reshape(o["H"], (4, 4))
                                                - r.objects.H[o["slot"]]).max()))
        log(f"[entry server] {'with' if with_flow else 'without'} flow arrays: {len(replies)} "
            f"replies in {serve_s:.1f} s; max |d| of Tcw and object motions against "
            f"in-process track_rgbd {worst:.3e} (tol 1e-6); objects per reply "
            f"{[len(rep['objects']) for rep in replies]}")
        if worst > 1e-6:
            raise SystemExit("entry server: replies differ from in-process tracking")
        out[f"server_{'flow' if with_flow else 'noflow'}_max_abs"] = worst
    return out


def phase_entry(dev, frames, live_ms, log_dir):
    """Phase 11: the sequence entry points on the card.  The trees and the
    RGB-D run's results are written under build/scratch/entry/ and removed
    afterwards; the CLI's own per-frame output goes to ``log_dir``."""
    import shutil

    try:
        root, readers = phase_entry_readers(dev, frames)
        n = len(frames)
        s, seq, summ, wall, k1, k2 = run_cli_logged(
            [root, "--frames", str(n), "--out", os.path.join(ENTRY_DIR, "rgbd_results")],
            os.path.join(log_dir, "entry_cli_rgbd.log"))
        log(f"[entry rgbd] cli.main on the {n}-frame tree, DEFAULT_CONFIG "
            f"on the card: {1e3 * wall / n:.2f} ms/frame end to end (reading and prefetch "
            f"included), track_rgbd {1e3 * summ['mean_frame_time_s']:.2f} ms/frame; phase 6 "
            f"synchronous in-memory run of the same frames: "
            f"{'not run' if live_ms is None else f'{live_ms:.2f} ms/frame'}")
        check_cli_run("rgbd", s, summ, k1, k2, n, ate_max=0.5, rpe_max=0.05)
        rgbd = dict(ms_per_frame=1e3 * wall / n, track_ms=1e3 * summ["mean_frame_time_s"],
                    cam_t_rpe=summ["cam_t_rpe_rel_mean"], ate_m=summ["ego_ate_rmse_m"],
                    k1=k1, k2=k2)
        stereo_out = phase_entry_stereo(dev, log_dir)
        rest = phase_entry_tum_server(dev, frames, root, log_dir)
    finally:
        shutil.rmtree(ENTRY_DIR, ignore_errors=True)
    return dict(readers=readers, rgbd=rgbd, stereo=stereo_out, **rest)


# ---------------------------------------------------------------------------
# Phase 12: monocular tracking on the card

MONO_TIMES = range(0, 43, 6)        # the monocular fixture: every 6th junction frame
MONO_DRAWS = os.path.join(REPO, "tools", "mono_draws")     # tools/mono_draws.py record
MONO_DIR = os.path.join(REPO, "build", "scratch", "mono")
MONO_CPU_TOL = 1e-3                 # the card against the CPU on the same draws


def mono_config():
    import dataclasses

    from multimot_track_tpu_torch.config import DEFAULT_CONFIG, CameraConfig
    from multimot_track_tpu_torch.io.synth import KITTI_SYNTH_CAM

    return dataclasses.replace(DEFAULT_CONFIG, camera=CameraConfig(**KITTI_SYNTH_CAM))


def sync(dev):
    import torch

    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def mono_draws(name: str):
    return ReplaySampler(os.path.join(MONO_DRAWS, f"{name}.npz"))


def run_mono_tracker(dev, grays, sampler, match_backend="auto", record=None, **kw):
    """``MonoTracker`` over ``grays`` on ``dev``: its events, the pose each
    frame returned and the final (loop-corrected) trajectory, ms per frame
    (host clock, synchronised), ms per ``close_loop``, and the K1 / K2
    launches of this run alone.  ``record`` receives the last projected
    match of each radius (18: the tracked-mode match, 12: TrackLocalMap's,
    against three keyframes by then) as its input tensors."""
    import torch

    from multimot_track_tpu_torch.ops import matching
    from multimot_track_tpu_torch.pipeline.mono import MonoTracker

    tr = MonoTracker(mono_config(), device=dev, sampler=sampler, match_backend=match_backend,
                     **kw)
    close_ms = []
    if tr.keyframes is not None:
        close = tr.keyframes.close_loop

        def timed_close(*a, **k):
            sync(dev)
            t0 = time.perf_counter()
            out = close(*a, **k)
            sync(dev)
            close_ms.append(1e3 * (time.perf_counter() - t0))
            return out

        tr.keyframes.close_loop = timed_close
    auto = matching.match_projected_auto

    def recording(*a, radius=15.0, **k):
        if record is not None:
            record[radius] = [x.clone() for x in a]
        return auto(*a, radius=radius, **k)

    matching.match_projected_auto = recording
    threads = torch.get_num_threads()
    if dev.type == "cpu":
        # one thread, as the CPU tests and tools/mono_draws.py run: the CPU
        # reductions split by threads round otherwise, and the tracker's
        # RANSAC masks follow every rounding
        torch.set_num_threads(1)
    try:
        reset_launches()
        online, ms = [], []
        for g in grays:
            sync(dev)
            t0 = time.perf_counter()
            online.append(np.array(tr.track(g)))
            sync(dev)
            ms.append(1e3 * (time.perf_counter() - t0))
        k1, k2 = read_launches()
    finally:
        matching.match_projected_auto = auto
        torch.set_num_threads(threads)
    return dict(init=tr.init_frame, lost=tr.lost_frames, reloc=tr.relocalized_frames,
                lm=tr.lm_accepted_frames, kfs=[k.index for k in tr.keyframes.frames]
                if tr.keyframes is not None else None,
                loops=[(int(f), int(k), int(n), float(sc)) for f, k, n, sc in tr.loop_events],
                online=np.stack(online), poses=np.stack(tr.poses), ms=ms, close_ms=close_ms,
                k1=k1, k2=k2)


def mono_steps(poses, frames):
    """Per step: the cosine of the estimated and the true camera
    displacement, and the estimated / true length."""
    c = [np.linalg.inv(T)[:3, 3] for T in poses]
    g = [f.pose_gt[:3, 3] for f in frames]
    cos, ratio = [], []
    for i in range(1, len(frames)):
        de, dg = c[i] - c[i - 1], g[i] - g[i - 1]
        cos.append(float(de @ dg / (np.linalg.norm(de) * np.linalg.norm(dg) + 1e-12)))
        ratio.append(float(np.linalg.norm(de) / np.linalg.norm(dg)))
    return cos, ratio


def mono_summary(tag, r):
    ms = r["ms"][1:] or r["ms"]
    log(f"[mono {tag}] init frame {r['init']}, LOST {r['lost']}, relocalized {r['reloc']}, "
        f"keyframes {r['kfs']}, TrackLocalMap accepts {r['lm']}, loops (frame, keyframe "
        f"frame, inliers, scale) {r['loops']}; {np.mean(ms):.2f} ms/frame after the first "
        f"(first {r['ms'][0]:.1f} ms), close_loop {[round(x, 2) for x in r['close_ms']]} ms; "
        f"K1 {r['k1']}, K2 {r['k2']}")
    return dict(init=r["init"], lost=r["lost"], reloc=r["reloc"], keyframes=r["kfs"],
                lm_accepts=r["lm"], loops=r["loops"], ms_per_frame=float(np.mean(ms)),
                first_frame_ms=r["ms"][0], close_loop_ms=r["close_ms"], k1_launches=r["k1"],
                k2_launches=r["k2"])


def same_run(a, b, tol):
    """The events of two runs and their largest pose difference."""
    events = all(a[k] == b[k] for k in ("init", "lost", "reloc", "kfs", "lm"))
    events &= [l[:3] for l in a["loops"]] == [l[:3] for l in b["loops"]]
    events &= all(abs(x[3] - y[3]) <= tol for x, y in zip(a["loops"], b["loops"]))
    d = max(float(np.abs(a[k] - b[k]).max()) for k in ("online", "poses"))
    return events, d


def mono_profile(dev, grays):
    """One tracked frame with the backend on under the profiler, after the
    7 before it outside it (this also warms the mono path up for the timed
    runs): host wall ms of the call, the device kernels it ran and their
    summed device ms, and the device's idle share of the call."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    from multimot_track_tpu_torch.pipeline.mono import MonoTracker

    tr = MonoTracker(mono_config(), device=dev, sampler=mono_draws("shuttle"), keyframe_gap=2)
    for g in grays[:-1]:
        tr.track(g)
    sync(dev)
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        tr.track(grays[-1])
        sync(dev)
        wall_ms = 1e3 * (time.perf_counter() - t0)
    kernels = [e for e in prof.events() if e.device_type == torch.autograd.DeviceType.CUDA
               and not e.name.startswith(("Memcpy", "Memset"))]
    busy_ms = sum(e.time_range.elapsed_us() for e in kernels) / 1e3
    log(f"[mono profile] frame {len(grays) - 1}, backend on: {wall_ms:.1f} ms (host clock), "
        f"{len(kernels)} device kernels, {busy_ms:.2f} ms of device time, idle share "
        f"{1 - busy_ms / wall_ms:.3f}")
    return dict(wall_ms=wall_ms, device_kernels=len(kernels), device_ms=busy_ms,
                idle_share=1 - busy_ms / wall_ms)


def phase_mono(dev, log_dir):
    """Monocular tracking on the card (see the module docstring)."""
    import shutil

    import torch

    from multimot_track_tpu_torch.io.synth import (
        KITTI_SYNTH_CAM, make_junction_frames, write_euroc_tree, write_kitti_tree,
        write_tum_tree)
    from multimot_track_tpu_torch.ops import matching
    from multimot_track_tpu_torch.ops.match_cuda import match_projected_cuda

    t0 = time.perf_counter()
    frames = make_junction_frames(43, cam=dict(KITTI_SYNTH_CAM), texture="distinct",
                                  times=MONO_TIMES)
    log(f"[mono] rendered {len(frames)} distinct-junction frames (t = {list(MONO_TIMES)}) in "
        f"{time.perf_counter() - t0:.1f} s")
    grays = [f.gray for f in frames]
    shuttle = grays + grays[-2::-1]
    fig = {"profile": mono_profile(dev, grays)}

    # (a) the 8 frames, backend on and off, on the JAX package's draws
    for tag, draws, kw in (("backend on", "shuttle", dict(keyframe_gap=2)),
                           ("backend off", "off", dict(enable_backend=False))):
        r = run_mono_tracker(dev, grays, mono_draws(draws), **kw)
        cos, ratio = mono_steps(r["poses"], frames)
        f = mono_summary(tag, r)
        log(f"[mono {tag}] step direction cosines {[round(c, 4) for c in cos]}, scale "
            f"ratios (estimated / true) {[round(x, 5) for x in ratio]}")
        f.update(step_cosines=cos, scale_ratios=ratio)
        fig[tag] = f
        if r["init"] != 1 or r["lost"] or min(cos) <= 0.9 or r["k2"] == 0:
            raise SystemExit(f"mono {tag}: init {r['init']}, LOST {r['lost']}, cosines {cos}, "
                             f"K2 {r['k2']}")
        if not np.all(np.isfinite(r["poses"])):
            raise SystemExit(f"mono {tag}: non-finite poses")

    # (a') the shuttle on the card, then on the CPU, on the same draws
    calls = {}
    card = run_mono_tracker(dev, shuttle, mono_draws("shuttle"), record=calls, keyframe_gap=2)
    fig["shuttle card"] = mono_summary("shuttle card", card)
    cpu = run_mono_tracker(torch.device("cpu"), shuttle, mono_draws("shuttle"), keyframe_gap=2)
    fig["shuttle cpu"] = mono_summary("shuttle cpu", cpu)
    events, d = same_run(card, cpu, MONO_CPU_TOL)
    c = np.stack([np.linalg.inv(T)[:3, 3] for T in card["poses"]])
    back = float(np.linalg.norm(c[-1] - c[0]) / np.linalg.norm(c - c[0], axis=1).max())
    log(f"[mono shuttle] card against CPU: events equal {events}, max |dPose| {d:.3e} "
        f"(bound {MONO_CPU_TOL}); end-to-start distance {back:.4f} of the largest excursion")
    fig["shuttle card vs cpu"] = dict(events_equal=events, max_dpose=d, end_to_start=back)
    if not card["loops"] or not events or d > MONO_CPU_TOL or card["k2"] == 0:
        raise SystemExit(f"mono shuttle: card loops {card['loops']}, CPU {cpu['loops']}, "
                         f"events equal {events}, max |dPose| {d}")

    # (b) the shuttle through the plain matcher, and K2 on the path's own calls
    plain = run_mono_tracker(dev, shuttle, mono_draws("shuttle"), match_backend="torch",
                             keyframe_gap=2)
    events_p, d_p = same_run(card, plain, 1e-6)
    log(f"[mono shuttle plain matcher] events equal {events_p}, max |dPose| against K2 "
        f"{d_p:.3e} (bound {LIVE_T_ATOL}); K2 {plain['k2']}")
    fig["shuttle plain"] = dict(events_equal=events_p, max_dpose=d_p, k2_launches=plain["k2"])
    if not events_p or d_p > LIVE_T_ATOL or plain["k2"] != 0:
        raise SystemExit("mono shuttle: the plain matcher's run differs from K2's")
    k2_calls = []
    for radius, name in ((18.0, "tracked-mode match"), (12.0, "TrackLocalMap")):
        if radius not in calls:
            raise SystemExit(f"mono shuttle: no {name} call was recorded")
        args = calls[radius]
        bk, sk, ik = match_projected_cuda(*args, radius=radius)
        bp, sp, ip = matching.match_projected_plain(*args, radius=radius)
        sync(dev)
        n_diff = int((bk != bp).sum() + (sk != sp).sum() + (ik != ip).sum())
        err = float(torch.maximum((bk - bp).abs().max(), (sk - sp).abs().max()))
        ms_k = time_ms(lambda: match_projected_cuda(*args, radius=radius), rounds=5, reps=20)
        ms_p = time_ms(lambda: matching.match_projected_plain(*args, radius=radius),
                       rounds=5, reps=5)
        bound_us, bound_by, n_pairs = k2_bound_us(args, (bk, sk, ik), radius)
        split, _ = one_kernel_split(lambda: match_projected_cuda(*args, radius=radius))
        n_kern, us_dev = sum(n for n, _ in split.values()), per_call_us(split)
        shape = f"{args[0].shape[-2]} vs {args[3].shape[0]}, r = {radius:g}"
        log(f"[mono K2] {name} ({shape}, {int(args[2].sum())} valid queries): {n_diff} "
            f"differing outputs (must be 0) | kernel {us_dev / 1e3:.4f} ms device "
            f"({n_kern:.1f} kernels per call, profiler), {ms_k:.4f} ms/call (wrapper, CUDA "
            f"events), plain {ms_p:.4f} | bound {bound_us:.3f} us by {bound_by} "
            f"({n_pairs} gated pairs), {100 * bound_us / max(us_dev, 1e-9):.2f} % of bound")
        k2_calls.append(dict(call=name, shape=shape, max_abs_err=err, ms=us_dev / 1e3,
                             wrapper_ms=ms_k, plain_ms=ms_p, bound_ms=bound_us / 1e3,
                             bound_by=bound_by, kernels_per_call=n_kern))
        if n_diff:
            raise SystemExit(f"mono: K2 disagrees with its plain version on the {name}")
        if n_kern != 1:
            raise SystemExit(f"mono: K2 ran {n_kern} device kernels per call on the {name}")
    fig["k2_calls"] = k2_calls

    # the port's own host-generator draws (reported: the tracker's frame-2
    # PnP depends on them, in the JAX package as well)
    own = run_mono_tracker(dev, grays, HostSampler(0), keyframe_gap=2)
    fig["host draws seed 0"] = mono_summary("backend on, host draws seed 0", own)
    fig["host draws seed 0"]["step_cosines"] = mono_steps(own["poses"], frames)[0]

    # (c) the CLI on the card: --mono over a KITTI tree, --euroc over an EuRoC tree
    shutil.rmtree(MONO_DIR, ignore_errors=True)
    kitti = write_kitti_tree(os.path.join(MONO_DIR, "kitti"), frames, flow=False)
    (kitti / "kitti03.yaml").write_text(
        "%YAML:1.0\n" + "".join(f"Camera.{k}: {float(v)}\n" for k, v in KITTI_SYNTH_CAM.items()))
    euroc = write_euroc_tree(os.path.join(MONO_DIR, "euroc"), frames, KITTI_SYNTH_CAM)
    # the TUM reader guesses its intrinsics from the directory name: a run, not an accuracy cell
    tum = write_tum_tree(os.path.join(MONO_DIR, "rgbd_dataset_freiburg1_mono"), frames,
                         bf=KITTI_SYNTH_CAM["bf"])
    for tag, root, flags in (("--mono", kitti, ["--mono"]), ("--euroc", euroc, ["--euroc"]),
                             ("--tum --mono", tum, ["--tum", "--mono"])):
        out = os.path.join(MONO_DIR, "out" + "".join(flags))
        tr, _, summ, secs, k1, k2 = run_cli_logged(
            [str(root), *flags, "--out", out],
            os.path.join(log_dir, "mono_cli" + "".join(flags) + ".log"))
        traj = np.loadtxt(os.path.join(out, "mono_trajectory.txt"))
        log(f"[mono cli {tag}] {summ}; initialised at frame {tr.init_frame}; "
            f"{1e3 * secs / len(frames):.1f} ms/frame (host clock, frame loading included); "
            f"K1 {k1}, K2 {k2}; trajectory {traj.shape}")
        if traj.shape != (len(frames), 12) or not np.all(np.isfinite(traj)):
            raise SystemExit(f"mono cli {tag}: trajectory {traj.shape}")
        fig[f"cli {tag}"] = dict(summary=summ, init_frame=tr.init_frame,
                                 ms_per_frame=1e3 * secs / len(frames), k2_launches=k2)
    shutil.rmtree(MONO_DIR, ignore_errors=True)
    return fig


# ---------------------------------------------------------------------------
# Phase 13: the rest of the single-card surface

CIRCUIT_N, CIRCUIT_WINDOW = 220, 24     # phase 13(a): frames 0-23 of the 220-frame lap
SURFACE_DIR = os.path.join(REPO, "build", "scratch", "surface")
PROFILE_DIR = os.path.join(REPO, "build", "profile")
SIFT_SHARED_MIN, SIFT_DESC_ATOL, SIFT_TIE_RTOL = 0.99, 1e-4, 1e-5
DEPTH_BA_T_ATOL = 1e-4


def sift_agreement(img_cpu, a, b):
    """Card keypoints ``a`` against CPU keypoints ``b`` (numpy dicts):
    (shared share of the valid keypoints, angle flips, flips off a tie,
    max |d desc| over the shared keypoints).  A keypoint is shared when its
    position and scale are equal.  Where the angles differ the CPU's
    orientation histogram must tie the two bins (to SIFT_TIE_RTOL), and the
    card's descriptor is held to the CPU's ``_descriptors`` at the card's
    angle; elsewhere to the CPU's own descriptor."""
    import torch

    from multimot_track_tpu_torch.frontend import sift

    key = lambda k: {(float(u), float(v), float(s)): i for i, ((u, v), s) in
                     enumerate(zip(k["uv"], k["scale"])) if k["valid"][i]}
    ka, kb = key(a), key(b)
    shared = sorted(set(ka) & set(kb))
    ia = np.asarray([ka[k] for k in shared], np.int64)
    ib = np.asarray([kb[k] for k in shared], np.int64)
    flip = np.abs(a["angle"][ia] - b["angle"][ib]) > 1e-6
    hist = sift._orientation_hist(img_cpu, torch.from_numpy(b["uv"][ib])).numpy()
    tied = hist >= hist.max(-1, keepdims=True) * (1 - SIFT_TIE_RTOL)
    bin_a = np.round((a["angle"][ia] + np.pi) / (2 * np.pi) * 36 - 0.5).astype(int) % 36
    off_tie = int((flip & ~tied[np.arange(len(ib)), bin_a]).sum())
    ref = b["desc"][ib].copy()
    if flip.any():
        ref[flip] = sift._descriptors(
            img_cpu, torch.from_numpy(b["uv"][ib][flip]), torch.from_numpy(b["scale"][ib][flip]),
            torch.from_numpy(a["angle"][ia][flip])).numpy()
    err = float(np.abs(a["desc"][ia] - ref).max()) if len(ia) else float("inf")
    return len(shared) / max(len(ka), len(kb), 1), int(flip.sum()), off_tie, err


def depth_ba_problem(rng, n, cam):
    """A flow+depth BA problem as tests/test_flow_depth_ba.py builds it: n
    points 5-30 m deep, a known motion, flow noise 0.05 px, depth 8 %."""
    import torch

    from multimot_track_tpu_torch.geometry import camera, se3

    uv = rng.uniform([80, 40], [cam.width - 80, cam.height - 40], (n, 2)).astype(np.float32)
    z = rng.uniform(5.0, 30.0, (n,)).astype(np.float32)
    X = camera.backproject(torch.from_numpy(uv), torch.from_numpy(z), cam.fx, cam.fy, cam.cx, cam.cy)
    T_true = se3.exp_se3(torch.tensor([0.01, -0.02, 0.005, 0.3, -0.1, 1.1]))
    uv_cur = camera.project(se3.transform(T_true, X), cam.fx, cam.fy, cam.cx, cam.cy).numpy()
    flow = (uv_cur - uv + rng.normal(scale=0.05, size=(n, 2))).astype(np.float32)
    z_meas = (z * (1 + rng.normal(scale=0.08, size=n))).astype(np.float32)
    return uv, flow, z_meas


def phase_surface(dev, log_dir):
    """Phase 13 (see the module docstring)."""
    import shutil

    import torch

    from multimot_track_tpu_torch.config import DEFAULT_CONFIG
    from multimot_track_tpu_torch.frontend import sift
    from multimot_track_tpu_torch.io.png import read_png
    from multimot_track_tpu_torch.io.synth import (
        KITTI_SYNTH_CAM, make_circuit_frames, write_kitti_tree)
    from multimot_track_tpu_torch.solvers import flow_ba
    from multimot_track_tpu_torch.utils.profiling import StageTimer, annotate, trace

    fig = {}
    # (a) the circuit window at full width, live, synchronous
    t0 = time.perf_counter()
    frames = make_circuit_frames(CIRCUIT_N, cam=dict(KITTI_SYNTH_CAM),
                                 times=range(CIRCUIT_WINDOW + 1))
    render_s = time.perf_counter() - t0
    window, extra = frames[:CIRCUIT_WINDOW], frames[CIRCUIT_WINDOW]
    reset_launches()
    s, _, host_s, dev_ms = run_live(dev, window, DEFAULT_CONFIG)
    k1, k2 = read_launches()
    summ = s.summary()
    poses = np.stack(s.map.camera_poses)
    kf = s.keyframes
    ms = 1e3 * host_s / len(window)
    log(f"[surface circuit] frames 0-{CIRCUIT_WINDOW - 1} of the {CIRCUIT_N}-frame lap at "
        f"1242x375 rendered in {render_s:.1f} s ({CIRCUIT_WINDOW + 1} frames); live sync at "
        f"DEFAULT_CONFIG: {ms:.2f} ms/frame (host clock; {dev_ms / len(window):.2f} by events), "
        f"cam t-RPE mean {summ['cam_t_rpe_rel_mean']}, ATE {summ['ego_ate_rmse_m']} m, "
        f"{summ['n_obj_estimates']} object records, keyframes {[k.index for k in kf.frames]}, "
        f"loops {summ['n_loop_closures']}; K1 {k1}, K2 {k2} (refinements "
        f"{s.n_lm_dispatched} + fuse scans {kf.n_fuse_scans})")
    fig["circuit"] = dict(frames=len(window), render_s=render_s, ms_per_frame=ms,
                          cam_t_rpe_rel_mean=summ["cam_t_rpe_rel_mean"],
                          ego_ate_rmse_m=summ["ego_ate_rmse_m"],
                          n_obj_estimates=summ["n_obj_estimates"], k1_launches=k1,
                          k2_launches=k2, stages=s.stage_report())
    if not (np.all(np.isfinite(poses)) and len(poses) == len(window)
            and summ["cam_t_rpe_rel_mean"] < 0.02 and summ["ego_ate_rmse_m"] < 0.60
            and k1 > 0 and k2 == s.n_lm_dispatched + kf.n_fuse_scans > 0):
        raise SystemExit(f"surface circuit: {summ}, K1 {k1}, K2 {k2}")

    # (e) StageTimer and a profiler trace over one more live frame
    timer = StageTimer()
    shutil.rmtree(PROFILE_DIR, ignore_errors=True)
    with trace(PROFILE_DIR) as prof:
        with timer.stage("track_rgbd"), annotate("mmt_track_rgbd"):
            s.track_rgbd(extra)
            s.flush()
        with timer.stage("sift") as h, annotate("mmt_sift"):
            h["result"] = sift.extract_sift(torch.from_numpy(extra.gray).to(dev))
    events = json.load(open(prof.trace_path))["traceEvents"]
    names = {e.get("name") for e in events}
    n_kern = sum(1 for e in events if e.get("cat") == "kernel")
    log(f"[surface trace] {os.path.relpath(prof.trace_path, REPO)}: "
        f"{os.path.getsize(prof.trace_path) / 2 ** 20:.1f} MiB, {len(events)} events, "
        f"{n_kern} device kernels; stage timer:\n{timer.report()}")
    fig["trace"] = dict(events=len(events), device_kernels=n_kern, stages=timer.summary())
    if not {"mmt_track_rgbd", "mmt_sift"} <= names or n_kern == 0 \
            or sorted(timer.summary()) != ["sift", "track_rgbd"]:
        raise SystemExit("surface trace: the annotated names or the device kernels are missing")

    # (b) SIFT on the card against the CPU on one rendered frame
    img = extra.gray.astype(np.float32)
    kp_dev = sift.extract_sift(torch.from_numpy(img).to(dev), n_max=1024)
    kp_cpu = sift.extract_sift(torch.from_numpy(img), n_max=1024)
    a = {k: v.cpu().numpy() for k, v in kp_dev._asdict().items()}
    b = {k: v.numpy() for k, v in kp_cpu._asdict().items()}
    share, flips, off_tie, err = sift_agreement(torch.from_numpy(img), a, b)
    g = torch.from_numpy(img).to(dev)
    ms_sift = time_ms(lambda: sift.extract_sift(g, n_max=1024), rounds=3, reps=3)
    log(f"[surface sift] 1242x375, n_max 1024: {int(a['valid'].sum())} valid on the card, "
        f"{int(b['valid'].sum())} on the CPU; shared {100 * share:.2f} % (>= "
        f"{100 * SIFT_SHARED_MIN:.0f} %), {flips} angle flips ({off_tie} off a tie), "
        f"max |d desc| {err:.2e} (<= {SIFT_DESC_ATOL}); {ms_sift:.2f} ms a call (card)")
    fig["sift"] = dict(shared=share, angle_flips=flips, max_desc_err=err, ms=ms_sift)
    if share < SIFT_SHARED_MIN or off_tie or err > SIFT_DESC_ATOL:
        raise SystemExit("surface sift: the card disagrees with the CPU")

    # (c) the flow+depth BA on the card against the CPU at N = 4096
    cam = DEFAULT_CONFIG.camera
    uv, flow, z = depth_ba_problem(np.random.default_rng(61), 4096, cam)
    params = flow_ba.FlowDepthBAParams(iters=100, depth_prior_info=0.5)

    def solve(device):
        t = lambda x: torch.from_numpy(x).to(device)
        eye = torch.eye(4, device=device)
        return flow_ba.solve_flow_depth_ba(eye, eye, t(uv), t(flow), t(z),
                                           torch.ones(len(uv), dtype=torch.bool, device=device),
                                           cam.fx, cam.fy, cam.cx, cam.cy, params=params)

    rd, rc = solve(dev), solve(torch.device("cpu"))
    dT = float((rd.T.cpu() - rc.T).abs().max())
    ms_ba = time_ms(lambda: solve(dev), rounds=3, reps=2)
    log(f"[surface flow+depth BA] N = 4096: card vs CPU max |dT| {dT:.2e} (<= "
        f"{DEPTH_BA_T_ATOL}), inliers {int(rd.n_inliers)} / {int(rc.n_inliers)}; "
        f"{ms_ba:.2f} ms a call (card, one host read per LM step)")
    fig["flow_depth_ba"] = dict(max_dT=dT, inliers=[int(rd.n_inliers), int(rc.n_inliers)],
                                ms=ms_ba)
    if dT > DEPTH_BA_T_ATOL or int(rd.n_inliers) != int(rc.n_inliers):
        raise SystemExit("surface flow+depth BA: the card disagrees with the CPU")

    # (d) the CLI with --viz --out on a 4-frame KITTI tree
    shutil.rmtree(SURFACE_DIR, ignore_errors=True)
    root = write_kitti_tree(os.path.join(SURFACE_DIR, "kitti"), window[:4])
    (root / "kitti03.yaml").write_text(
        "%YAML:1.0\n" + "".join(f"Camera.{k}: {float(v)}\n" for k, v in KITTI_SYNTH_CAM.items()))
    out = os.path.join(SURFACE_DIR, "out")
    _, _, summ, secs, k1, k2 = run_cli_logged([str(root), "--viz", "--out", out],
                                              os.path.join(log_dir, "surface_cli_viz.log"))
    speed = sorted(f for f in os.listdir(out) if f.startswith("speed_"))
    shapes = {f: read_png(os.path.join(out, f)).shape for f in speed}
    traj = read_png(os.path.join(out, "traj.png"))
    log(f"[surface cli --viz] {speed} at {set(shapes.values())}, traj.png {traj.shape} with "
        f"{int((traj != 255).any(-1).sum())} drawn pixels; {1e3 * secs / 4:.1f} ms/frame; "
        f"K1 {k1}, K2 {k2}; ATE {summ['ego_ate_rmse_m']} m")
    fig["cli_viz"] = dict(speed_png=len(speed), ms_per_frame=1e3 * secs / 4,
                          drawn_traj_pixels=int((traj != 255).any(-1).sum()))
    shutil.rmtree(SURFACE_DIR, ignore_errors=True)
    if speed != [f"speed_{i:06d}.png" for i in (1, 2, 3)] \
            or set(shapes.values()) != {(375, 1242, 3)} or traj.shape != (800, 800, 3) \
            or not (traj != 255).any():
        raise SystemExit("surface cli: --viz / traj.png images missing or wrong")
    return fig


def main(argv) -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    smi = nvidia_smi()
    dev = torch.device("cuda", 0)
    log(f"[card] {smi} | torch {torch.__version__} CUDA {torch.version.cuda} | "
        f"{torch.cuda.get_device_name(0)}")
    sys.path.insert(0, REPO)
    from concurrent.futures import ThreadPoolExecutor

    from multimot_track_tpu_torch import kernels
    from multimot_track_tpu_torch.io.synth import KITTI_SYNTH_CAM, make_junction_frames

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    log_dir = os.path.abspath(argv[argv.index("--logs") + 1]) if "--logs" in argv else LOG_DIR
    t0 = time.perf_counter()
    builds = ([(name, kernels.build) for name in KERNELS]
              + [(name, kernels.build_native) for name in NATIVE])
    with ThreadPoolExecutor(len(builds)) as pool:   # one compiler per source, together
        futures = [(name, pool.submit(fn, name)) for name, fn in builds]
        for name, fut in futures:
            lib = fut.result()
            log(f"[build] {name} built by {time.perf_counter() - t0:.1f} s "
                f"({(lib.parent / 'build.log').read_text().splitlines()[-1]})")
    for name in KERNELS:
        kernels.load(name)
        for line in kernels.build_log(name).splitlines():
            if "ptxas" in line or "seconds" in line:
                log(f"[build] {name}: {line.strip()}")
    if "--k2-only" in argv:                 # phases 1, 2 and 5 alone, no result lines
        phase_match_kernel(dev)
        return 0
    if "--mono-only" in argv:               # phases 1, 2 and 12 alone, no result lines
        log(json.dumps({"mono": phase_mono(dev, log_dir)}, default=float))
        return 0
    if "--surface-only" in argv:            # phases 1, 2 and 13 alone, no result lines
        log(json.dumps({"surface": phase_surface(dev, log_dir)}, default=float))
        return 0
    if "--entry-only" in argv:              # phases 1, 2 and 11 alone, no result lines
        frames = make_junction_frames(n_frames=12, cam=dict(KITTI_SYNTH_CAM))
        log(json.dumps({"entry": phase_entry(dev, frames, None, log_dir)}))
        return 0
    k1 = phase_kernel_vs_plain(dev)
    if "--k1-only" in argv:                 # phases 1-3 alone, no result lines
        return 0
    t0 = time.perf_counter()
    frames = make_junction_frames(n_frames=12, cam=dict(KITTI_SYNTH_CAM))
    log(f"[scene] rendered {len(frames)} junction frames in {time.perf_counter() - t0:.1f} s")
    phase_slice(dev, frames)
    k2 = phase_match_kernel(dev)
    live = phase_live(dev, frames)
    phase_window(dev, frames, live["system"])
    t0 = time.perf_counter()
    shuttle = shuttle_frames()
    log(f"[scene] rendered the {len(shuttle)}-frame shuttle in {time.perf_counter() - t0:.1f} s")
    loop = phase_loop(dev, shuttle)
    loop_solvers = phase_loop_solvers(dev)
    log(json.dumps({"loop": loop, "loop_solvers": loop_solvers}))
    bow = phase_bow(dev)
    bow_live = phase_bow_live(dev, shuttle, loop)
    discovery = phase_discovery(dev, frames)
    discovery_live = phase_discovery_live(dev, frames)
    log(json.dumps({"bow": bow, "bow_live": bow_live, "discovery": discovery,
                    "discovery_live": discovery_live}))
    entry = phase_entry(dev, frames, live["ms_per_frame"], log_dir)
    log(json.dumps({"entry": entry}))
    mono = phase_mono(dev, log_dir)
    log(json.dumps({"mono": mono}, default=float))
    surface = phase_surface(dev, log_dir)
    log(json.dumps({"surface": surface}, default=float))

    obj, lm = k1[1], k2[0]                  # the live object stage, TrackLocalMap's shape
    log(json.dumps({"kernels": [{
        "name": "flow_ba_lm",
        "route": "cuda",
        "source": "multimot_track_tpu_torch/csrc/flow_ba_lm.cu",
        "replaces": "multimot_track_tpu/solvers/flow_ba_pallas.py:372",
        "launches": live["k1_launches"],
        "circuit_launches": surface["circuit"]["k1_launches"],
        "max_abs_err": max(f["max_abs_err"] for f in k1),
        "ms": obj["ms"],
        "plain_ms": obj["plain_ms"],
        "bound_ms": obj["bound_ms"],
        "bound_by": obj["bound_by"],
        "library_ms": None,        # no single PyTorch call runs an LM solve
    }, {
        "name": "match_projected",
        "route": "cuda",
        "source": "multimot_track_tpu_torch/csrc/match_projected.cu",
        "replaces": "multimot_track_tpu/ops/pallas_match.py:63",
        "launches": live["k2_launches"],
        "mono_launches": mono["backend on"]["k2_launches"],
        "circuit_launches": surface["circuit"]["k2_launches"],
        "max_abs_err": max(f["max_abs_err"] for f in k2 + mono["k2_calls"]),
        "ms": lm["ms"],
        "plain_ms": lm["plain_ms"],
        "bound_ms": lm["bound_ms"],
        "bound_by": lm["bound_by"],
        "library_ms": None,        # no single PyTorch call gives a gated top-2 Hamming match
    }]}))
    log(smi)
    log(json.dumps({"ok": True, "device": {"platform": "gpu",
                                           "kind": torch.cuda.get_device_name(0),
                                           "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
