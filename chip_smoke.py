#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port (multimot_track_tpu_torch) on one GPU.

    python3 chip_smoke.py

Phases, in order; any failure exits non-zero before the result lines:
  1. the card: ``nvidia-smi`` name and power limit, torch's device name;
  2. build kernel K1 (csrc/flow_ba_lm.cu) with nvcc, print the build time
     and the compiler's register / shared-memory report;
  3. K1 against its plain torch version on the card, at the main path's
     stage shapes: 2 instances x N=2048 with point weights (a camera stage)
     and 18 instances x N=4096 (an object stage), inputs from a numpy seed;
     ms per call of both (wrapper included: input planes, launch), the
     median of rounds of back-to-back calls;
  4. the slice: ``run_sequence_batched`` at DEFAULT_CONFIG (1242x375, 2048
     static / 8192 object points, 8 label slots, 6 solved, 3 seeds, 2
     reclassify rounds) on make_junction_frames(12) (7 movers per frame),
     once through the kernel (counting its launches) and once with the plain
     flow-BA, then ``run_sequence_streaming`` (chunk 4) once; ms per pair
     after a warm-up, peak memory, per-pair camera and object errors.
Then one JSON line of kernel figures, the nvidia-smi line, and the final
``{"ok": true, "device": ...}`` line.  Imports nothing of JAX.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys
import time

import numpy as np

REPO = os.path.dirname(os.path.abspath(__file__))

# K1 contract with its plain version (the Pallas-vs-XLA contract of the JAX
# package, tests/test_flow_ba_pallas.py): float32 sums in another order
T_ATOL, INLIER_TOL, REPROJ_RTOL = 2e-4, 2, 0.05


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


def phase_kernel_vs_plain(dev):
    import torch

    from multimot_track_tpu_torch.config import SolverConfig
    from multimot_track_tpu_torch.solvers import flow_ba
    from multimot_track_tpu_torch.solvers.flow_ba_cuda import solve_flow_ba_cuda

    sol = SolverConfig()
    rng = np.random.default_rng(0)
    stages = []
    cam = make_flow_ba_problem(rng, 2, 2048, np.array([0.004, 0.004, 0.004, 0.1, 0.05, 0.5]))
    cam["point_weight"] = 1.0 / (1.0 + (cam["depth"] / sol.cam_depth_weight_z0) ** 2)
    stages.append(("camera 2 x 2048 (point weights)", cam, flow_ba.FlowBAParams(
        reproj_info=sol.reproj_info, prior_info=sol.cam_flow_prior_info,
        rp_thres=sol.cam_rp_thres, iters=sol.cam_lm_iters, tau=sol.lm_tau)))
    obj = make_flow_ba_problem(rng, 18, 4096, np.array([0.01, 0.01, 0.01, 0.2, 0.05, 0.4]))
    obj["point_weight"] = None
    stages.append(("object 18 x 4096", obj, flow_ba.FlowBAParams(
        reproj_info=sol.reproj_info, prior_info=sol.obj_flow_prior_info,
        rp_thres=sol.obj_rp_thres, iters=sol.obj_lm_iters, tau=sol.lm_tau)))

    figures = []
    for name, prob, params in stages:
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
        ms_k = time_ms(run_k, rounds=5, reps=10)
        ms_p = time_ms(run_p, rounds=3, reps=2)
        log(f"[K1] {name}: max|dT|={dT:.3e} (atol {T_ATOL}) max|d n_inliers|={dn} "
            f"(tol {INLIER_TOL}) max rel d mean_reproj={rel:.3e} (rtol {REPROJ_RTOL}) "
            f"| kernel {ms_k:.4f} ms/launch, plain {ms_p:.4f} ms")
        if not (finite and dT <= T_ATOL and dn <= INLIER_TOL and rel <= REPROJ_RTOL):
            raise SystemExit(f"K1 disagrees with its plain version on {name}")
        figures.append(dict(stage=name, max_abs_err=dT, ms=ms_k, plain_ms=ms_p))
    return figures


def finite_tree(res) -> bool:
    from multimot_track_tpu_torch.pipeline.frames import tree_map

    ok = []
    tree_map(lambda x: ok.append(bool(np.all(np.isfinite(x)))
                                 if np.issubdtype(np.asarray(x).dtype, np.floating)
                                 else True), res)
    return all(ok)


def phase_slice(dev):
    import torch

    from multimot_track_tpu_torch.config import DEFAULT_CONFIG
    from multimot_track_tpu_torch.io.synth import KITTI_SYNTH_CAM, make_junction_frames
    from multimot_track_tpu_torch.pipeline import batch
    from multimot_track_tpu_torch.solvers.flow_ba_cuda import solve_flow_ba_cuda

    t0 = time.perf_counter()
    frames = make_junction_frames(n_frames=12, cam=dict(KITTI_SYNTH_CAM))
    log(f"[slice] rendered {len(frames)} junction frames in {time.perf_counter() - t0:.1f} s")
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


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    smi = nvidia_smi()
    dev = torch.device("cuda", 0)
    log(f"[card] {smi} | torch {torch.__version__} CUDA {torch.version.cuda} | "
        f"{torch.cuda.get_device_name(0)}")
    sys.path.insert(0, REPO)
    from multimot_track_tpu_torch import kernels

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    t0 = time.perf_counter()
    kernels.load("flow_ba_lm")
    log(f"[build] flow_ba_lm built/loaded in {time.perf_counter() - t0:.1f} s")
    for line in kernels.build_log("flow_ba_lm").splitlines():
        if "ptxas" in line or "seconds" in line:
            log(f"[build] {line.strip()}")

    k1 = phase_kernel_vs_plain(dev)
    sl = phase_slice(dev)

    obj = k1[-1]
    log(json.dumps({"kernels": [{
        "name": "flow_ba_lm",
        "route": "cuda",
        "source": "multimot_track_tpu_torch/csrc/flow_ba_lm.cu",
        "replaces": "multimot_track_tpu/solvers/flow_ba_pallas.py:372",
        "launches": sl["launches"],
        "max_abs_err": max(f["max_abs_err"] for f in k1),
        "ms": obj["ms"],
        "plain_ms": obj["plain_ms"],
    }]}))
    log(smi)
    log(json.dumps({"ok": True, "device": {"platform": "gpu",
                                           "kind": torch.cuda.get_device_name(0),
                                           "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
