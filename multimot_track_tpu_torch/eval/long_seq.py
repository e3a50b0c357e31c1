"""Long multi-scene evaluation at KITTI resolution, on the card.

Port of the JAX package's ``tools/eval_long_seq.py`` (``run_scene``,
``run_mono_scene``, ``main``, ``_write_outputs``): the full live system
over two analytic scenes of ``io/synth`` rendered at the kitti03.yaml
camera (1242x375, fx 721.5377):

  circuit : one full 360-deg lap + 12 % overlap (a genuine revisit: loop
            closure and the post-loop global BA), 7 movers
  avenue  : 180 m with S-curves, lead / oncoming / crossing traffic

``--noise`` adds each scene under ``degrade_frames`` (the reference's depth,
flow, mask and gray noise models; the ground truth stays exact), and
``--mono`` runs ``MonoTracker`` with and without its backend over each
scene's distinct-texture gray stream.  The rows go to ``<out>.json`` and
``<out>.md`` (default ``LONGSEQ_torch``; the JAX package's ``LONGSEQ.json``
is never written), rewritten after every row so a cut run leaves a
consistent partial record.  Every row carries the card's name, power limit
and peak device memory.

    python -m multimot_track_tpu_torch.eval.long_seq [--frames 220] [--quick]
        [--noise] [--mono] [--cpu] [--out LONGSEQ_torch]

Everything runs on the card unless ``--cpu`` is given; without a card and
without ``--cpu`` it raises.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import pathlib
import subprocess
import time

import numpy as np
import torch


def card_info(device) -> dict:
    """The device a row ran on: torch's name, and the card's name and power
    limit as ``nvidia-smi`` prints them (None on the CPU)."""
    device = torch.device(device)
    if device.type != "cuda":
        return {"device": "cpu", "card": None}
    try:
        smi = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
            capture_output=True, text=True, timeout=30).stdout.strip().splitlines()[0]
    except (OSError, IndexError, subprocess.TimeoutExpired):
        smi = None
    return {"device": torch.cuda.get_device_name(device), "card": smi}


def _launch_counters():
    from multimot_track_tpu_torch.ops.match_cuda import match_projected_cuda
    from multimot_track_tpu_torch.solvers.flow_ba_cuda import solve_flow_ba_cuda

    return solve_flow_ba_cuda, match_projected_cuda


def _start(device):
    """Zero the kernels' launch counts and the peak-memory statistic."""
    for fn in _launch_counters():
        fn.launches = 0
    if device.type == "cuda":
        torch.cuda.synchronize(device)
        torch.cuda.reset_peak_memory_stats(device)


def _finish(device) -> dict:
    """K1 / K2 launches and the peak device memory since ``_start``."""
    k1, k2 = (fn.launches for fn in _launch_counters())
    out = {"k1_launches": k1, "k2_launches": k2, "peak_mem_gib": None}
    if device.type == "cuda":
        torch.cuda.synchronize(device)
        out["peak_mem_gib"] = torch.cuda.max_memory_allocated(device) / 2 ** 30
    return out


def run_scene(name, frames, cfg, device, **kw):
    """``MultiMotSystem`` over ``frames``: the scene's accuracy, its
    per-object medians, the stage totals, wall seconds and the kernels'
    launches (``kw`` goes to the system's constructor)."""
    from multimot_track_tpu_torch.pipeline.system import MultiMotSystem

    device = torch.device(device)
    sys_ = MultiMotSystem(cfg, device=device, **kw)
    _start(device)
    t0 = time.perf_counter()
    for fd in frames:
        sys_.track_rgbd(fd)
    s = sys_.summary()
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    wall = time.perf_counter() - t0
    recs = [r for r in sys_.map.obj_records if r.has_gt]
    by_sem = {}
    for r in recs:
        by_sem.setdefault(int(r.sem_label), []).append(r)
    per_obj = {
        k: {
            "n": len(rs),
            # a tracked but unevaluable record (a degenerate GT pair) is
            # counted, and kept out of the medians
            "n_nonfinite": int(sum(not np.isfinite(r.t_rpe_centred) for r in rs)),
            "t_rpe_med": float(np.nanmedian([r.t_rpe_rel for r in rs])),
            "t_rpe_centred_med": float(np.nanmedian([r.t_rpe_centred for r in rs])),
            "r_rpe_med": float(np.nanmedian([r.r_rpe_rel for r in rs])),
            "speed_err_med": float(np.median(
                [r.speed_err_rel for r in rs if np.isfinite(r.speed_err_rel)] or [np.nan])),
        }
        for k, rs in sorted(by_sem.items())
    }
    poses = np.stack(sys_.map.camera_poses)
    return {
        "scene": name,
        "n_frames": s["n_frames"],
        "wall_s": wall,
        "fps": s["n_frames"] / wall,
        "ms_per_frame": 1e3 * wall / s["n_frames"],
        "cam_t_rpe_rel_mean": s["cam_t_rpe_rel_mean"],
        "cam_r_rpe_rel_mean": s["cam_r_rpe_rel_mean"],
        "ego_ate_rmse_m": s["ego_ate_rmse_m"],
        "ego_ate_rmse_raw_m": s["ego_ate_rmse_raw_m"],
        "n_loop_closures": s["n_loop_closures"],
        "loop_events": [[int(x) for x in e[:3]] for e in sys_.map.loop_events],
        "n_keyframes": len(sys_.keyframes.frames) if sys_.keyframes is not None else 0,
        "poses_finite": bool(np.all(np.isfinite(poses))),
        "n_obj_estimates": s["n_obj_estimates"],
        "obj_t_rpe_rel_mean": s["obj_t_rpe_rel_mean"],
        "obj_t_rpe_centred_med": (float(np.nanmedian([r.t_rpe_centred for r in recs]))
                                  if recs else float("nan")),
        "obj_speed_err_rel_mean": s["obj_speed_err_rel_mean"],
        "n_distinct_movers": len(by_sem),
        "stages": sys_.stage_report(),
        **_finish(device),
        **card_info(device),
        "per_object": per_obj,
    }


def _scale_series(poses, frames, skip=4):
    """Per-pair estimated / true translation ratio (the monocular scale)."""
    ratios = []
    for i in range(skip, len(poses)):
        Twc_a = np.linalg.inv(poses[i - 1])
        Twc_b = np.linalg.inv(poses[i])
        est = np.linalg.norm(Twc_b[:3, 3] - Twc_a[:3, 3])
        gt = np.linalg.norm(frames[i].pose_gt[:3, 3] - frames[i - 1].pose_gt[:3, 3])
        if gt > 1e-6 and est > 1e-9:
            ratios.append(est / gt)
    return np.asarray(ratios)


def _scale_drift(r):
    head = np.median(r[: max(5, len(r) // 5)])
    tail = np.median(r[-max(5, len(r) // 5):])
    return float(abs(np.log(tail / head)))


def run_mono_scene(name, frames, cfg, enable_backend, device):
    """``MonoTracker`` over the scene's gray stream: the Sim3-aligned ATE and
    the scale drift, with or without the backend ladder."""
    from multimot_track_tpu_torch.eval.metrics import absolute_trajectory_error
    from multimot_track_tpu_torch.pipeline.mono import MonoTracker

    device = torch.device(device)
    tr = MonoTracker(cfg, n_kp=768, enable_backend=enable_backend, keyframe_gap=3,
                     device=device)
    _start(device)
    t0 = time.perf_counter()
    for fd in frames:
        tr.track(fd.gray)
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    wall = time.perf_counter() - t0
    est = np.stack([np.linalg.inv(T) for T in tr.poses]).astype(np.float32)
    gt = np.stack([fd.pose_gt for fd in frames]).astype(np.float32)
    ate, _ = absolute_trajectory_error(torch.from_numpy(est), torch.from_numpy(gt),
                                       with_scale=True)
    ratios = _scale_series(tr.poses, frames)
    return {
        "scene": name,
        "mode": "mono+backend" if enable_backend else "mono-vo",
        "n_frames": len(frames),
        "wall_s": wall,
        "fps": len(frames) / wall,
        "ms_per_frame": 1e3 * wall / len(frames),
        "ate_sim3_m": float(ate),
        "scale_drift_log": _scale_drift(ratios) if ratios.size > 20 else None,
        "n_scale_pairs": int(ratios.size),
        "n_loop_closures": len(tr.loop_events),
        "init_frame": tr.init_frame,
        "n_lost_frames": tr.n_lost_frames,
        **_finish(device),
        **card_info(device),
    }


def parse_args(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--frames", type=int, default=220)
    ap.add_argument("--quick", action="store_true",
                    help="48 frames at 640x384 (a small sanity run)")
    ap.add_argument("--noise", action="store_true",
                    help="also run each scene on degraded inputs (the reference's "
                    "depth-noise model, its 1/35 flow-outlier injector, mask erosion "
                    "and gray noise); the ground truth stays exact")
    ap.add_argument("--mono", action="store_true",
                    help="also run MonoTracker (VO only and full backend) over each "
                    "scene's gray stream: Sim3 ATE and scale drift")
    ap.add_argument("--cpu", action="store_true", help="run on the CPU instead of the card")
    ap.add_argument("--out", default="LONGSEQ_torch",
                    help="output path without suffix: <out>.json and <out>.md")
    return ap.parse_args(argv)


def main(argv=None):
    args = parse_args(argv)
    from multimot_track_tpu_torch.config import DEFAULT_CONFIG
    from multimot_track_tpu_torch.io import synth

    device = torch.device("cpu" if args.cpu else "cuda")
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("eval.long_seq runs on the card and found no CUDA device; "
                           "pass --cpu to run on the CPU")
    if args.quick:
        cam = dict(synth.SYNTH_CAM)
        cfg = dataclasses.replace(
            DEFAULT_CONFIG, camera=synth.synth_camera_config(),
            padding=dataclasses.replace(DEFAULT_CONFIG.padding, n_static_max=1024,
                                        n_obj_pts_max=4096))
        n = 48
    else:
        cam = dict(synth.KITTI_SYNTH_CAM)
        cfg = DEFAULT_CONFIG      # camera == kitti03.yaml == KITTI_SYNTH_CAM
        n = args.frames

    out = pathlib.Path(args.out)
    results, mono_rows = [], []
    for name, mk in (
        ("circuit", lambda tex="default": synth.make_circuit_frames(
            n_frames=n, cam=dict(cam), texture=tex)),
        ("avenue", lambda tex="default": synth.make_avenue_frames(
            n_frames=int(n * 1.09), cam=dict(cam), texture=tex)),
    ):
        print(f"[long_seq] rendering {name} ...", flush=True)
        t0 = time.perf_counter()
        frames = mk()
        print(f"  rendered {len(frames)} frames in {time.perf_counter() - t0:.1f} s",
              flush=True)
        variants = [(name, frames)]
        if args.noise:
            variants.append((f"{name}-noisy", synth.degrade_frames(frames, seed=11,
                                                                    bf=cam["bf"])))
        for vname, vframes in variants:
            r = run_scene(vname, vframes, cfg, device)
            print("  " + json.dumps({k: v for k, v in r.items()
                                     if k not in ("per_object", "stages")}), flush=True)
            print("  stages: " + json.dumps({k: v["total_s"] for k, v in r["stages"].items()}),
                  flush=True)
            results.append(r)
            write_outputs(out, results, mono_rows)
        del frames, variants
        if args.mono:
            # descriptor-based mono needs locally distinctive texture
            # (io/synth._texture_distinct); same geometry, exact ground truth
            mono_frames = mk("distinct")
            for backend in (False, True):
                m = run_mono_scene(name, mono_frames, cfg, backend, device)
                print("  " + json.dumps(m), flush=True)
                mono_rows.append(m)
                write_outputs(out, results, mono_rows)
            del mono_frames
    print(f"[long_seq] wrote {out}.json / {out}.md")
    return results, mono_rows


def _pct(x):
    return "-" if x is None or not np.isfinite(x) else f"{100 * x:.3f}%"


def write_outputs(out: pathlib.Path, results, mono_rows):
    """(Re)write ``<out>.json`` and ``<out>.md`` from the rows so far."""
    out.parent.mkdir(parents=True, exist_ok=True)
    out.with_suffix(".json").write_text(json.dumps(
        {"rows": results, "mono_rows": mono_rows}, indent=1, default=float))
    card = (results or mono_rows)[0]
    lines = [
        "# LONGSEQ_torch: long multi-scene evaluation of the PyTorch/CUDA port",
        "",
        "Generated by `python -m multimot_track_tpu_torch.eval.long_seq` on "
        f"{card['device']} ({card['card'] or 'no card'}).  Scenes: "
        "`io/synth.make_circuit_frames` (a full 360-deg lap and its revisit, 7 movers) and "
        "`make_avenue_frames` (180 m, S-curves, 10 mover lifespans sharing 5 labels), "
        "rendered at the kitti03.yaml camera; the live `MultiMotSystem` at DEFAULT_CONFIG.  "
        "The ground truth is exact.  `-noisy` rows are the same scenes under "
        "`degrade_frames(seed=11)`.  The JAX package's record of the same scenes is "
        "`LONGSEQ.md`.",
        "",
        "| scene | frames | loop closures | ego t-RPE | ego ATE (m) | movers "
        "| obj t-RPE centred (med) | speed err mean | ms/frame | peak GiB | K1 | K2 |",
        "|---|---|---|---|---|---|---|---|---|---|---|---|",
    ]
    for r in results:
        mem = "-" if r["peak_mem_gib"] is None else f"{r['peak_mem_gib']:.3f}"
        lines.append(
            f"| {r['scene']} | {r['n_frames']} | {r['n_loop_closures']} | "
            f"{_pct(r['cam_t_rpe_rel_mean'])} | {r['ego_ate_rmse_m']:.4f} | "
            f"{r['n_distinct_movers']} | {_pct(r['obj_t_rpe_centred_med'])} | "
            f"{_pct(r['obj_speed_err_rel_mean'])} | {r['ms_per_frame']:.2f} | {mem} | "
            f"{r['k1_launches']} | {r['k2_launches']} |")
    if mono_rows:
        lines += [
            "",
            "## Monocular at scale (gray stream only, up to scale)",
            "",
            "`MonoTracker` over the same scenes' distinct-texture gray frames: Sim3-aligned "
            "ATE and scale drift |log(late / early scale)|, VO only and with the backend.",
            "",
            "| scene | mode | frames | init frame | LOST frames | ATE Sim3 (m) "
            "| scale drift (log) | loop closures | ms/frame | K2 |",
            "|---|---|---|---|---|---|---|---|---|---|",
        ]
        for m in mono_rows:
            drift = m["scale_drift_log"]
            drift = "-" if drift is None else f"{drift:.4f}"
            lines.append(
                f"| {m['scene']} | {m['mode']} | {m['n_frames']} | {m['init_frame']} | "
                f"{m['n_lost_frames']} | {m['ate_sim3_m']:.4f} | {drift} | "
                f"{m['n_loop_closures']} | {m['ms_per_frame']:.2f} | {m['k2_launches']} |")
    if results:
        keys = list(results[0]["stages"])
        lines += [
            "",
            "## Stage totals (seconds per scene, host clock)",
            "",
            "| scene | " + " | ".join(keys) + " |",
            "|---" * (1 + len(keys)) + "|",
        ]
        for r in results:
            lines.append(f"| {r['scene']} | " + " | ".join(
                str(r["stages"].get(k, {}).get("total_s", "-")) for k in keys) + " |")
    lines += ["", f"Per-object medians and wall seconds are in `{out.name}.json`."]
    out.with_suffix(".md").write_text("\n".join(lines) + "\n")


if __name__ == "__main__":
    main()
