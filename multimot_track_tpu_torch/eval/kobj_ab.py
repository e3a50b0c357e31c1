"""Dense-traffic ``k_obj_solve`` A/B on the card.

Port of the JAX package's ``tools/measure_kobj_ab.py`` (``run_one``,
``main``).  The tracker solves a top-``k_obj_solve`` batch of the object
slots each frame; movers beyond it are inactive for that frame.  On the
junction scene (``io/synth.make_junction_frames``: 7+ concurrent movers
with distinct labels) this measures what the cap costs in accuracy and
ID stability for k in {4, 6, 8}: per-label record coverage (frames with a
ground-truth-matched estimate / frames the label is visible), translation
and speed accuracy, and the coverage gaps (frames where a label tracked
before has no record).  The JAX tool's device cost column came from the
TPU's KCURVE.json and has no counterpart here: the rows carry this run's
own ms per frame on its device.

    python -m multimot_track_tpu_torch.eval.kobj_ab [--frames 60] [--kitti] [--cpu]
        [--out KOBJ_AB_torch]

Writes ``<out>.json`` and prints one row per k.  Everything runs on the
card unless ``--cpu`` is given; without a card and without ``--cpu`` it
raises.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import pathlib
import time

import numpy as np
import torch

from multimot_track_tpu_torch.eval.long_seq import card_info


def run_one(frames, cfg, k_solve, device):
    """The live system with ``k_obj_solve = k_solve`` (8 slots) over
    ``frames``: coverage, gaps and accuracy per visible label."""
    from multimot_track_tpu_torch.pipeline.system import MultiMotSystem

    device = torch.device(device)
    cfg = dataclasses.replace(
        cfg, padding=dataclasses.replace(cfg.padding, k_obj_max=8, k_obj_solve=k_solve))
    sys_ = MultiMotSystem(cfg, device=device)
    t0 = time.perf_counter()
    for fd in frames:
        sys_.track_rgbd(fd)
    s = sys_.summary()
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    wall = time.perf_counter() - t0

    # visibility: frames where each label has enough mask pixels to be
    # estimable at all (the tracker's minimum-point gate)
    vis = {}
    for fd in frames:
        lab, cnt = np.unique(fd.sem_mask[fd.sem_mask > 0], return_counts=True)
        for lb, c in zip(lab.tolist(), cnt.tolist()):
            if c >= 150:
                vis.setdefault(lb, set()).add(fd.index)

    recs = [r for r in sys_.map.obj_records if r.has_gt]
    by_sem = {}
    for r in recs:
        by_sem.setdefault(int(r.sem_label), []).append(r)

    per_label = {}
    total_gaps = 0
    for lb, frames_vis in sorted(vis.items()):
        rs = by_sem.get(lb, [])
        got = sorted(int(r.frame) for r in rs)
        # coverage gaps: visible frames after the first acquisition with no
        # record (the demotion dropout)
        gaps = 0
        if got:
            have = set(got)
            gaps = sum(1 for f in frames_vis if got[0] < f <= got[-1] and f not in have)
        total_gaps += gaps
        per_label[lb] = {
            "n_visible": len(frames_vis),
            "n_records": len(rs),
            "coverage": len(rs) / max(len(frames_vis), 1),
            "gaps": gaps,
            "t_rpe_centred_med": (float(np.nanmedian([r.t_rpe_centred for r in rs]))
                                  if rs else None),
            "speed_err_med": (float(np.nanmedian(
                [r.speed_err_rel for r in rs if np.isfinite(r.speed_err_rel)] or [np.nan]))
                if rs else None),
        }

    tracked = [lb for lb, d in per_label.items() if d["n_records"] >= 5]
    tc = [per_label[lb]["t_rpe_centred_med"] for lb in tracked
          if per_label[lb]["t_rpe_centred_med"] is not None]
    return {
        "k_obj_solve": k_solve,
        "wall_s": wall,
        "ms_per_frame": 1e3 * wall / len(frames),
        "n_labels_visible": len(vis),
        "n_labels_tracked": len(tracked),
        "n_records": len(recs),
        "total_gaps": total_gaps,
        "mean_coverage": float(np.mean([d["coverage"] for d in per_label.values()])),
        "t_rpe_centred_med_over_labels": float(np.median(tc)) if tc else None,
        "cam_t_rpe": s["cam_t_rpe_rel_mean"],
        **card_info(device),
        "per_label": per_label,
    }


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--frames", type=int, default=60)
    ap.add_argument("--kitti", action="store_true",
                    help="the KITTI camera and DEFAULT_CONFIG instead of the 640x384 "
                    "camera with a reduced configuration")
    ap.add_argument("--cpu", action="store_true", help="run on the CPU instead of the card")
    ap.add_argument("--out", default="KOBJ_AB_torch", help="output path without suffix")
    args = ap.parse_args(argv)

    from multimot_track_tpu_torch.config import DEFAULT_CONFIG
    from multimot_track_tpu_torch.io import synth

    device = torch.device("cpu" if args.cpu else "cuda")
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("eval.kobj_ab runs on the card and found no CUDA device; "
                           "pass --cpu to run on the CPU")
    if args.kitti:
        cam = dict(synth.KITTI_SYNTH_CAM)
        cfg = DEFAULT_CONFIG
    else:
        cam = dict(synth.SYNTH_CAM)
        # obj_sample_step 2 restores the reference's world-space sample
        # density at the smaller camera's resolution
        cfg = dataclasses.replace(
            DEFAULT_CONFIG, camera=synth.synth_camera_config(),
            frontend=dataclasses.replace(DEFAULT_CONFIG.frontend, obj_sample_step=2),
            padding=dataclasses.replace(DEFAULT_CONFIG.padding, n_static_max=1024,
                                        n_obj_pts_max=8192),
            solver=dataclasses.replace(DEFAULT_CONFIG.solver, ransac_iters=200,
                                       cam_lm_iters=60, obj_lm_iters=100),
        )

    print(f"[kobj_ab] rendering junction ({args.frames} frames) ...", flush=True)
    frames = synth.make_junction_frames(n_frames=args.frames, cam=cam)
    rows = []
    for k in (4, 6, 8):
        r = run_one(frames, cfg, k, device)
        print(json.dumps({k2: v for k2, v in r.items() if k2 != "per_label"}), flush=True)
        rows.append(r)
    out = pathlib.Path(args.out).with_suffix(".json")
    out.parent.mkdir(parents=True, exist_ok=True)
    out.write_text(json.dumps(rows, indent=1))
    print(f"wrote {out}")
    return rows


if __name__ == "__main__":
    main()
