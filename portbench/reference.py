"""The plain reference and the comparison that decides ``correct``.

The drives are analytic scenes (``portbench/scenes``), so the reference
answer of every frame is exact: the camera's motion between two frames and
each mover's motion in the camera, in float64 from the scene's own
definition.  This file is NumPy alone; it imports nothing of the program
and takes nothing the program made.  It reads the program's answers only to
judge them:

* each frame pair's camera motion, refined and raw: its translation error
  as a share of the true step (t-RPE) and its rotation error;
* each object record's motion ``P_lc`` (last-camera to current-camera
  coordinates of the mover's points): how far it puts the mover's true
  centre from where the mover is (metres);
* each record's track ID: whether a mover recorded in two frames in a row
  keeps its ID (the share of such records whose ID changed), and how many
  IDs one mover gets in one drive;
* answers that are due and missing, not finite, or for no mover.
"""

from __future__ import annotations

import math

import numpy as np


def _rot_deg(R: np.ndarray) -> float:
    c = (np.trace(R) - 1.0) / 2.0
    return math.degrees(math.acos(min(1.0, max(-1.0, c))))


def camera_errors(Twc_est: np.ndarray, Twc_gt: np.ndarray):
    """Per pair k (frames k-1 -> k): (t-RPE, rotation error in degrees,
    estimated translation, true translation)."""
    t_err, r_err, t_e, t_g = [], [], [], []
    for k in range(1, len(Twc_est)):
        E = np.linalg.inv(Twc_est[k]) @ Twc_est[k - 1]
        G = np.linalg.inv(Twc_gt[k]) @ Twc_gt[k - 1]
        t_err.append(float(np.linalg.norm(E[:3, 3] - G[:3, 3])
                           / max(np.linalg.norm(G[:3, 3]), 1e-9)))
        r_err.append(_rot_deg(E[:3, :3] @ G[:3, :3].T))
        t_e.append(E[:3, 3])
        t_g.append(G[:3, 3])
    return np.asarray(t_err), np.asarray(r_err), t_e, t_g


def object_error(P_lc: np.ndarray, L_prev: np.ndarray, L_cur: np.ndarray) -> float:
    """Distance (m) between where ``P_lc`` moves the mover's true centre of
    the last frame and its true centre now, both in camera coordinates."""
    pred = P_lc[:3, :3] @ L_prev[:3, 3] + P_lc[:3, 3]
    return float(np.linalg.norm(pred - L_cur[:3, 3]))


def compare(runs, truth) -> dict:
    """Judge every answer of the window.

    ``runs``: one dict per drive, each with
    ``n`` (frames taken), ``Twc`` (n, 4, 4) refined camera-to-world poses,
    ``Twc_raw`` (n, 4, 4) poses before refinement, and ``records``: a list
    of (frame, label, track_id, P_lc).  ``truth``: (Twc (F, 4, 4), objs: per
    frame {label: camera-frame object pose}) in float64, from the scene.
    Returns the numbers, every one of which is a worst case or a quantile
    over all the window's answers."""
    Twc_gt, objs = truth
    bad = 0
    t_ref, t_raw, r_ref, obj_err, ids_per_mover = [], [], [], [], []
    continued = id_breaks = 0
    te_ref, tg_ref = [], []
    for run in runs:
        n = int(run["n"])
        gt = np.asarray(Twc_gt[:n], np.float64)
        for key, t_out, r_out in (("Twc", t_ref, r_ref), ("Twc_raw", t_raw, None)):
            est = np.asarray(run[key], np.float64)
            if est.shape != (n, 4, 4):
                bad += n
                continue
            finite = np.isfinite(est).all(axis=(1, 2))
            bad += int((~finite).sum())
            if not finite.all():
                est = np.where(finite[:, None, None], est, np.eye(4))
            t, r, te, tg = camera_errors(est, gt)
            t_out.extend(t.tolist())
            if r_out is not None:
                r_out.extend(r.tolist())
                te_ref.extend(te)
                tg_ref.extend(tg)
        ids, tid_at = {}, {}
        for frame, label, tid, P in run["records"]:
            tid_at[(frame, label)] = int(tid)
            P = np.asarray(P, np.float64)
            if not (1 <= frame < n) or label not in objs[frame] or label not in objs[frame - 1]:
                bad += 1
                continue
            if not np.isfinite(P).all():
                bad += 1
                continue
            obj_err.append(object_error(P, objs[frame - 1][label], objs[frame][label]))
            ids.setdefault(label, set()).add(int(tid))
        ids_per_mover.extend(len(v) for v in ids.values())
        for (frame, label), tid in tid_at.items():
            if (frame - 1, label) in tid_at:
                continued += 1
                id_breaks += tid != tid_at[(frame - 1, label)]

    # the refined translations' one scale against the truth's (least squares)
    scale = (float(np.sum(np.asarray(te_ref) * np.asarray(tg_ref))
                   / np.sum(np.asarray(tg_ref) ** 2)) if tg_ref else math.inf)

    def q(v, p):
        return float(np.quantile(v, p)) if len(v) else math.inf

    return {
        "answers_bad": float(bad),
        "cam_t_rpe_max": max(t_ref, default=math.inf),
        "cam_t_rpe_p90": q(t_ref, 0.9),
        "cam_t_rpe_mean": float(np.mean(t_ref)) if t_ref else math.inf,
        "cam_raw_t_rpe_max": max(t_raw, default=math.inf),
        "cam_raw_t_rpe_mean": float(np.mean(t_raw)) if t_raw else math.inf,
        "cam_r_err_max_deg": max(r_ref, default=math.inf),
        "cam_scale_err": abs(scale - 1.0),
        "obj_err_med_m": q(obj_err, 0.5),
        "obj_err_p90_m": q(obj_err, 0.9),
        "obj_records": float(len(obj_err)),
        "track_ids_per_mover_max": float(max(ids_per_mover, default=0)),
        "track_id_break_share": id_breaks / continued if continued else math.inf,
    }
