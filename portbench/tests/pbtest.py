"""Helpers of the benchmark's CPU tests: a copy of the benchmark's files
in a temporary root with the cells cut to a size the CPU runs in seconds
(640x384 camera, a few frames, the slice's small widths)."""

from __future__ import annotations

import json
import pathlib
import shutil

REPO = pathlib.Path(__file__).resolve().parents[2]
SMALL_CAM = dict(fx=460.0, fy=460.0, cx=320.0, cy=192.0, bf=138.0, width=640, height=384,
                 fps=10.0)


def small_pipeline(pipe: dict) -> dict:
    """The configuration's pipeline block at test size (the CPU tests'
    ``small_config``: 1000 features on 4 levels, padding 512 / 2048 / 1024,
    4 slots of which 2 are solved, 64 hypotheses, 2 seeds; window of 3).
    A mover needs 40 points, not 100, so that at this camera more than one
    mover is solved."""
    pipe = json.loads(json.dumps(pipe))
    pipe["camera"].update(SMALL_CAM)
    pipe["frontend"].update(n_features=1000, n_levels=4)
    pipe["padding"].update(n_static_max=512, n_obj_pts_max=2048, n_per_obj_max=1024,
                           k_obj_max=4, k_obj_solve=2)
    pipe["segmentation"].update(min_obj_points=40)
    pipe["solver"].update(ransac_iters=64, obj_ransac_iters=64, obj_ensemble_seeds=2,
                          obj_reclassify_rounds=1, cam_lm_iters=20, obj_lm_iters=30,
                          obj_ransac_score_pts=256, obj_consensus_pts=256)
    pipe["backend"].update(window_size=3, n_window_tracks=512, joint_static_max=256,
                           joint_obj_pts=32, window_ba_iters=10, joint_iters=4)
    return pipe


def small_root(tmp: pathlib.Path, n_frames: int = 4) -> pathlib.Path:
    """A root holding BENCHMARK.json and portbench/ with every configuration
    and traffic cut to test size; returns it."""
    root = tmp / "root"
    shutil.copytree(REPO / "portbench", root / "portbench",
                    ignore=shutil.ignore_patterns(".cache", "__pycache__"))
    shutil.copy(REPO / "BENCHMARK.json", root / "BENCHMARK.json")
    for p in (root / "portbench" / "configs").glob("*.json"):
        c = json.loads(p.read_text())
        c["pipeline"] = small_pipeline(c["pipeline"])
        if "system" in c:
            c["system"]["keyframe_gap"] = 1
        c["warmup_frames"] = 2
        p.write_text(json.dumps(c))
    for p in (root / "portbench" / "traffic").glob("*.json"):
        t = json.loads(p.read_text())
        t["scene_args"].update(n_frames=n_frames, cam=SMALL_CAM, n_concurrent=4)
        t["noise"]["bf"] = SMALL_CAM["bf"]
        p.write_text(json.dumps(t))
    return root
