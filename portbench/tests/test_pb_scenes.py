"""The frozen scene copy renders what the program's ``io/synth.py`` renders
(as of this benchmark), and its truth is the frames' truth."""

from __future__ import annotations

import dataclasses
import json

import numpy as np
import pytest

from portbench import harness
from portbench.scenes import junction, render
from pbtest import REPO, SMALL_CAM


def _same(a, b):
    for f in dataclasses.fields(b):
        x, y = np.asarray(getattr(a, f.name)), np.asarray(getattr(b, f.name))
        assert x.dtype == y.dtype and np.array_equal(x, y), f.name


@pytest.mark.parametrize("cam,times", [(SMALL_CAM, [0, 1, 29, 30, 59]),
                                       (None, [0, 31])])
def test_junction_frames_equal_the_programs(cam, times):
    from multimot_track_tpu_torch.io import synth

    mine = junction.build(60, cam=cam, times=times)
    theirs = synth.make_junction_frames(60, cam=cam, times=times)
    for k, fd in enumerate(theirs):
        _same(mine.frame(k), fd)


def test_degrade_frames_equals_the_programs():
    from multimot_track_tpu_torch.io import synth

    times = [0, 1, 2]
    frames = [junction.build(60, cam=SMALL_CAM, times=times).frame(k) for k in range(3)]
    theirs = synth.make_junction_frames(60, cam=SMALL_CAM, times=times)
    seed = 2 ** 40 + 3
    for a, b in zip(render.degrade_frames(frames, seed=seed, bf=SMALL_CAM["bf"]),
                    synth.degrade_frames(theirs, seed=seed, bf=SMALL_CAM["bf"])):
        _same(a, b)


def test_truth_is_the_frames_truth():
    scene = junction.build(60, cam=SMALL_CAM, times=[0, 5, 40])
    Twc, objs = scene.truth()
    for k in range(3):
        fr = scene.frame(k)
        assert np.allclose(Twc[k], fr.pose_gt, atol=1e-5)
        for label, L in zip(fr.obj_ids_gt, fr.obj_poses_gt):
            assert np.allclose(objs[k][int(label)], L, atol=1e-5)


def test_an_ego_path_at_the_programs_speed_is_the_programs_drive():
    from multimot_track_tpu_torch.io import synth

    times = [0, 7, 59]
    mine = junction.build(60, cam=SMALL_CAM, times=times, speed_knots=[[0, 0.45]],
                          yaw_knots=[[0, 0.0], [59, 0.0]])
    theirs = synth.make_junction_frames(60, cam=SMALL_CAM, times=times)
    for k, fd in enumerate(theirs):
        fr = mine.frame(k)
        assert np.allclose(fr.pose_gt, fd.pose_gt, atol=1e-5)
        assert np.allclose(fr.flow, fd.flow, atol=1e-3)


@pytest.mark.parametrize("name", [p.stem for p in (REPO / "portbench" / "traffic").glob("*.json")])
def test_every_drive_keeps_to_urban_accelerations(name):
    """No traffic file shakes the ego: at 10 Hz its speed changes by at most
    3 m/s2 and its heading by at most 1 degree a frame."""
    traffic = json.loads((REPO / "portbench" / "traffic" / f"{name}.json").read_text())
    scene = harness.load_module(REPO / "portbench" / "scenes" / f"{traffic['scene']}.py",
                                "scene").build(**traffic["scene_args"])
    Twc, _ = scene.truth()
    fps = scene.cam["fps"]
    steps = np.linalg.norm(np.diff(Twc[:, :3, 3], axis=0), axis=1) * fps
    assert np.abs(np.diff(steps)).max() * fps <= 3.0
    turn = [_rot_deg(np.linalg.inv(Twc[k]) @ Twc[k - 1]) for k in range(1, len(Twc))]
    assert max(turn) <= 1.0 and min(steps) > 0


def _rot_deg(T):
    return float(np.degrees(np.arccos(np.clip((np.trace(T[:3, :3]) - 1) / 2, -1, 1))))
