"""Track turnover in the live system's association (``MultiMotSystem._record``)
and its counters (``utils/profiling.count``, ``MultiMotSystem.stage_counts``)
on the CPU.

* ``_record`` on hand-made pair results: a label that is gone for k frames
  and comes back gets a new track ID, whatever label its points carried in
  the frame before; a label that goes on keeps its ID; the counter
  ``record/slots_active`` reads the hand count of each pair, which is the
  pair's records.
* The live system on frames 30-41 of the avenue drive (``io/synth``, at the
  synthetic 640x384 camera): the crosser born at 34 and the oncoming car
  that dies after 38.  Its counter reads each pair's records, and every
  mover born in the slice gets an ID that no earlier record carried.
* The counters read no tensor back and launch nothing: ``_record`` runs
  with every host read raising (``test_torch_tracker.HostReadGuard``, as
  the streaming driver's check) and every dispatched operation logged.
"""

import dataclasses
import math
import types

import numpy as np
import pytest
import torch
from torch.utils._python_dispatch import TorchDispatchMode

from multimot_track_tpu_torch import config as tconfig
from multimot_track_tpu_torch.io import synth
from multimot_track_tpu_torch.pipeline import tracker
from multimot_track_tpu_torch.pipeline.system import MultiMotSystem
from multimot_track_tpu_torch.utils import profiling
from portbench import turnover_ref
from portbench.scenes import avenue
from test_torch_tracker import HostReadGuard
from test_torch_tracker import small_config as tracker_config

torch.set_num_threads(2)

K, K_SOLVE = 4, 3           # label slots, of which the pair step solves 3
TIMES = list(range(30, 42))  # the avenue's frames with a birth and a death


def small_config():
    """The tracker tests' slice, 3 of its 4 label slots solved, the
    trailing-window and joint window BA off."""
    c = tracker_config(tconfig, synth.synth_camera_config())
    return dataclasses.replace(
        c, padding=dataclasses.replace(c.padding, k_obj_max=K, k_obj_solve=K_SOLVE),
        backend=dataclasses.replace(c.backend, window_refine=False, joint_window_refine=False))


def pair_result(active, mode_last):
    """A host PairResult whose slot l (label l + 1) is ``active[l]`` with
    ``mode_last[l]`` the label its points carried in the frame before."""
    z = np.zeros(K, np.float32)
    ob = tracker.ObjectOutputs(
        seen=np.asarray(active, bool), is_static=np.zeros(K, bool),
        active=np.asarray(active, bool), n_points=np.full(K, 100, np.int32),
        mode_last_label=np.asarray(mode_last, np.int32), H=np.tile(np.eye(4), (K, 1, 1)),
        n_inliers=np.full(K, 90, np.int32), centre3d=np.zeros((K, 3)),
        centre_pre=np.zeros((K, 3)), bbox=np.zeros((K, 4)), speed_est=z, speed_gt=z,
        t_rpe=z, r_rpe=z, t_rpe_rel=z, r_rpe_rel=z, speed_err_rel=z, t_rpe_centred=z,
        has_gt=np.zeros(K, bool))
    return tracker.PairResult(
        Tcw_cur=np.eye(4, dtype=np.float32), cam_t_rpe=0.0, cam_r_rpe=0.0,
        cam_t_rpe_rel=0.0, cam_r_rpe_rel=0.0, n_static=500, n_static_inliers=400,
        flow_hist=np.zeros(20), seg_confusion=None, objects=ob, obj_label_map=None)


FD = types.SimpleNamespace(pose_gt=np.eye(4, dtype=np.float32), timestamp=0.0,
                           obj_ids_gt=None, obj_poses_gt=None)


def test_count_records_under_the_innermost_span():
    counts, acc = {}, {}
    profiling.count("stray")
    with profiling._StageCtx(acc, "record", counts=counts):
        profiling.count("births", 2)
        profiling.count("births", 0)
        with profiling.span("inner"):
            profiling.count("x")
        with profiling._StageCtx(acc, "no_counter"):
            profiling.count("lost")
    assert counts == {"record/births": [2, 0], "record/inner/x": [1]}
    s = MultiMotSystem(small_config(), enable_keyframes=False, device="cpu")
    with s._stage("record"):
        profiling.count("y", 3)
    assert s.stage_counts == {"record/y": [3]}
    s.reset()
    assert s.stage_counts == {}


@pytest.mark.parametrize("back_from", [2, 0], ids=["own-label", "background"])
@pytest.mark.parametrize("gap", [1, 2, 5])
def test_a_label_back_after_a_gap_gets_a_new_id(gap, back_from):
    """Label 1 in every frame; label 2 in frames 1-2, gone for ``gap``
    frames, back for two frames (its points from label ``back_from`` in the
    frame before); label 3 from frame 2 on."""
    n = 4 + gap + 1                       # frames 1 .. n - 1 are pairs
    s = MultiMotSystem(small_config(), enable_keyframes=False, device="cpu")
    back = 3 + gap
    for f in range(1, n):
        two = f <= 2 or f >= back
        active = [True, two, f >= 2, False]
        mode = [1, back_from if f == back else 2, 0 if f == 2 else 3, 0]
        with s._stage("record"):
            s._record(pair_result(active, mode), FD, frame_idx=f)
    ids = {}
    for r in s.map.obj_records:
        ids.setdefault(r.sem_label, []).append((r.frame, r.track_id))
    assert {t for _, t in ids[1]} == {1}                       # carried on
    assert {t for _, t in ids[3]} == {3}
    first, second = [t for f, t in ids[2] if f <= 2], [t for f, t in ids[2] if f >= back]
    assert set(first) == {2} and set(second) == {4}             # new after the gap
    active = s.stage_counts["record/slots_active"]
    assert list(s.stage_counts) == ["record/slots_active"]
    assert active == [2, 3] + [2] * (gap) + [3] * (n - 1 - 2 - gap)
    assert active == records_per_pair(s.map.obj_records, n)


def records_per_pair(records, n):
    """The object records of each pair 1 .. n - 1."""
    return [sum(r.frame == f for r in records) for f in range(1, n)]


class OpLog(TorchDispatchMode):
    """Logs every operation dispatched while it is entered."""

    def __init__(self):
        super().__init__()
        self.ops = []

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        self.ops.append(str(func))
        return func(*args, **(kwargs or {}))


@pytest.fixture(scope="module")
def avenue_run():
    """The live system over the avenue's frames 30-41, every ``_record``
    call with host reads raising and dispatched operations logged."""
    mp = pytest.MonkeyPatch()
    guard, log = HostReadGuard(mp), OpLog()
    record = MultiMotSystem._record

    def guarded(self, *a, **kw):
        guard.on = True
        try:
            with log:
                return record(self, *a, **kw)
        finally:
            guard.on = False
    mp.setattr(MultiMotSystem, "_record", guarded)
    try:
        frames = synth.make_avenue_frames(240, cam=dict(synth.SYNTH_CAM), times=TIMES)
        s = MultiMotSystem(small_config(), seed=3, enable_keyframes=False, device="cpu")
        for fd in frames:
            s.track_rgbd(fd)
        s.flush()
    finally:
        mp.undo()
    truth = avenue.build(cam=dict(synth.SYNTH_CAM), times=TIMES).truth()
    return s, guard, log, truth


def test_live_counters_read_what_the_records_give(avenue_run):
    s, _, _, (_, objs) = avenue_run
    n = len(TIMES)
    records = [(r.frame, r.sem_label, r.track_id, r.P_lc) for r in s.map.obj_records]
    active = s.stage_counts["record/slots_active"]
    assert active == records_per_pair(s.map.obj_records, n) and sum(active) > 0
    # the crosser (label 4) is born in the slice and recorded, on an ID
    # that no record before its birth carried
    births = [(lab, f0) for lab, f0, _ in turnover_ref.lifespans(objs) if f0 >= 1]
    assert (4, 34 - TIMES[0]) in births and (3, 37 - TIMES[0]) in births
    for label, f0 in births:
        earlier = {tid for f, _, tid, _ in records if f < f0}
        assert not earlier & {tid for f, lab, tid, _ in records if lab == label and f >= f0}
    assert any(lab == 4 for _, lab, _, _ in records)
    # no label of the slice is reborn, so the judge has nothing to judge
    judged = turnover_ref.judge([dict(n=n, records=records)], objs)
    assert judged["births_seen"] >= 1 and judged["reborn_records"] == 0
    assert math.isnan(judged["track_id_reborn_share"])


def test_the_counters_read_no_tensor_back_and_launch_nothing(avenue_run):
    s, guard, log, _ = avenue_run
    assert s.map.obj_records and guard.seen == [] and log.ops == []
    # the guard's own check: a read while it is on raises
    mp = pytest.MonkeyPatch()
    try:
        g = HostReadGuard(mp)
        g.on = True
        with pytest.raises(RuntimeError, match="host read"):
            torch.ones(2).sum().item()
    finally:
        mp.undo()
