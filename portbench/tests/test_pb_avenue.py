"""The turnover cell ``live-avenue`` on the CPU at test size: its drive is the
program's avenue frame for frame, its truth holds the births and label
reuses the cell is for, the turnover judge fails a run that meets no
reborn label, a sound run is correct, ``live-ids-stale`` fails the turnover
judge's number alone, and the entry runs and is judged with a program that
counts nothing.  (The drive's accelerations are held by
``test_pb_scenes.test_every_drive_keeps_to_urban_accelerations``, which
reads every traffic file.)

The correctness runs take the avenue's frames 17, 21, ..., 101 (every
fourth frame, at the test camera): the oncoming car on label 2 is solved
near frame 21, dies at 39, and the next car on label 2 is solved from
about frame 93, so the run meets a reborn label in 22 frames.  Each runs
the entry's window without ``max_frames``, which takes drive 0 to its
end."""

from __future__ import annotations

import importlib.util
import json
import math

import numpy as np
import pytest
import torch

from portbench import devtrace, harness, inputs, turnover_faults, turnover_ref
from portbench.scenes import avenue
from pbtest import REPO, SMALL_CAM, small_root
from test_pb_scenes import _same

SEED = 2 ** 33 + 11
TIMES = list(range(17, 105, 4))
TRAFFIC = "avenue120-turnover-noisy"


@pytest.mark.parametrize("cam,times", [(SMALL_CAM, [0, 1, 36, 37, 73, 74, 119]),
                                       (None, [34, 110])])
def test_avenue_frames_equal_the_programs(cam, times):
    from multimot_track_tpu_torch.io import synth

    mine = avenue.build(120, cam=cam, times=times)
    theirs = synth.make_avenue_frames(240, cam=cam, times=times)
    for k, fd in enumerate(theirs):
        _same(mine.frame(k), fd)


def test_the_drive_holds_its_births_and_reborn_labels():
    traffic = json.loads((REPO / "portbench" / "traffic" / f"{TRAFFIC}.json").read_text())
    scene = avenue.build(**traffic["scene_args"])
    assert len(scene.times) == 120
    spans = turnover_ref.lifespans(scene.truth()[1])
    assert [(lab, f0) for lab, f0, _ in spans if f0 >= 1] == \
        [(2, 1), (4, 34), (3, 37), (2, 74), (5, 98), (3, 110)]
    assert [(lab, f1) for lab, _, f1 in spans if f1 < 120] == \
        [(2, 39), (4, 72), (3, 75), (2, 112)]


@pytest.fixture(scope="module")
def root(tmp_path_factory):
    root = small_root(tmp_path_factory.mktemp("avenue"), n_frames=len(TIMES))
    path = root / "portbench" / "traffic" / f"{TRAFFIC}.json"
    traffic = json.loads(path.read_text())
    traffic["scene_args"]["times"] = TIMES
    path.write_text(json.dumps(traffic))
    torch.set_num_threads(4)
    return root


def _run(root):
    spec = importlib.util.spec_from_file_location("pb_run", REPO / "portbench" / "run.py")
    run = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(run)
    result, _ = run.run_cell(harness.Cell("live-avenue", root=root), SEED, 0.0, False,
                             device="cpu")
    return result


@pytest.mark.parametrize("ids,share", [((7, 8), 0.0), ((7, 7), 1.0), ((7, None), None)],
                         ids=["new-id", "id-handed-on", "none-reborn"])
def test_the_judge_fails_a_run_that_met_no_reborn_label(ids, share):
    """Label 2 in frames 0-1, gone in 2, back in 3: its record at 1 has ID
    ``ids[0]``, its record at 3 ``ids[1]`` (none: left out)."""
    pose = np.eye(4)
    objs = [{2: pose}, {2: pose}, {}, {2: pose}]
    records = [(1, 2, ids[0], pose)] + ([(3, 2, ids[1], pose)] if ids[1] else [])
    judged = turnover_ref.judge([dict(n=4, records=records)], objs)
    assert judged["reborn_records"] == (1.0 if ids[1] else 0.0)
    if share is None:
        assert math.isnan(judged["track_id_reborn_share"])
        assert not harness.verdict(judged, {"numbers": {"track_id_reborn_share":
                                                       {"limit": 0}}})[0]
    else:
        assert judged["track_id_reborn_share"] == share


def test_the_sound_run_is_correct_and_meets_a_reborn_label(root):
    result = _run(root)
    assert result["correct"], result["checks"]
    numbers = result["notes"]["numbers"]
    assert numbers["track_id_reborn_share"] == 0.0 and numbers["reborn_records"] >= 1
    assert numbers["births_seen"] >= 2


def test_stale_ids_fail_the_turnover_number_alone(root):
    patches = devtrace.Patches()
    turnover_faults.plant("live-ids-stale", patches)
    try:
        result = _run(root)
    finally:
        patches.restore()
    failed = [k for k, c in result["checks"].items() if not c["value"] <= c["limit"]]
    assert failed == ["track_id_reborn_share"], result["checks"]
    assert result["notes"]["numbers"]["track_id_reborn_share"] == 1.0


def _window(cell, counting: bool):
    """One whole drive through the entry; ``counting`` False runs a
    program whose systems keep no ``stage_counts``."""
    from multimot_track_tpu_torch.pipeline.system import MultiMotSystem

    class Uncounted(MultiMotSystem):
        stage_counts = property(lambda self: None, lambda self, value: None)

    clean, _ = inputs.clean_frames(cell)
    runner = cell.entry().make(cell, inputs.noisy_frames(cell, clean, SEED), SEED, False, "cpu")
    if not counting:
        runner.System = Uncounted
    runner.warm_up()
    return runner.window(0.0)


@pytest.mark.parametrize("counting", [True, False], ids=["counted", "uncounted"])
def test_the_entry_runs_and_is_judged_with_or_without_counters(root, counting):
    from portbench import reference

    cell = harness.Cell("live-avenue", root=root)
    rec = _window(cell, counting)
    assert rec["n_drives"] == 1 and rec["answers"][0]["n"] == len(TIMES)
    numbers = reference.compare(rec["answers"], cell.scene().truth())
    assert harness.verdict(numbers, cell.limits)[0], numbers
    assert numbers["reborn_records"] >= 1
    read = {m["name"]: cell.reader(m).read(rec) for m in cell.per_layer}
    assert read["objects_ms"] > 0
    if counting:
        active = rec["counts"]["record/slots_active"]
        # the window's pairs, the warm-up's left out; 2 of 4 slots solved
        assert rec["counted_pairs"] == len(rec["frames"]) and rec["slots_per_pair"] == 2
        assert 0 < active <= 2 * len(rec["frames"])
        assert read["obj_slot_idle_share.avenue"] == pytest.approx(
            100.0 * (1 - active / (2 * len(rec["frames"]))))
    else:
        assert "counts" not in rec and read["obj_slot_idle_share.avenue"] is None
