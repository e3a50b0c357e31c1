"""The live system's loop ladder on a revisit in pipelined mode with the
asynchronous keyframe cadence: the PyTorch port against the JAX pipelined
run (CPU).

The scene, settings and hypotheses are those of ``test_torch_loop_live``.
Here the loop branch runs one frame late, when the keyframe cadence is
consumed, on the dispatch-time place-recognition scores, and folds its
correction into the pipelined chain as a right factor; the JAX pipelined
run closes the same two loops (frames 11 and 13) on this shuttle.
Tolerances as in test_torch_loop_live; the rows after the last closure
agree to ~7e-4 here, the in-flight frame's correction chain carried one
frame further than in synchronous mode.
"""

import numpy as np
import pytest
import torch

from test_torch_loop_live import compare_loop_runs, poses, run_both, shuttle_frames

torch.set_num_threads(1)


@pytest.fixture(scope="module")
def pipelined_runs():
    return run_both(shuttle_frames(), pipelined=True)


def test_pipelined_loop_ladder_matches_jax(pipelined_runs):
    j, gj, t, gt = pipelined_runs
    compare_loop_runs(j, gj, t, gt)
    assert [e[:2] for e in t.map.loop_events] == [(11, 3), (13, 1)]


def test_pipelined_loop_branch_runs_on_the_cadence(pipelined_runs):
    """No synchronous ladder stage: the branch runs inside the keyframe
    cadence's consumption, and the delivered trajectory stays finite."""
    _, _, t, _ = pipelined_runs
    stages = t.stage_report()
    assert "loop_ladder" not in stages and stages["kf_consume"]["n"] >= 6
    assert t.summary()["n_loop_closures"] == 2
    assert np.isfinite(poses(t)).all() and t.ate() < 0.02
