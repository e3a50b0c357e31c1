"""The live system in pipelined mode with the asynchronous keyframe cadence:
the PyTorch port against the JAX package (CPU).

Frame k's pair solve is dispatched before frame k-1 is processed, and the
keyframe-cadence work (capture, fuse scan, covisibility counts) is
dispatched at the keyframe frame and consumed one frame later.  The last
frame is processed as LOST (an impossible inlier count), so the LOST
ladder and the pipelined correction chain run too.  On this planar-ish
scene the 10-point DLT hypotheses of relocalization find too few inliers
against the previous keyframes in both packages, so the ladder ends in the
constant-velocity fallback.
Tolerances as in test_torch_live.
"""

import numpy as np
import pytest
import torch

from multimot_track_tpu.io.synth import make_multimover_frames
from test_torch_live import JCFG, T_TOL, TCFG, compare_systems, run_jax, run_port

torch.set_num_threads(1)


@pytest.fixture(scope="module")
def pipelined_runs():
    frames = make_multimover_frames(n_frames=5)
    j, rj, log = run_jax(JCFG, frames, pipelined=True, lost_last=True)
    t, rt = run_port(TCFG, frames, pipelined=True, lost_last=True)
    return j, rj, log, t, rt


def test_pipelined_async_matches_jax(pipelined_runs):
    j, rj, log, t, rt = pipelined_runs
    assert len(rt) == len(rj) == 4
    compare_systems(t, j)
    assert t.n_lm_dispatched == len(log)
    # the LOST frame's refinement is computed but discarded
    assert t.lm_accepted_frames == [f for f, a, _ in log[:-1] if a]
    for a, b in zip(rt, rj):
        np.testing.assert_allclose(a.Tcw_cur, np.asarray(b.Tcw_cur), atol=T_TOL)


def test_lost_frame_takes_the_jax_ladder(pipelined_runs):
    j, _, _, t, _ = pipelined_runs
    assert t.state == j.state == "LOST"
    assert t.stage_report()["relocalize"]["n"] == 1 and t.n_relocalized == 0
    np.testing.assert_allclose(t.map.camera_poses[-1], j.map.camera_poses[-1], atol=T_TOL)
    assert t.keyframes.n_fuse_scans > 0 and len(t.keyframes.frames) == len(j.keyframes.frames)
