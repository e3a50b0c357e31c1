"""The live system with the trailing-window BA and the joint ego+object
window BA on: the PyTorch port against the JAX package (CPU).

Both packages run ``MultiMotSystem`` on ``make_multimover_frames(5)`` at
``test_torch_live.slice_config`` with ``window_refine`` and
``joint_window_refine`` on and ``window_size=3`` (keyframes every frame,
loop closing off), drawing the same hypotheses (``JaxKeySampler``).  The
window fills at frame 2, so frames 2-4 refine their trailing window and,
being keyframes, run the joint BA where the window holds an object.

Tolerances: trajectories max |dT| <= 1e-3, object motions and ``P_lc`` to
1e-3, ``refined_obj_metrics`` to 1e-4; keyframes, local-map accepts,
window commits, joint refines, records and track IDs identical.  The
JAX package reads its window outcome (``n_live``, the refined rows) from
the fused transfer vector, which the test records per frame.
"""

import numpy as np
import pytest
import torch

from multimot_track_tpu import config as jconfig
from multimot_track_tpu.io.synth import make_multimover_frames, synth_camera_config
from multimot_track_tpu_torch import config as tconfig
from multimot_track_tpu_torch.io.synth import synth_camera_config as t_synth_cam
from multimot_track_tpu_torch.pipeline.system import MultiMotSystem as TSystem
from test_torch_live import (SEED, SELF_TOL, T_TOL, compare_systems, jax_sampler, poses,
                             run_jax, run_port, slice_config)

torch.set_num_threads(1)

WIN = dict(window_refine=True, joint_window_refine=True, window_size=3)
JCFG = slice_config(jconfig, synth_camera_config(), **WIN)
TCFG = slice_config(tconfig, t_synth_cam(), **WIN)
METRIC_TOL = 1e-4


def compare_window_runs(t, j, log):
    """``compare_systems`` plus the window path's decisions and metrics."""
    compare_systems(t, j)
    assert t.lm_accepted_frames == [f for f, a, _ in log if a]
    assert t.win_accepted_frames == [f for f, _, c in log if c]
    assert t.n_joint_refines == j.n_joint_refines
    mt, mj = t.refined_obj_metrics(), j.refined_obj_metrics()
    np.testing.assert_allclose(np.asarray(mt, float), np.asarray(mj, float), atol=METRIC_TOL)


@pytest.fixture(scope="module")
def frames():
    return make_multimover_frames(n_frames=5)


@pytest.fixture(scope="module")
def sync_runs(frames):
    j, rj, log = run_jax(JCFG, frames)
    t, rt = run_port(TCFG, frames)
    return j, rj, log, t, rt


def test_window_system_sync_matches_jax(sync_runs):
    j, rj, log, t, rt = sync_runs
    assert len(rt) == len(rj) == 4
    compare_window_runs(t, j, log)
    # every frame of a full window dispatches one refinement
    assert t.n_win_dispatched == sum(1 for f, _, _ in log if f >= 2) == 3
    assert len(t.win_accepted_frames) > 0 and t.n_joint_refines > 0
    st, sj = t.summary(), j.summary()
    for k in ("cam_t_rpe_rel_mean", "ego_ate_rmse_m", "cam_t_rpe_refined_mean",
              "obj_t_rpe_refined_mean"):
        assert abs(st[k] - sj[k]) <= T_TOL, k
    for a, b in zip(rt, rj):
        np.testing.assert_allclose(a.Tcw_cur, np.asarray(b.Tcw_cur), atol=T_TOL)
    assert {"local_map", "window_refine", "joint_ba"} <= set(t.stage_report())


def test_window_system_pipelined_matches_jax(frames):
    """Pipelined with the async keyframe cadence: window rows are rewritten
    one frame late and the joint BA commits object measurements only."""
    j, rj, log = run_jax(JCFG, frames, pipelined=True)
    t, rt = run_port(TCFG, frames, pipelined=True)
    assert len(rt) == len(rj) == 4
    compare_window_runs(t, j, log)
    assert len(t.win_accepted_frames) > 0 and t.n_joint_refines > 0
    for a, b in zip(rt, rj):
        np.testing.assert_allclose(a.Tcw_cur, np.asarray(b.Tcw_cur), atol=T_TOL)


def test_unfused_window_matches_jax(frames, sync_runs):
    """``fused_refine=False``: the host-dispatched ``_refine_window`` after
    the record makes the same commits as the fused refinement."""
    j, _, log, t, _ = sync_runs
    cfg = slice_config(tconfig, t_synth_cam(), fused_refine=False, **WIN)
    u, _ = run_port(cfg, frames)
    compare_window_runs(u, j, log)
    assert u.win_accepted_frames == t.win_accepted_frames
    assert u.n_win_dispatched == t.n_win_dispatched
    assert "window_refine" in u.stage_report()


def test_window_checkpoint_resume(frames, sync_runs, tmp_path):
    """A checkpoint taken with the window full resumes the window buffer:
    the remaining frames track exactly as the unbroken run."""
    _, _, _, t, _ = sync_runs
    s = TSystem(TCFG, seed=SEED, keyframe_gap=1, enable_loop_closing=False,
                sampler=jax_sampler(), device="cpu")
    for fd in frames[:3]:
        s.track_rgbd(fd)
    assert len(s._win) == 3
    s.save_checkpoint(tmp_path / "ck.pkl")
    r = TSystem(TCFG, seed=SEED, keyframe_gap=1, enable_loop_closing=False,
                sampler=jax_sampler(), device="cpu")
    r.load_checkpoint(tmp_path / "ck.pkl")
    assert [w["row"] for w in r._win] == [0, 1, 2]
    for fd in frames[3:]:
        r.track_rgbd(fd)
    np.testing.assert_allclose(poses(r), poses(t), atol=SELF_TOL)
    assert r.win_accepted_frames == [f for f in t.win_accepted_frames if f >= 3]
    for a, b in zip(r.map.obj_records, t.map.obj_records):
        np.testing.assert_allclose(a.P_lc, b.P_lc, atol=SELF_TOL)
