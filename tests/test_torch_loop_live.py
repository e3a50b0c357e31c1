"""The live system's loop ladder on a revisit: the PyTorch port against the
JAX package (CPU), synchronous mode.

The scene is a shuttle rendered with ``io/synth._build_frames`` at
``SYNTH_CAM`` (640x384) with ``default_movers()``: the camera drives
forward 0.3 m per frame over 8 frames and back over the same path (the
order ``io/synth.build`` plays a sequence in), 15 frames.  Both packages
run ``MultiMotSystem`` at ``test_torch_live.slice_config`` (both windows
off, TrackLocalMap on) with loop closing on, ``keyframe_gap=2`` and
``loop_consistency=1`` (the settings of ``tests/test_live_backend.py``),
and draw the same RANSAC / PnP / Sim3 hypotheses (``JaxKeySampler`` over
the live step keys; the ladder draws at its keyframe's frame).  The
keyframes are frames 1, 3, ..., 13, and the ladder closes two loops, at
frames 11 and 13.  One module-scoped run per package feeds the tests
(``test_torch_loop_live_pipelined`` runs the pipelined mode).

Tolerances: loop events' frames and keyframe frames identical, inliers
+-2 (points within rounding of the Sim3 gate); keyframes identical;
trajectories and keyframe poses max |dT| <= 1e-3 (float32 solves in
another summation order: ~5e-5 here).  Keyframe points: within 0.05 px in
their keyframe's image and 0.5 % in depth, not 1e-3 m: the global BA
resolves far landmarks (30-43 m, seen from 0.6-4 m apart) only weakly
along the ray, and there the two packages' float32 solves land up to
0.076 m (0.19 % of the depth) apart while staying within 0.01 px in the
image.  The global BA's landmark and edge counts identical, its chi2
after rtol 1e-3; chi2 before rtol 5e-3, since a later global BA's
disparity observations are read from the earlier one's landmark depths.
"""

import numpy as np
import pytest
import torch

from multimot_track_tpu.io import synth as jsynth
from multimot_track_tpu.pipeline.system import MultiMotSystem as JSystem
from multimot_track_tpu_torch.pipeline.system import MultiMotSystem as TSystem
from test_torch_live import JCFG, SEED, T_TOL, TCFG, jax_sampler, poses

torch.set_num_threads(1)

LOOP_KW = dict(seed=SEED, keyframe_gap=2, loop_consistency=1)


def shuttle_frames(n_fwd: int = 8, step: float = 0.3):
    """Forward over ``n_fwd`` positions, then back: order [0..n-1] + [n-2..0]."""
    order = list(range(n_fwd)) + list(range(n_fwd - 2, -1, -1))

    def Twc_at(t):
        T = np.eye(4)
        T[2, 3] = step * order[t]
        return T

    return jsynth._build_frames(dict(jsynth.SYNTH_CAM), Twc_at, jsynth.default_movers(),
                                len(order), box=False)


def _record_gba(system):
    """Wrap the system's ``keyframes.global_ba`` to keep each call's stats
    (None when it rejected)."""
    calls, inner = [], system.keyframes.global_ba

    def recording(*a, **kw):
        out = inner(*a, **kw)
        calls.append(None if out is None else out[1])
        return out

    system.keyframes.global_ba = recording
    return calls


def run_both(frames, **kw):
    """(JAX system, its global-BA stats, port system, its stats) after
    feeding every frame and flushing."""
    j = JSystem(JCFG, **LOOP_KW, **kw)
    t = TSystem(TCFG, sampler=jax_sampler(), device="cpu", **LOOP_KW, **kw)
    out = []
    for s in (j, t):
        gba = _record_gba(s)
        for fd in frames:
            s.track_rgbd(fd)
        s.flush()
        out += [s, gba]
    return out


def compare_loop_runs(j, gj, t, gt):
    """The shared assertions of the sync and pipelined files."""
    ej, et = j.map.loop_events, t.map.loop_events
    assert len(et) == len(ej) >= 1, (et, ej)
    assert [e[:2] for e in et] == [e[:2] for e in ej]
    for (f, kf, n_t), (_, _, n_j) in zip(et, ej):
        assert abs(n_t - n_j) <= 2 and n_t >= 20 and f - kf >= 4
    assert [k.index for k in t.keyframes.frames] == [k.index for k in j.keyframes.frames]
    assert len(t.map.camera_poses) == len(j.map.camera_poses)
    dT = float(np.abs(poses(t) - poses(j)).max())
    assert dT <= T_TOL, dT
    for a, b in zip(t.keyframes.frames, j.keyframes.frames):
        np.testing.assert_allclose(a.Tcw, b.Tcw, atol=T_TOL)
        ya, yb = (kf.Xw @ kf.Tcw[:3, :3].T + kf.Tcw[:3, 3] for kf in (a, b))
        v = b.valid & (yb[:, 2] > 0.5)
        d_px = np.abs(ya[v, :2] / ya[v, 2:] - yb[v, :2] / yb[v, 2:]).max() * TCFG.camera.fx
        assert d_px <= 0.05, d_px
        np.testing.assert_allclose(ya[v, 2], yb[v, 2], rtol=5e-3)
    assert abs(t.ate() - j.ate()) <= T_TOL
    # the global BA after each accepted loop: accepted or rejected alike
    assert len(gt) == len(gj) == len(ej)
    assert [s is None for s in gt] == [s is None for s in gj]
    for st, sj in zip(gt, gj):
        if st is None:
            continue
        assert (st["n_landmarks"], st["n_edges"]) == (sj["n_landmarks"], sj["n_edges"])
        for k, rtol in (("chi2_init", 5e-3), ("chi2", 1e-3)):
            assert abs(st[k] - sj[k]) <= rtol * abs(sj[k]), (k, st[k], sj[k])
    assert t.gba_stats == gt


@pytest.fixture(scope="module")
def sync_runs():
    return run_both(shuttle_frames())


def test_sync_loop_ladder_matches_jax(sync_runs):
    j, gj, t, gt = sync_runs
    compare_loop_runs(j, gj, t, gt)
    assert [e[:2] for e in t.map.loop_events] == [(11, 3), (13, 1)]


def test_sync_loop_ladder_runs_per_keyframe(sync_runs):
    """The ladder runs once after every keyframe is added, and the closures
    pull the trajectory onto the ground truth."""
    _, _, t, _ = sync_runs
    n_kf = len(t.keyframes.frames)
    assert t.stage_report()["loop_ladder"]["n"] == n_kf == 7
    assert t.summary()["n_loop_closures"] == 2
    assert t.ate() < 0.02
    assert np.isfinite(poses(t)).all()
