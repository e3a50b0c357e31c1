"""Mask-free object discovery in the live system: the PyTorch port against
the JAX package (CPU).

Both packages run ``MultiMotSystem(discover_objects=True, keyframe_gap=1)``
on ``make_multimover_frames(6)`` at ``test_torch_live.slice_config`` (both
windows off, so the window buffer is kept for discovery alone), with the
JAX package's RANSAC / PnP and discovery draws replayed (``JaxKeySampler``
over the live step keys; discovery at ``fold_in(PRNGKey(seed), 100_000 +
frame)``).  The port also runs pipelined, where discovery drains the
in-flight frame first.  One module-scoped run of each feeds the tests.

Tolerances: the discovered (packed) masks, keyframes, object records and
track IDs identical; trajectories max |dT| <= 1e-3; the port's pipelined
run against its synchronous run 1e-5 and identical masks.
"""

import numpy as np
import pytest
import torch

from multimot_track_tpu.io.synth import make_multimover_frames
from multimot_track_tpu.pipeline.system import MultiMotSystem as JSystem
from multimot_track_tpu_torch.pipeline.system import MultiMotSystem as TSystem
from test_torch_live import JCFG, SEED, SELF_TOL, T_TOL, TCFG, compare_systems, poses
from test_torch_ransac import FoldInKeys, JaxKeySampler

torch.set_num_threads(1)

N_FRAMES = 6
DISC_KW = dict(seed=SEED, keyframe_gap=1, discover_objects=True)


def _record_masks(system):
    """Keep every discovered mask (host copies of the packed tensors)."""
    masks, inner = {}, system._discover_mask

    def recording(*a, **kw):
        out = inner(*a, **kw)
        masks[system._frame_idx] = np.asarray(out.cpu() if torch.is_tensor(out) else out)
        return out

    system._discover_mask = recording
    return masks


def _run(system, frames):
    masks = _record_masks(system)
    for fd in frames:
        system.track_rgbd(fd)
    system.flush()
    return system, masks


@pytest.fixture(scope="module")
def live_runs():
    frames = make_multimover_frames(n_frames=N_FRAMES)
    sampler = lambda: JaxKeySampler(FoldInKeys(SEED), TCFG.padding.k_obj_max,
                                    TCFG.solver.obj_ensemble_seeds)
    j = _run(JSystem(JCFG, **DISC_KW), frames)
    t = _run(TSystem(TCFG, sampler=sampler(), device="cpu", **DISC_KW), frames)
    tp = _run(TSystem(TCFG, sampler=sampler(), device="cpu", pipelined=True, **DISC_KW),
              frames)
    return j, t, tp


def test_live_discovery_matches_jax(live_runs):
    (j, mj), (t, mt), _ = live_runs
    assert t.cfg.solver.sf_cam_gate == j.cfg.solver.sf_cam_gate == 0.35
    assert sorted(mt) == sorted(mj) == list(range(2, N_FRAMES))
    for f in mj:
        np.testing.assert_array_equal(mt[f], mj[f], err_msg=f"frame {f}")
    assert max(int((m > 0).sum()) for m in mt.values()) > 0
    compare_systems(t, j, tol=T_TOL)
    assert any(r.has_gt for r in t.map.obj_records)
    assert [(r.frame, r.track_id, r.has_gt) for r in t.map.obj_records] == \
           [(r.frame, r.track_id, r.has_gt) for r in j.map.obj_records]
    assert [e[:2] for e in t.map.loop_events] == [e[:2] for e in j.map.loop_events]


def test_live_discovery_pipelined_matches_sync(live_runs):
    _, (t, mt), (tp, mtp) = live_runs
    assert sorted(mtp) == sorted(mt)
    for f in mt:
        np.testing.assert_array_equal(mtp[f], mt[f], err_msg=f"frame {f}")
    assert float(np.abs(poses(tp) - poses(t)).max()) <= SELF_TOL
    assert [(r.frame, r.track_id) for r in tp.map.obj_records] == \
           [(r.frame, r.track_id) for r in t.map.obj_records]
    assert tp.stage_report()["discover"]["n"] == N_FRAMES - 2


def test_discovery_checkpoint_and_reset(live_runs, tmp_path):
    _, (t, _), _ = live_runs
    path = tmp_path / "ckpt.pkl"
    t.save_checkpoint(path)
    plain = TSystem(TCFG, seed=SEED, keyframe_gap=1, device="cpu")
    with pytest.raises(ValueError, match="discover_objects"):
        plain.load_checkpoint(path)
    s = TSystem(TCFG, **DISC_KW, device="cpu")
    s.load_checkpoint(path)
    assert len(s._win) == len(t._win) >= 1
    s.reset()
    assert s.discover_objects and s.cfg.solver.sf_cam_gate == 0.35
