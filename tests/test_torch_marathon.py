"""The tiny-capacity marathon: the PyTorch port against the JAX package's
own gates (``tests/test_marathon.py``), CPU.

That file shuttles kitti_sample, which this repository does not hold; the
stand-in (``tools/behaviour_ref.py``: ``marathon_frames``,
``marathon_config``) renders its 17 frames as
``test_torch_loop_live.shuttle_frames`` renders its own (0.3 m a position,
synth camera) in ``test_marathon.py``'s order over 5 positions (forward,
back, forward, back), and tracks them at ``test_marathon.TEST_CFG`` on the
synth camera with both windows off, ``keyframe_gap=2``,
``loop_consistency=1`` and the store's capacity forced to 5.  The port
draws the JAX package's hypotheses (``JaxKeySampler`` over the live step
keys).  ``test_marathon.py``'s invariants: 17 finite poses; keyframes
evicted and at most 5 held, each one's trajectory row its frame index (its
pose the inverse of that row's within 1e-3); a loop closed; every keyframe's points in
front of it; ATE < 0.5 m.  Then the JAX package's run on the same frames
(``tools/behaviour_ref.json``, written by ``tools/behaviour_ref.py record``:
it takes ~3 min, so it does not run here): its loop events (frame,
keyframe, inliers) and held indices exactly, every pose within 1e-3.
"""

import numpy as np
import pytest
import torch

from multimot_track_tpu_torch import config as tconfig
from multimot_track_tpu_torch.io import synth
from multimot_track_tpu_torch.pipeline.system import MultiMotSystem
from test_torch_ransac import FoldInKeys, JaxKeySampler
from torch_behaviour import br

torch.set_num_threads(1)

T_TOL = 1e-3
CFG = br.marathon_config(tconfig, synth.synth_camera_config())


@pytest.fixture(scope="module")
def run():
    frames = br.marathon_frames(synth)
    s = MultiMotSystem(CFG, device="cpu", sampler=JaxKeySampler(
        FoldInKeys(0), CFG.padding.k_obj_max, CFG.solver.obj_ensemble_seeds), **br.MARATHON_KW)
    s.keyframes.capacity = br.MARATHON_CAPACITY
    added = br.count_adds(s)
    for fd in frames:
        s.track_rgbd(fd)
    s.flush()
    return s, br.marathon_summary(s, added)


def test_marathon_shuttle(run):
    s, summ = run
    poses = s.map.camera_poses
    assert len(poses) == len(br.MARATHON_ORDER) == 17
    assert all(np.isfinite(T).all() for T in poses)
    assert len(summ["added"]) > len(summ["held"]), summ    # evictions happened
    assert len(s.keyframes.frames) <= br.MARATHON_CAPACITY
    rows = [kf.index for kf in s.keyframes.frames]
    assert all(0 <= r < len(poses) for r in rows), rows
    assert rows == sorted(rows)
    for kf in s.keyframes.frames:              # the trajectory holds camera-to-world
        np.testing.assert_allclose(kf.Tcw, np.linalg.inv(poses[kf.index]), atol=T_TOL)
    assert len(s.map.loop_events) >= 1, s.map.loop_events
    for kf in s.keyframes.frames:
        Xc = (kf.Tcw[:3, :3] @ kf.Xw[kf.valid].T).T + kf.Tcw[:3, 3]
        assert np.isfinite(Xc).all()
        assert (Xc[:, 2] > 0).mean() > 0.95
    ate = s.ate()
    assert ate is not None and ate < 0.5, ate


def test_marathon_matches_the_jax_package(run):
    _, summ = run
    ref = br.load()["marathon"]
    assert summ["loop_events"] == ref["loop_events"]
    assert (summ["added"], summ["held"]) == (ref["added"], ref["held"])
    dT = np.abs(np.asarray(summ["poses"]) - np.asarray(ref["poses"])).max()
    assert dT <= T_TOL, dT
