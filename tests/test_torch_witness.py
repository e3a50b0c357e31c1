"""Witness subsampling is a throughput knob, not an accuracy knob: the JAX
package's own gates (``tests/test_witness_subsample.py``) on the PyTorch
port and on the JAX package, CPU.

That file's A/B runs kitti_sample, which this repository does not hold; the
stand-in is ``make_multimover_frames(3)`` at the synth camera, at that
file's ``_BASE`` configuration, run as it runs its sample
(``run_sequence(seq, cfg, n_frames=2)``).  ``SolverConfig.obj_ransac_score_pts`` /
``obj_consensus_pts`` at their defaults (512-point strided subsample)
against 0 (every member): the ego poses must be identical within 1e-5 (the
knobs touch only the object branch) and the object median t-RPE may move by
less than 0.06 (the inter-seed spread of the object solve).  Each package
runs the A/B once, on its own draws.
"""

import dataclasses

import numpy as np
import pytest
import torch

from multimot_track_tpu import config as jconfig
from multimot_track_tpu.io.synth import make_multimover_frames, synth_camera_config
from multimot_track_tpu.pipeline.system import run_sequence as j_run_sequence
from multimot_track_tpu_torch import config as tconfig
from multimot_track_tpu_torch.io.synth import synth_camera_config as t_synth_cam
from multimot_track_tpu_torch.pipeline.system import run_sequence as t_run_sequence

torch.set_num_threads(1)

EGO_TOL, OBJ_SHIFT_MAX = 1e-5, 0.06
N_FRAMES = 2                    # of the 3 rendered, as the JAX test runs its sample


def ab_configs(C, cam):
    """``test_witness_subsample.SUB`` and ``FULL`` at ``cam``."""
    D = C.DEFAULT_CONFIG
    base = dataclasses.replace(
        D, camera=cam,
        padding=dataclasses.replace(D.padding, n_static_max=1024, n_obj_pts_max=4096,
                                    k_obj_max=4),
        solver=dataclasses.replace(D.solver, ransac_iters=200, cam_lm_iters=60,
                                   obj_lm_iters=100),
    )
    full = dataclasses.replace(base, solver=dataclasses.replace(
        base.solver, obj_ransac_score_pts=0, obj_consensus_pts=0))
    return base, full


class Frames:
    def __init__(self, frames):
        self.frames = frames

    def __len__(self):
        return len(self.frames)

    def load_frame(self, i):
        return self.frames[i]


@pytest.fixture(scope="module")
def runs():
    seq = Frames(make_multimover_frames(n_frames=3))
    jsub, jfull = ab_configs(jconfig, synth_camera_config())
    tsub, tfull = ab_configs(tconfig, t_synth_cam())
    assert (tsub.solver.obj_ransac_score_pts, tsub.solver.obj_consensus_pts) == (512, 512)
    return {"jax": [j_run_sequence(seq, c, n_frames=N_FRAMES) for c in (jsub, jfull)],
            "port": [t_run_sequence(seq, c, n_frames=N_FRAMES, device="cpu")
                     for c in (tsub, tfull)]}


@pytest.mark.parametrize("package", ["jax", "port"])
def test_ego_path_untouched(runs, package):
    sub, full = runs[package]
    np.testing.assert_allclose(np.asarray(sub.map.camera_poses),
                               np.asarray(full.map.camera_poses), atol=EGO_TOL)


@pytest.mark.parametrize("package", ["jax", "port"])
def test_object_estimate_within_seed_spread(runs, package):
    sub, full = runs[package]
    recs_s = [r for r in sub.map.obj_records if r.has_gt]
    recs_f = [r for r in full.map.obj_records if r.has_gt]
    assert recs_s and recs_f
    t_s = float(np.median([r.t_rpe_rel for r in recs_s]))
    t_f = float(np.median([r.t_rpe_rel for r in recs_f]))
    assert abs(t_s - t_f) < OBJ_SHIFT_MAX, (t_s, t_f)
