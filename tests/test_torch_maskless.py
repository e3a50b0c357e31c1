"""The ego solve without instance masks: the PyTorch port against the JAX
package's own gates (``tests/test_maskless_ego.py``), CPU.

That file's pair is kitti_sample's frames 0-1, which this repository does
not hold; the stand-in is ``make_multimover_frames(3)``'s frames 0-1 at the
synth camera (six movers, one of them large and near), ``DEFAULT_CONFIG``
otherwise, with both frames' masks zeroed, solved as ``_pair_rpe`` solves
its pair (``tools/behaviour_ref.maskless_pair`` on the port, the same steps
on the JAX package here) with ``SolverConfig.cam_init_consensus_px`` at its
default (6.0, the gate on) and at 0 (off).  Gates: camera t-RPE < 0.10
and more than 300 static inliers with the gate on (the JAX test's bounds),
and at least 5x that t-RPE with it off
(the stand-in breaks down ~10x, less than the KITTI pair's > 0.3).  Both
packages give the same verdicts, and the port draws the JAX package's
hypotheses (``JaxKeySampler`` on ``PRNGKey(0)``), so its pose agrees within
1e-4 and its inlier count within 2 (points within rounding of a gate).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from multimot_track_tpu import config as jconfig
from multimot_track_tpu.io.synth import make_multimover_frames, synth_camera_config
from multimot_track_tpu.pipeline import frames as jF
from multimot_track_tpu.pipeline import tracker as jtracker
from multimot_track_tpu_torch import config as tconfig
from multimot_track_tpu_torch.io.synth import synth_camera_config as t_synth_cam
from test_torch_ransac import JaxKeySampler
from torch_behaviour import br

torch.set_num_threads(1)

T_TOL, N_TOL = 1e-4, 2
ON_MAX, OFF_OVER_ON = 0.10, 5.0


def _cfg(C, cam, gate_on):
    D = dataclasses.replace(C.DEFAULT_CONFIG, camera=cam)
    if gate_on:
        return D
    return dataclasses.replace(D, solver=dataclasses.replace(D.solver, cam_init_consensus_px=0.0))


@pytest.fixture(scope="module")
def frames():
    return make_multimover_frames(n_frames=3)[:2]


def jax_pair(cfg, frames):
    """``test_maskless_ego._pair_rpe`` on in-memory frames, masks zeroed."""
    K = cfg.padding.k_obj_max
    sem = np.zeros_like(frames[0].sem_mask)
    gts = [jF.make_gt_table(fd.pose_gt, fd.obj_ids_gt, fd.obj_poses_gt, K) for fd in frames]
    obs0 = jtracker.first_step(
        np.clip(np.round(frames[0].gray), 0, 255).astype(np.uint8),
        np.clip(frames[0].depth_raw, 0, 65535).astype(np.uint16),
        np.clip(frames[0].flow * 128.0, -32767, 32767).astype(np.int16),
        sem.astype(np.uint8), gts[0], cfg)
    fd1 = frames[1]
    pair = jF.build_pair(
        obs0,
        jnp.asarray(np.clip(fd1.depth_raw, 0, 65535).astype(np.uint16)).astype(jnp.float32),
        jnp.asarray(sem.astype(np.int32)), gts[1], cfg,
        cur_gray=jnp.asarray(np.clip(np.round(fd1.gray), 0, 255), jnp.float32),
    )
    return jtracker.track_pair(jax.random.PRNGKey(0), pair, jtracker.initial_context(K), cfg)


@pytest.fixture(scope="module")
def runs(frames):
    out = {}
    for gate_on in (True, False):
        jcfg = _cfg(jconfig, synth_camera_config(), gate_on)
        tcfg = _cfg(tconfig, t_synth_cam(), gate_on)
        sampler = JaxKeySampler([jax.random.PRNGKey(0)], tcfg.padding.k_obj_max,
                                tcfg.solver.obj_ensemble_seeds)
        out[gate_on] = (jax_pair(jcfg, frames), br.maskless_pair(tcfg, frames, sampler))
    return out


@pytest.mark.parametrize("package", [0, 1], ids=["jax", "port"])
def test_maskless_pair_tracks(runs, package):
    r = runs[True][package]
    assert float(r.cam_t_rpe_rel) < ON_MAX, float(r.cam_t_rpe_rel)
    assert int(r.n_static_inliers) > 300


@pytest.mark.parametrize("package", [0, 1], ids=["jax", "port"])
def test_consensus_gate_is_the_fix(runs, package):
    t_on = float(runs[True][package].cam_t_rpe_rel)
    t_off = float(runs[False][package].cam_t_rpe_rel)
    assert t_off >= OFF_OVER_ON * t_on, (t_off, t_on)
    assert t_on < ON_MAX


@pytest.mark.parametrize("gate_on", [True, False], ids=["gate_on", "gate_off"])
def test_port_pose_matches_the_jax_package(runs, gate_on):
    rj, rt = runs[gate_on]
    np.testing.assert_allclose(rt.Tcw_cur.numpy(), np.asarray(rj.Tcw_cur), atol=T_TOL)
    np.testing.assert_allclose(float(rt.cam_t_rpe_rel), float(rj.cam_t_rpe_rel), atol=T_TOL)
    assert abs(int(rt.n_static_inliers) - int(rj.n_static_inliers)) <= N_TOL
