"""The pair tracker and the batched/streaming slice: the PyTorch port against
the JAX package on the same synthetic scene (CPU), plus the port's
independence from JAX.

Both packages draw the same RANSAC hypotheses (test_torch_ransac.
JaxKeySampler).  Tolerances: poses and object motions max |dT| <= 1e-3
(float32 LM solves in another summation order agree to ~1e-6 here; the
bound leaves room for a hypothesis tie broken differently); object flags,
point counts, label association and track IDs identical; inlier counts
+-2 (points within rounding of a chi2 gate).
"""

import dataclasses
import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from multimot_track_tpu import config as jconfig
from multimot_track_tpu.io.synth import make_multimover_frames, synth_camera_config
from multimot_track_tpu.ops import wire as jwire
from multimot_track_tpu.pipeline import batch as jbatch
from multimot_track_tpu.pipeline import frames as jframes
from multimot_track_tpu.pipeline import tracker as jtracker
from multimot_track_tpu_torch import config as tconfig
from multimot_track_tpu_torch import state
from multimot_track_tpu_torch.io.synth import synth_camera_config as t_synth_cam
from multimot_track_tpu_torch.pipeline import batch as tbatch
from multimot_track_tpu_torch.pipeline import frames as tframes
from multimot_track_tpu_torch.pipeline import tracker as ttracker
from test_torch_ransac import JaxKeySampler

torch.set_num_threads(1)

T_TOL = 1e-3
EXACT = ("seen", "is_static", "active", "n_points", "mode_last_label")


def small_config(C, cam):
    """The slice at test size: 1000 features on 4 levels, padding
    512 / 2048 / 1024, 4 label slots of which 2 are solved, 64 hypotheses,
    2 seeds, 1 reclassify round, LM caps 20 / 30, 256 witness points."""
    D = C.DEFAULT_CONFIG
    return dataclasses.replace(
        D, camera=cam,
        frontend=dataclasses.replace(D.frontend, n_features=1000, n_levels=4),
        padding=dataclasses.replace(D.padding, n_static_max=512, n_obj_pts_max=2048,
                                    n_per_obj_max=1024, k_obj_max=4, k_obj_solve=2),
        solver=dataclasses.replace(
            D.solver, ransac_iters=64, obj_ransac_iters=64, obj_ensemble_seeds=2,
            obj_reclassify_rounds=1, cam_lm_iters=20, obj_lm_iters=30,
            obj_ransac_score_pts=256, obj_consensus_pts=256),
    )


JCFG = small_config(jconfig, synth_camera_config())
TCFG = small_config(tconfig, t_synth_cam())
K, S = JCFG.padding.k_obj_max, JCFG.solver.obj_ensemble_seeds


@pytest.fixture(scope="module")
def frames():
    return make_multimover_frames(n_frames=3)


def _wire(fd):
    return (np.clip(np.round(fd.gray), 0, 255).astype(np.uint8),
            np.clip(fd.depth_raw, 0, 65535).astype(np.uint16),
            jwire.pack_flow12(fd.flow), jwire.pack_sem4(fd.sem_mask))


def _compare_results(rt, rj, n_tol=2):
    """Port PairResult (numpy) against the JAX one, field by field."""
    np.testing.assert_allclose(rt.Tcw_cur, np.asarray(rj.Tcw_cur), atol=T_TOL)
    for f in ("cam_t_rpe", "cam_r_rpe", "cam_t_rpe_rel", "cam_r_rpe_rel"):
        np.testing.assert_allclose(getattr(rt, f), np.asarray(getattr(rj, f)), atol=T_TOL,
                                   err_msg=f)
    np.testing.assert_array_equal(rt.n_static, np.asarray(rj.n_static))
    assert np.abs(rt.n_static_inliers - np.asarray(rj.n_static_inliers)).max() <= n_tol
    np.testing.assert_array_equal(rt.flow_hist, np.asarray(rj.flow_hist))
    oj, ot = rj.objects, rt.objects
    for f in EXACT:
        np.testing.assert_array_equal(getattr(ot, f), np.asarray(getattr(oj, f)), err_msg=f)
    act = np.asarray(oj.active)
    assert act.any()
    np.testing.assert_allclose(ot.H[act], np.asarray(oj.H)[act], atol=T_TOL)
    assert np.abs(ot.n_inliers - np.asarray(oj.n_inliers)).max() <= n_tol
    for f in ("centre3d", "bbox"):
        np.testing.assert_allclose(getattr(ot, f), np.asarray(getattr(oj, f)), rtol=1e-5,
                                   atol=1e-3, err_msg=f)
    np.testing.assert_allclose(ot.centre_pre[act], np.asarray(oj.centre_pre)[act], atol=1e-2)
    gt = act & np.asarray(oj.has_gt)
    np.testing.assert_array_equal(ot.has_gt, np.asarray(oj.has_gt))
    for f in ("t_rpe", "r_rpe", "speed_est", "speed_gt"):
        np.testing.assert_allclose(getattr(ot, f)[gt], np.asarray(getattr(oj, f))[gt],
                                   atol=5e-2, err_msg=f)
    for f in ("tot", "fp", "fn", "nd"):
        assert abs(int(np.sum(getattr(rt.seg_confusion, f)))
                   - int(np.sum(np.asarray(getattr(rj.seg_confusion, f))))) <= n_tol, f


def test_track_pair_matches_jax_field_by_field(frames):
    """The second pair of a sequence, so the velocity and per-label motion
    models of the context are live."""
    key0, key1 = jax.random.split(jax.random.PRNGKey(11))
    gts = [jframes.make_gt_table(fd.pose_gt, fd.obj_ids_gt, fd.obj_poses_gt, K) for fd in frames]
    w = [tuple(map(jnp.asarray, _wire(fd))) for fd in frames]
    obs0 = jtracker.first_step(*w[0], gts[0], JCFG)
    ctx0 = jtracker.initial_context(K)
    packed, ctx1, obs1 = jtracker.full_step(key0, obs0, *w[1], gts[1], ctx0, JCFG)
    depth = jwire._decode_depth(w[2][1], JCFG.camera.width)
    sem = jwire._decode_sem(w[2][3], JCFG.camera.width)
    pair = jframes.build_pair(obs1, depth, sem, gts[2], JCFG,
                              cur_gray=w[2][0].astype(jnp.float32))
    ref = jtracker.track_pair(key1, pair, ctx1, JCFG)
    assert bool(ctx1.velocity_valid) and bool(np.asarray(ctx1.H_prev_valid).any())

    out = ttracker.track_pair(
        state.from_reference(pair, tframes.PairInputs),
        state.from_reference(ctx1, ttracker.TrackContext),
        TCFG, JaxKeySampler([key1], K, S), pair_id=0,
    )
    out_np = state.result_to_numpy(out)
    _compare_results(out_np, ref)
    np.testing.assert_array_equal(out_np.obj_label_map, np.asarray(ref.obj_label_map))

    nxt_j = jtracker.next_context(ref, ctx1, K)
    nxt_t = ttracker.next_context(
        state.from_reference(ref, ttracker.PairResult, batch=True),
        state.from_reference(ctx1, ttracker.TrackContext, batch=True), K)
    for a, b in zip(nxt_t, nxt_j):
        np.testing.assert_allclose(a[0].numpy(), np.asarray(b), atol=1e-6)


def _check_sequence(out_t, out_j):
    (Tt, rt, rect), (Tj, rj, recj) = out_t, out_j
    dT = float(np.abs(Tt - Tj).max())
    assert dT <= T_TOL, dT
    _compare_results(rt, rj)
    assert [(r["frame"], r["track_id"], r["sem_label"]) for r in rect] == \
           [(r["frame"], r["track_id"], r["sem_label"]) for r in recj]
    for a, b in zip(rect, recj):
        np.testing.assert_allclose(a["H"], b["H"], atol=T_TOL)


def test_run_sequence_batched_matches_jax(frames):
    out_j = jbatch.run_sequence_batched(frames, JCFG, seed=0)
    out_t = tbatch.run_sequence_batched(
        frames, TCFG, seed=0, device="cpu",
        sampler=JaxKeySampler.for_sequence(0, len(frames) - 1, K, S))
    _check_sequence(out_t, out_j)


def test_run_sequence_streaming_matches_jax(frames):
    out_j = jbatch.run_sequence_streaming(frames, JCFG, seed=0, chunk=2)
    out_t = tbatch.run_sequence_streaming(
        frames, TCFG, seed=0, chunk=2, device="cpu",
        sampler=JaxKeySampler.for_sequence(0, len(frames) - 1, K, S))
    _check_sequence(out_t, out_j)


# every way a tensor reaches the host; on the card each one waits for the device
HOST_READS = ("tolist", "item", "cpu", "numpy", "__array__", "__bool__", "__int__",
              "__float__", "__index__")
# the plain twin of kernel K1: its early-exit tests read the host, on the CPU only
# (the card runs the kernel)
PLAIN_K1 = os.path.join("multimot_track_tpu_torch", "solvers", "flow_ba.py")


# tensors made from host data: on the card, a copy the host waits for
HOST_COPIES = ("tensor", "as_tensor")


class HostReadGuard:
    """While on, every host read of a tensor and every tensor made from
    host data raises, except inside the plain flow-BA."""

    def __init__(self, monkeypatch):
        self.on, self.seen = False, []
        for owner, names in ((torch.Tensor, HOST_READS), (torch, HOST_COPIES)):
            for name in names:
                monkeypatch.setattr(owner, name, self._wrap(name, getattr(owner, name)))

    def _wrap(self, name, orig):
        def read(*a, **kw):
            caller = sys._getframe(1).f_code.co_filename
            if self.on and not caller.endswith(PLAIN_K1):
                self.seen.append(f"{name} from {caller}")
                raise RuntimeError(f"host read inside the streaming loop: {name} "
                                   f"from {caller}")
            return orig(*a, **kw)
        return read


def guarded_streaming(frames, monkeypatch, sampler):
    """``run_sequence_streaming`` on the CPU with every host read raising
    from the uploader's creation (before the first dispatch) to the drain."""
    guard = HostReadGuard(monkeypatch)
    drain = state.result_to_numpy

    class Uploader(tbatch.ChunkUploader):
        def __init__(self, device):
            super().__init__(device)
            guard.on = True

    def result_to_numpy(res):
        guard.on = False
        return drain(res)

    monkeypatch.setattr(tbatch, "ChunkUploader", Uploader)
    monkeypatch.setattr(state, "result_to_numpy", result_to_numpy)
    out = tbatch.run_sequence_streaming(frames, TCFG, seed=0, chunk=2, device="cpu",
                                        sampler=sampler)
    return out, guard


def test_streaming_makes_no_host_read_before_its_drain(frames, monkeypatch):
    """With the default sampler, nothing between the first dispatch and the
    single drain reads a tensor back; a sampler that asks for the object
    sites' names does (the guard's own check)."""
    (Tcw, res, _), guard = guarded_streaming(
        frames, monkeypatch, tbatch.MultinomialSampler(torch.Generator().manual_seed(0)))
    assert guard.seen == [] and np.all(np.isfinite(Tcw)) and Tcw.shape == (len(frames), 4, 4)
    with pytest.raises(RuntimeError, match="host read inside the streaming loop"):
        guarded_streaming(frames, monkeypatch,
                          JaxKeySampler.for_sequence(0, len(frames) - 1, K, S))


def test_port_slice_runs_without_jax():
    """Importing the port and running its CPU slice loads no jax."""
    code = (
        "import sys, dataclasses, torch\n"
        "torch.set_num_threads(1)\n"
        "from multimot_track_tpu_torch import config as C\n"
        "from multimot_track_tpu_torch.io.synth import make_multimover_frames, "
        "synth_camera_config\n"
        "from multimot_track_tpu_torch.pipeline import batch\n"
        "from multimot_track_tpu_torch.solvers import flow_ba_cuda\n"
        "import multimot_track_tpu_torch.state\n"
        "D = C.DEFAULT_CONFIG\n"
        "cfg = dataclasses.replace(D, camera=synth_camera_config(),\n"
        "    frontend=dataclasses.replace(D.frontend, n_features=500, n_levels=2),\n"
        "    padding=dataclasses.replace(D.padding, n_static_max=256, n_obj_pts_max=1024,\n"
        "        n_per_obj_max=512, k_obj_max=2, k_obj_solve=1),\n"
        "    solver=dataclasses.replace(D.solver, ransac_iters=16, obj_ransac_iters=16,\n"
        "        obj_ensemble_seeds=1, obj_reclassify_rounds=1, cam_lm_iters=5,\n"
        "        obj_lm_iters=5))\n"
        "T, res, rec = batch.run_sequence_batched(make_multimover_frames(n_frames=2), cfg,\n"
        "                                         device='cpu')\n"
        "assert T.shape == (2, 4, 4)\n"
        "print('jax' in sys.modules)\n"
    )
    env = dict(os.environ)
    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    env["PYTHONPATH"] = repo + os.pathsep + env.get("PYTHONPATH", "")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         env=env, timeout=300)
    assert out.returncode == 0, out.stderr[-3000:]
    assert out.stdout.strip().splitlines()[-1] == "False"
