"""The live RGB-D system: the PyTorch port against the JAX package (CPU).

Both packages run ``MultiMotSystem`` on ``make_multimover_frames(5)`` at
``test_torch_tracker.small_config`` with the slice's switches (window BA,
joint window BA and loop closing off; keyframes every frame, fused
TrackLocalMap, fusion and culling on) and draw the same RANSAC / PnP
hypotheses (``JaxKeySampler`` over the live step keys).  One module-scoped
run of each feeds the comparisons.

Tolerances: trajectories max |dT| <= 1e-3 (float32 solves in another
summation order agree to ~1e-6 here; the bound is the slice gate's);
keyframe indices, local-map accept counts, object records, track IDs and
live map points identical, descriptor bits 99.99 %; the port's own modes (pipelined with the
synchronous keyframe cadence, the unfused local-map path, a resumed
checkpoint) agree with its synchronous run to 1e-5 (object motions of the
pipelined run to 1e-3: its device chain runs uncorrected).
"""

import dataclasses
import os
import subprocess
import sys

import jax
import numpy as np
import pytest
import torch

from multimot_track_tpu import config as jconfig
from multimot_track_tpu.io.synth import make_multimover_frames, synth_camera_config
from multimot_track_tpu.pipeline import live_refine as jlive_refine
from multimot_track_tpu.pipeline.system import MultiMotSystem as JSystem
from multimot_track_tpu_torch import config as tconfig
from multimot_track_tpu_torch.io.synth import synth_camera_config as t_synth_cam
from multimot_track_tpu_torch.pipeline import step_graph
from multimot_track_tpu_torch.pipeline.system import MultiMotSystem as TSystem
from test_torch_ransac import FoldInKeys, JaxKeySampler
from test_torch_tracker import small_config

torch.set_num_threads(1)

T_TOL, SELF_TOL = 1e-3, 1e-5
SEED = 0


def slice_config(C, cam, **backend):
    c = small_config(C, cam)
    backend = {"window_refine": False, "joint_window_refine": False, **backend}
    return dataclasses.replace(c, backend=dataclasses.replace(c.backend, **backend))


JCFG = slice_config(jconfig, synth_camera_config())
TCFG = slice_config(tconfig, t_synth_cam())


def jax_sampler():
    return JaxKeySampler(FoldInKeys(SEED), TCFG.padding.k_obj_max,
                         TCFG.solver.obj_ensemble_seeds)


def run(system, frames, lost_last=False):
    """Feed every frame, then flush; returns the delivered results.
    ``lost_last``: the last frame is processed as LOST (its ego solve held
    to an impossible inlier count), which runs the relocalization ladder."""
    out = [system.track_rgbd(fd) for fd in frames[:-1]]
    if lost_last and not system.pipelined:   # processed by this call
        system.min_inliers = 10 ** 6
    out.append(system.track_rgbd(frames[-1]))
    if lost_last:                            # pipelined: processed by flush()
        system.min_inliers = 10 ** 6
    out.append(system.flush())
    return [r for r in out if r is not None]


def run_jax(cfg, frames, lost_last=False, **kw):
    """The JAX system; returns it, its results and, per fused refinement,
    (frame, local-map accept, window committed unless the frame is LOST),
    read from the transfer vector the JAX package splits."""
    log, cur = [], {}
    split = jlive_refine.split_refined
    s = JSystem(cfg, seed=SEED, keyframe_gap=1, enable_loop_closing=False, **kw)
    process = s._process_frame

    def processing(pend):
        cur["frame"] = pend["frame_idx"]
        return process(pend)

    def recording(flat, cfg_, window):
        out = split(flat, cfg_, window)
        _, _, accept_lm, _, poses_out, n_live = out
        committed = bool(window and n_live >= cfg_.backend.min_window_tracks
                         and np.isfinite(poses_out).all())
        log.append((cur["frame"], accept_lm, committed))
        return out

    s._process_frame = processing
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jlive_refine, "split_refined", recording)
        results = run(s, frames, lost_last)
    return s, results, log


def run_port(cfg, frames, lost_last=False, **kw):
    s = TSystem(cfg, seed=SEED, keyframe_gap=1, enable_loop_closing=False,
                sampler=jax_sampler(), device="cpu", **kw)
    return s, run(s, frames, lost_last)


def poses(s, raw=False):
    return np.stack(s.map.camera_poses_raw if raw else s.map.camera_poses)


def compare_systems(t, j, tol=T_TOL, obj_tol=None):
    """Trajectories (refined and raw) to ``tol``; keyframes, object records
    and track IDs identical; object motions to ``obj_tol`` (default tol)."""
    obj_tol = obj_tol or tol
    assert len(t.map.camera_poses) == len(j.map.camera_poses)
    dT = float(np.abs(poses(t) - poses(j)).max())
    assert dT <= tol, dT
    assert float(np.abs(poses(t, raw=True) - poses(j, raw=True)).max()) <= tol
    assert [k.index for k in t.keyframes.frames] == [k.index for k in j.keyframes.frames]
    rt, rj = t.map.obj_records, j.map.obj_records
    assert len(rt) > 0
    assert [(r.frame, r.track_id, r.sem_label) for r in rt] == \
           [(r.frame, r.track_id, r.sem_label) for r in rj]
    for a, b in zip(rt, rj):
        np.testing.assert_allclose(a.H, b.H, atol=obj_tol)
        np.testing.assert_allclose(a.P_lc, b.P_lc, atol=obj_tol)


@pytest.fixture(scope="module")
def frames():
    return make_multimover_frames(n_frames=5)


@pytest.fixture(scope="module")
def sync_runs(frames):
    j, rj, log = run_jax(JCFG, frames)
    t, rt = run_port(TCFG, frames)
    return j, rj, log, t, rt


def test_live_system_sync_matches_jax(sync_runs):
    j, rj, log, t, rt = sync_runs
    assert len(rt) == len(rj) == 4
    compare_systems(t, j)
    assert len(t.keyframes.frames) == len(j.keyframes.frames) == 4
    # every frame after the first keyframe refined against the local map
    assert t.n_lm_dispatched == len(log) == 3
    assert t.lm_accepted_frames == [f for f, a, _ in log if a] != []
    st, sj = t.summary(), j.summary()
    for k in ("cam_t_rpe_rel_mean", "ego_ate_rmse_m", "ego_ate_rmse_raw_m",
              "cam_t_rpe_refined_mean", "obj_t_rpe_refined_mean"):
        assert abs(st[k] - sj[k]) <= T_TOL, k
    assert st["n_obj_estimates"] == sj["n_obj_estimates"]
    for a, b in zip(rt, rj):
        np.testing.assert_allclose(a.Tcw_cur, np.asarray(b.Tcw_cur), atol=T_TOL)
        assert int(a.n_static_inliers) == int(b.n_static_inliers)


def test_a_host_sampler_keeps_the_pair_step_eager(sync_runs):
    """The JAX-key sampler names its draws, which reads the object slots back
    to the host, so the tape of CUDA graphs (``pipeline/step_graph``) never
    engages for it: every pair counts ``replayed`` 0, the tape holds no
    signature."""
    t = sync_runs[3]
    assert step_graph._generators(t.sampler, None, []) is None
    assert t.stage_counts["dispatch_pair/replayed"] == [0] * 4
    assert t._step_tape._key is None and t._step_tape._tape is None


def test_keyframe_map_matches_jax(sync_runs):
    j, _, _, t, _ = sync_runs
    assert t.keyframes.n_fuse_scans == 3 and t.keyframes.n_fused > 0
    assert t.keyframes.n_live_points() == j.keyframes.n_live_points()
    for a, b in zip(t.keyframes.frames, j.keyframes.frames):
        # descriptors: the IC angle's float32 moment sums round apart
        # (test_torch_orb), which can move a steered sample across a pixel
        assert (a.desc == b.desc).mean() >= 0.9999
        np.testing.assert_array_equal(a.valid, b.valid)
        np.testing.assert_array_equal(a.live, b.live)
        np.testing.assert_allclose(a.Xw, b.Xw, atol=T_TOL)


def test_relocalize_matches_jax(sync_runs):
    """Relocalization of the last frame's features against the run's
    keyframes, with the hypotheses JAX draws under that frame's step key."""
    j, _, _, t, _ = sync_runs
    cam = TCFG.camera
    fj, ft = j._feat_cache, t._feat_cache
    assert fj[0] == ft[0] == 4
    uv, desc, valid, _ = fj[1]
    Tj = j.keyframes.relocalize(jax.random.fold_in(jax.random.PRNGKey(SEED), 4),
                                desc, uv, valid, cam.fx, cam.fy, cam.cx, cam.cy)
    uv, desc, valid, _ = ft[1]
    Tt = t.keyframes.relocalize(t.sampler, (4, "pnp"), desc, uv, valid,
                                cam.fx, cam.fy, cam.cx, cam.cy)
    assert Tj is not None and Tt is not None
    np.testing.assert_allclose(Tt, Tj, atol=T_TOL)
    np.testing.assert_allclose(Tt, np.linalg.inv(t.map.camera_poses[4]), atol=0.05)


def test_pipelined_equals_sync(frames, sync_runs):
    """Pipelined serving with the synchronous keyframe cadence delivers
    every result one frame late and tracks as the synchronous mode does."""
    _, _, _, t, rt = sync_runs
    cfg = slice_config(tconfig, t_synth_cam(), async_keyframes=False)
    p, rp = run_port(cfg, frames, pipelined=True)
    assert len(rp) == len(rt) == 4
    # the pipelined device chain runs uncorrected, so each object solve
    # starts from a pose differing by the pending correction: the motions
    # agree to the gate's tolerance, the trajectory to float32 rounding
    compare_systems(p, t, tol=SELF_TOL, obj_tol=T_TOL)
    assert p.lm_accepted_frames == t.lm_accepted_frames
    assert p.flush() is None


def test_unfused_local_map_equals_fused(frames, sync_runs):
    _, _, _, t, _ = sync_runs
    cfg = slice_config(tconfig, t_synth_cam(), fused_refine=False)
    u, _ = run_port(cfg, frames)
    compare_systems(u, t, tol=SELF_TOL)
    assert u.lm_accepted_frames == t.lm_accepted_frames
    assert "local_map" in u.stage_report()


def test_checkpoint_resume_and_savers(frames, sync_runs, tmp_path):
    _, _, _, t, _ = sync_runs
    s = TSystem(TCFG, seed=SEED, keyframe_gap=1, enable_loop_closing=False,
                sampler=jax_sampler(), device="cpu")
    for fd in frames[:4]:
        s.track_rgbd(fd)
    s.save_checkpoint(tmp_path / "ck.pkl")
    r = TSystem(TCFG, seed=SEED, keyframe_gap=1, enable_loop_closing=False,
                sampler=jax_sampler(), device="cpu")
    r.load_checkpoint(tmp_path / "ck.pkl")
    r.track_rgbd(frames[4])
    np.testing.assert_allclose(poses(r), poses(t), atol=SELF_TOL)
    assert [k.index for k in r.keyframes.frames] == [k.index for k in t.keyframes.frames]
    r.save_results(tmp_path / "out")
    r.save_trajectory_tum(tmp_path / "out" / "traj.tum")
    lines = (tmp_path / "out" / "camera_pose.txt").read_text().splitlines()
    assert len(lines) == 5 and len(lines[0].split()) == 12
    assert (tmp_path / "out" / "object_motion.txt").read_text().strip()
    assert len((tmp_path / "out" / "traj.tum").read_text().splitlines()) == 5


@pytest.mark.parametrize("kw,item", [
    (dict(discover_objects=True), "21"),
])
def test_unported_backend_features_raise(kw, item):
    """The backend features that raised until their ROADMAP item was ported
    now construct, with the configuration the JAX package derives
    (discovery turns on the scene-flow gate)."""
    t, j = TSystem(TCFG, device="cpu", **kw), JSystem(JCFG, **kw)
    assert t.cfg == dataclasses.replace(TCFG, solver=dataclasses.replace(
        TCFG.solver, sf_cam_gate=0.35))
    assert t.cfg.solver.sf_cam_gate == j.cfg.solver.sf_cam_gate
    assert all(getattr(t, k) == getattr(j, k) for k in kw)


def test_default_arguments_track(frames):
    """The JAX package's defaults (loop closing on, keyframes every 5
    frames) construct and track."""
    s = TSystem(TCFG, device="cpu")
    assert s.enable_loop_closing and s.loop_consistency == 3
    s.track_rgbd(frames[0])
    r = s.track_rgbd(frames[1])
    assert r is not None and np.isfinite(np.asarray(r.Tcw_cur)).all()
    assert [k.index for k in s.keyframes.frames] == [1] and s.map.loop_events == []


def test_default_device_is_the_card():
    """Without device=, the live system runs on the card; with no card it
    raises rather than running on the CPU."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device exists: the default has a card to run on")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        TSystem(TCFG, enable_loop_closing=False)


def test_pipelined_requires_fused_refine():
    cfg = slice_config(tconfig, t_synth_cam(), fused_refine=False)
    with pytest.raises(ValueError, match="fused_refine"):
        TSystem(cfg, enable_loop_closing=False, pipelined=True)


def test_live_path_runs_without_jax():
    """Importing the live system and running it with the window and joint
    window BA, pipelined and through a relocalization, loads no jax."""
    code = (
        "import sys, dataclasses, torch\n"
        "torch.set_num_threads(1)\n"
        "from multimot_track_tpu_torch import config as C\n"
        "from multimot_track_tpu_torch.io.synth import make_multimover_frames, "
        "synth_camera_config\n"
        "from multimot_track_tpu_torch.pipeline.system import MultiMotSystem, run_sequence\n"
        "from multimot_track_tpu_torch.ops import match_cuda\n"
        "D = C.DEFAULT_CONFIG\n"
        "cfg = dataclasses.replace(D, camera=synth_camera_config(),\n"
        "    frontend=dataclasses.replace(D.frontend, n_features=500, n_levels=2),\n"
        "    padding=dataclasses.replace(D.padding, n_static_max=256, n_obj_pts_max=1024,\n"
        "        n_per_obj_max=512, k_obj_max=2, k_obj_solve=1),\n"
        "    solver=dataclasses.replace(D.solver, ransac_iters=16, obj_ransac_iters=16,\n"
        "        obj_ensemble_seeds=1, obj_reclassify_rounds=1, cam_lm_iters=5,\n"
        "        obj_lm_iters=5),\n"
        "    backend=dataclasses.replace(D.backend, window_size=2, n_window_tracks=512,\n"
        "        joint_static_max=256))\n"
        "fr = make_multimover_frames(n_frames=3)\n"
        "class Seq(list):\n"
        "    load_frame = list.__getitem__\n"
        "s = run_sequence(Seq(fr), cfg, keyframe_gap=1, enable_loop_closing=False,\n"
        "                 pipelined=True, device='cpu')\n"
        "assert len(s.map.camera_poses) == 3 and s.keyframes.frames\n"
        "assert s.n_win_dispatched == 2 and s.n_joint_refines > 0, "
        "(s.n_win_dispatched, s.n_joint_refines)\n"
        "s2 = MultiMotSystem(cfg, keyframe_gap=1, enable_loop_closing=False, device='cpu')\n"
        "s2.track_rgbd(fr[0]); s2.track_rgbd(fr[1])\n"
        "s2.min_inliers = 10 ** 6\n"
        "s2.track_rgbd(fr[2])\n"
        "print(s2.state, s2.n_relocalized, 'jax' in sys.modules)\n"
    )
    env = dict(os.environ)
    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    env["PYTHONPATH"] = repo + os.pathsep + env.get("PYTHONPATH", "")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         env=env, timeout=300)
    assert out.returncode == 0, out.stderr[-3000:]
    state, n_reloc, jax_loaded = out.stdout.strip().splitlines()[-1].split()
    assert jax_loaded == "False"
    # the forced LOST frame is rescued by relocalization against frame 1
    assert (state, n_reloc) == ("OK", "1")
