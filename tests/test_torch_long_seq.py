"""Long sequences in the port (CPU): the window renderer, a circuit window
through both packages' live systems, the evaluation modules' rows, and the
port's counterparts of ``tests/test_long_seq.py``.

(i) ``make_circuit_frames`` / ``make_avenue_frames`` with ``times=`` (a
    window of the full scene) against the JAX package's full render of
    the same short lap (``n_frames=6`` at ``SYNTH_CAM``, times 2-4): bit
    for bit, except the two stated differences: the ground truth is
    re-anchored at the window's first frame (compared after the same
    re-anchoring, to float32 rounding), and the window's last frame has
    no next frame, so its flow is zero.
(ii) Both packages' ``MultiMotSystem`` on frames 20-24 of the 110-frame
    circuit of ``tests/test_long_seq.py`` (rendered once by the port's
    window renderer), at ``test_torch_live``'s slice configuration and on
    the same draws (``JaxKeySampler``): trajectories within 1e-3, the same
    keyframes, object records and track IDs.  ``eval.long_seq.run_scene``
    and ``eval.kobj_ab.run_one`` then run on the CPU and give their rows.
(iii) The six tests of ``tests/test_long_seq.py`` on the port, with the
    same scenes, configuration and gates, marked ``slow`` as those are.
"""

import dataclasses
import json

import numpy as np
import pytest
import torch

from multimot_track_tpu.io import synth as jsynth
from multimot_track_tpu_torch import config as tconfig
from multimot_track_tpu_torch.eval import kobj_ab, long_seq
from multimot_track_tpu_torch.io import synth as tsynth
from multimot_track_tpu_torch.pipeline.system import MultiMotSystem as TSystem
from test_torch_live import JCFG, TCFG, compare_systems, run_jax, run_port

torch.set_num_threads(1)

WINDOW = list(range(20, 25))       # frames of the 110-frame circuit in (ii)


@pytest.mark.parametrize("scene", ["circuit", "avenue"])
def test_window_render_matches_full_render(scene):
    make = {"circuit": "make_circuit_frames", "avenue": "make_avenue_frames"}[scene]
    full = getattr(jsynth, make)(n_frames=6, cam=dict(jsynth.SYNTH_CAM))
    times = [2, 3, 4]
    win = getattr(tsynth, make)(n_frames=6, cam=dict(tsynth.SYNTH_CAM), times=times)
    assert len(win) == len(times)
    G = np.linalg.inv(full[times[0]].pose_gt.astype(np.float64))
    for k, t in enumerate(times):
        a, b = win[k], full[t]
        assert a.index == k and a.timestamp == b.timestamp
        for name in ("gray", "depth_raw", "sem_mask", "obj_ids_gt", "obj_poses_gt",
                     "obj_bboxes_gt"):
            x, y = getattr(a, name), getattr(b, name)
            assert x.dtype == y.dtype, name
            np.testing.assert_array_equal(x, y, err_msg=name)
        if k + 1 < len(times):
            np.testing.assert_array_equal(a.flow, b.flow)
        else:
            assert not a.flow.any() and b.flow.any()
        np.testing.assert_allclose(a.pose_gt, G @ b.pose_gt, atol=1e-5)


@pytest.fixture(scope="module")
def circuit_window():
    return tsynth.make_circuit_frames(n_frames=110, radius=28.0, cam=dict(tsynth.SYNTH_CAM),
                                      overlap=0.08, times=WINDOW)


def test_circuit_window_live_matches_jax(circuit_window):
    j, rj, _ = run_jax(JCFG, circuit_window)
    t, rt = run_port(TCFG, circuit_window)
    assert len(rt) == len(rj) == len(WINDOW) - 1
    compare_systems(t, j)
    st, sj = t.summary(), j.summary()
    assert st["n_obj_estimates"] == sj["n_obj_estimates"] > 0
    for k in ("cam_t_rpe_rel_mean", "ego_ate_rmse_m"):
        assert abs(st[k] - sj[k]) <= 1e-3, k


def test_eval_rows_on_cpu(circuit_window, tmp_path):
    row = long_seq.run_scene("circuit-window", circuit_window[:3], TCFG, "cpu",
                             keyframe_gap=1, enable_loop_closing=False)
    assert row["n_frames"] == 3 and row["poses_finite"] and row["device"] == "cpu"
    assert row["k1_launches"] == row["k2_launches"] == 0 and row["peak_mem_gib"] is None
    assert {"dispatch_pair", "features"} <= set(row["stages"])
    long_seq.write_outputs(tmp_path / "LONGSEQ_torch", [row], [])
    back = json.loads((tmp_path / "LONGSEQ_torch.json").read_text())
    assert back["rows"][0]["scene"] == "circuit-window" and back["mono_rows"] == []
    assert "| circuit-window | 3 |" in (tmp_path / "LONGSEQ_torch.md").read_text()
    frames = tsynth.make_junction_frames(n_frames=2, cam=dict(tsynth.SYNTH_CAM))
    r = kobj_ab.run_one(frames, TCFG, 2, "cpu")
    assert r["k_obj_solve"] == 2 and r["n_labels_visible"] >= 6 and r["device"] == "cpu"
    if not torch.cuda.is_available():        # the card is the default device
        with pytest.raises(RuntimeError, match="--cpu"):
            long_seq.main(["--frames", "2"])


# ---------------------------------------------------------------------------
# (iii) tests/test_long_seq.py on the port

CFG = dataclasses.replace(
    tconfig.DEFAULT_CONFIG,
    camera=tsynth.synth_camera_config(),
    padding=dataclasses.replace(tconfig.DEFAULT_CONFIG.padding, n_static_max=1024,
                                n_obj_pts_max=4096, k_obj_max=8),
    solver=dataclasses.replace(tconfig.DEFAULT_CONFIG.solver, ransac_iters=200,
                               cam_lm_iters=60, obj_lm_iters=100),
)


def _run(frames, keyframe_gap=4, cfg=CFG, **kw):
    sys_ = TSystem(cfg, keyframe_gap=keyframe_gap, device="cpu", **kw)
    for fd in frames:
        sys_.track_rgbd(fd)
    return sys_


@pytest.fixture(scope="module")
def circuit():
    frames = tsynth.make_circuit_frames(n_frames=110, radius=28.0, cam=dict(tsynth.SYNTH_CAM),
                                        overlap=0.08)
    return frames, _run(frames, keyframe_gap=2, loop_consistency=1)


@pytest.fixture(scope="module")
def avenue():
    frames = tsynth.make_avenue_frames(n_frames=48, cam=dict(tsynth.SYNTH_CAM))
    return frames, _run(frames)


@pytest.fixture(scope="module")
def avenue_noisy():
    frames = tsynth.degrade_frames(tsynth.make_avenue_frames(n_frames=48,
                                                            cam=dict(tsynth.SYNTH_CAM)),
                                   seed=11, bf=tsynth.SYNTH_CAM["bf"])
    return frames, _run(frames)


def _by_sem(sys_):
    recs = [r for r in sys_.map.obj_records if r.has_gt]
    by_sem = {}
    for r in recs:
        by_sem.setdefault(r.sem_label, []).append(r)
    return recs, by_sem


def _mover_gates(sys_, min_labels, lead_centred=True):
    recs, by_sem = _by_sem(sys_)
    assert recs
    assert len(by_sem) >= min_labels, sorted(by_sem)
    lead = by_sem.get(1, [])
    others = [r for r in recs if r.sem_label != 1]
    if lead:
        sp = [r.speed_err_rel for r in lead if np.isfinite(r.speed_err_rel)]
        assert np.median(sp) < 0.08, np.median(sp)
        if lead_centred:
            assert np.median([r.t_rpe_centred for r in lead]) < 0.35
    assert others, sorted(by_sem)
    assert np.median([r.t_rpe_centred for r in others]) < 0.12
    return recs


@pytest.mark.slow
def test_circuit_ego_through_full_turn(circuit):
    frames, sys_ = circuit
    s = sys_.summary()
    assert s["n_frames"] == len(frames)
    assert s["cam_t_rpe_rel_mean"] < 0.02, s
    assert s["ego_ate_rmse_m"] < 0.60, s


@pytest.mark.slow
def test_circuit_loop_closes(circuit):
    _, sys_ = circuit
    assert sys_.summary()["n_loop_closures"] >= 1


@pytest.mark.slow
def test_circuit_movers(circuit):
    _mover_gates(circuit[1], 3)


@pytest.mark.slow
def test_avenue_degraded_inputs(avenue_noisy):
    s = avenue_noisy[1].summary()
    assert s["cam_t_rpe_rel_mean"] < 0.05, s
    assert s["ego_ate_rmse_m"] < 0.40, s
    _mover_gates(avenue_noisy[1], 2, lead_centred=False)


@pytest.mark.slow
def test_circuit_loop_closes_beyond_capacity(circuit):
    frames, _ = circuit
    cfg = dataclasses.replace(CFG, backend=dataclasses.replace(CFG.backend, kf_capacity=24))
    sys_ = _run(frames, keyframe_gap=2, cfg=cfg, loop_consistency=1)
    s = sys_.summary()
    assert len(sys_.keyframes.frames) <= 24
    assert s["n_loop_closures"] >= 1, s
    assert s["ego_ate_rmse_m"] < 0.80, s


@pytest.mark.slow
def test_avenue_ego_and_movers(avenue):
    s = avenue[1].summary()
    assert s["cam_t_rpe_rel_mean"] < 0.05, s
    assert s["ego_ate_rmse_m"] < 0.40, s
    recs = _mover_gates(avenue[1], 2)
    sp_all = [r.speed_err_rel for r in recs if np.isfinite(r.speed_err_rel)]
    assert np.median(sp_all) < 0.25, np.median(sp_all)
