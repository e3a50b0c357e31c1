"""Parity of the port's loop ladder with the JAX package (CPU): Umeyama and
Sim3 RANSAC, the dense and CG pose graphs, DLT triangulation, the keyframe
store's ``triangulate_between``, ``close_loop`` and ``global_ba``, and the
live system's loop-candidate consistency gate.  The fixtures are those of
``tests/test_loop_closing.py``; Sim3 hypotheses are replayed from the JAX
key (``JaxKeySampler`` at the site ``(frame, "sim3")``).

Tolerances, with their reasons:
* Umeyama: atol 1e-5 on (s, R, t) of well-conditioned sets (float32 3x3
  SVDs through two LAPACK paths);
* Sim3 RANSAC: the best model atol 1e-4 and its inlier count +-2, not the
  hypothesis index: a point within rounding of the gate can move a count
  by one and so the first maximum;
* pose graphs, triangulation, ``close_loop``: poses and points atol 1e-4
  (float32 solves and scatter sums in another order); the CG pose graph at
  M = 300 rotations atol 1e-3 and translations atol 2.5e-4 of the chain's
  extent (its test says why);
* ``global_ba``: landmark and edge counts identical (host union-find on
  exact Hamming matches), chi2 before rtol 1e-3, chi2 after within 1e-5 of
  chi2 before (both at the float32 floor), poses atol 1e-3 and re-anchored
  points atol 1e-3 + rtol 1e-4 (points 8-35 m deep; 25 damped steps with a
  data-dependent stop);
* the consistency gate: identical decisions.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from multimot_track_tpu.geometry import se3 as jse3
from multimot_track_tpu.pipeline import keyframes as jkf
from multimot_track_tpu.solvers import initializer as jinit
from multimot_track_tpu.solvers import pose_graph as jpg
from multimot_track_tpu.solvers import sim3 as jsim3
from multimot_track_tpu_torch.config import DEFAULT_CONFIG
from multimot_track_tpu_torch.pipeline import keyframes as tkf
from multimot_track_tpu_torch.pipeline.system import MultiMotSystem as TSystem
from multimot_track_tpu_torch.solvers import initializer as tinit
from multimot_track_tpu_torch.solvers import pose_graph as tpg
from multimot_track_tpu_torch.solvers import sim3 as tsim3
from test_loop_closing import CAM, _make_gba_world, make_kf
from test_torch_ransac import JaxKeySampler

torch.set_num_threads(1)

FX, FY, CX, CY, BF = CAM.fx, CAM.fy, CAM.cx, CAM.cy, CAM.bf


def _t(a):
    return torch.from_numpy(np.array(a))


def _pose(xi):
    return np.asarray(jse3.exp_se3(jnp.asarray(np.asarray(xi, np.float32))))


def _port_kf(kf):
    """A port Keyframe holding copies of a JAX Keyframe's arrays."""
    copy = lambda v: np.copy(v) if isinstance(v, np.ndarray) else v
    return tkf.Keyframe(**{f.name: copy(getattr(kf, f.name)) for f in dataclasses.fields(kf)})


def _port_store(jstore):
    ts = tkf.KeyframeStore(capacity=jstore.capacity, min_gap=jstore.min_gap, device="cpu")
    for kf in jstore.frames:
        assert ts.maybe_add(_port_kf(kf))
    return ts


@pytest.mark.parametrize("with_scale", [True, False])
def test_umeyama_matches_jax(with_scale):
    rng = np.random.default_rng(0)
    src = rng.normal(0, 3, (64, 12, 3)).astype(np.float32)
    T = np.asarray(jse3.exp_se3(jnp.asarray(rng.normal(0, 0.3, (64, 6)).astype(np.float32))))
    s = rng.uniform(0.7, 1.4, 64).astype(np.float32) if with_scale else np.ones(64, np.float32)
    dst = s[:, None, None] * np.einsum("nij,nkj->nki", T[:, :3, :3], src) + T[:, None, :3, 3]
    dst = (dst + rng.normal(0, 0.01, dst.shape)).astype(np.float32)
    sj, Rj, tj = jsim3.umeyama(jnp.asarray(src), jnp.asarray(dst), with_scale=with_scale)
    st, Rt, tt = tsim3.umeyama(_t(src), _t(dst), with_scale=with_scale)
    for a, b in ((st, sj), (Rt, Rj), (tt, tj)):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), atol=1e-5)
    np.testing.assert_allclose(Rt.numpy(), T[:, :3, :3], atol=1e-2)
    np.testing.assert_allclose(st.numpy(), s, atol=1e-2)


def _sim3_scene(seed, scale, N=400, outliers=0.3):
    """Keyframe-1 camera points, their images in keyframe 2 under a Sim3,
    0.01 m noise, ``outliers`` of them displaced by ~1 m, 10 % invalid."""
    rng = np.random.default_rng(seed)
    uv = np.stack([rng.uniform(50, 1150, N), rng.uniform(30, 340, N)], -1)
    z = rng.uniform(4.0, 30.0, N)
    X1 = np.stack([(uv[:, 0] - CX) * z / FX, (uv[:, 1] - CY) * z / FY, z], -1)
    T = _pose([0.01, -0.03, 0.005, 0.3, -0.05, 0.4])
    X2 = scale * X1 @ T[:3, :3].T + T[:3, 3] + rng.normal(0, 0.01, X1.shape)
    n_out = int(outliers * N)
    X2[:n_out] += rng.normal(0, 1.0, (n_out, 3))
    return X1.astype(np.float32), X2.astype(np.float32), rng.uniform(size=N) < 0.9, T


@pytest.mark.parametrize("fix_scale", [True, False])
def test_ransac_sim3_with_replayed_samples_matches_jax(fix_scale):
    X1, X2, valid, T = _sim3_scene(3, 1.0 if fix_scale else 1.15)
    key = jax.random.PRNGKey(5)
    rj = jsim3.ransac_sim3(key, jnp.asarray(X1), jnp.asarray(X2), jnp.asarray(valid),
                           FX, FY, CX, CY, fix_scale=fix_scale)
    rt = tsim3.ransac_sim3(_t(X1), _t(X2), _t(valid), FX, FY, CX, CY,
                           sampler=JaxKeySampler({11: key}, 1, 1), site=(11, "sim3"),
                           fix_scale=fix_scale)
    assert abs(int(rt.n_inliers) - int(rj.n_inliers)) <= 2
    assert int(rt.n_inliers) > 0.5 * valid.sum()
    for a, b in ((rt.scale, rj.scale), (rt.R, rj.R), (rt.t, rj.t)):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), atol=1e-4)
    assert (rt.inliers.numpy() != np.asarray(rj.inliers)).sum() <= 2
    np.testing.assert_allclose(rt.R.numpy(), T[:3, :3], atol=5e-3)
    assert abs(float(rt.scale) - (1.0 if fix_scale else 1.15)) < 5e-3


def _drift_graph(M, rel_xi, drift_xi, w_loop):
    """The drifted chain of test_loop_closing with the true loop edge
    (last -> first).  Returns numpy (poses, ij, Z, w)."""
    true_rel, drift = _pose(rel_xi), _pose(drift_xi)
    poses, true_poses = [np.eye(4, dtype=np.float32)], [np.eye(4, dtype=np.float32)]
    for _ in range(1, M):
        poses.append((drift @ true_rel @ poses[-1]).astype(np.float32))
        true_poses.append((true_rel @ true_poses[-1]).astype(np.float32))
    poses, true_poses = np.stack(poses), np.stack(true_poses)
    ij_odo, Z_odo = jpg.odometry_edges(jnp.asarray(poses))
    ij = np.concatenate([np.asarray(ij_odo), [[M - 1, 0]]]).astype(np.int32)
    Z = np.concatenate([np.asarray(Z_odo), (true_poses[-1] @ np.linalg.inv(true_poses[0]))[None]])
    w = np.concatenate([np.ones(M - 1), [w_loop]]).astype(np.float32)
    return poses, ij, Z.astype(np.float32), w, true_poses


def test_odometry_edges_match_jax():
    poses = _drift_graph(12, [0, 0.05, 0, 0, 0, 1.0], [0, 0.004, 0, 0.01, 0, 0.02], 50.0)[0]
    ij_j, Z_j = jpg.odometry_edges(jnp.asarray(poses))
    ij_t, Z_t = tpg.odometry_edges(_t(poses))
    np.testing.assert_array_equal(ij_t.numpy(), np.asarray(ij_j))
    np.testing.assert_allclose(Z_t.numpy(), np.asarray(Z_j), atol=1e-5)


def test_dense_pose_graph_matches_jax():
    poses, ij, Z, w, true_poses = _drift_graph(12, [0, 0.05, 0, 0, 0, 1.0],
                                               [0, 0.004, 0, 0.01, 0, 0.02], 50.0)
    oj = jpg.optimize_pose_graph(*map(jnp.asarray, (poses, ij, Z, w)))
    ot = tpg.optimize_pose_graph(*map(_t, (poses, ij, Z, w)))
    np.testing.assert_allclose(ot.poses.numpy(), np.asarray(oj.poses), atol=1e-4)
    np.testing.assert_allclose(float(ot.chi2), float(oj.chi2), rtol=1e-3, atol=1e-6)
    err = lambda P: np.linalg.norm((P[-1] @ np.linalg.inv(true_poses[-1]))[:3, 3])
    assert err(ot.poses.numpy()) < 0.5 * err(poses)


@pytest.mark.parametrize("M", [12, 300])
def test_cg_pose_graph_matches_jax(M):
    """M = 12: the dense fixture; M = 300: above the ladder's dense/CG switch
    (cg_iters = 450) on a 199 m chain, where float32 CG itself limits the
    agreement: each package lies 0.013-0.018 m from a float64 run of the
    same solver, so translations are held to 2.5e-4 of the chain's extent
    and the corrected end pose's error to 5 mm of the JAX one."""
    if M == 12:
        g = _drift_graph(12, [0, 0.05, 0, 0, 0, 1.0], [0, 0.004, 0, 0.01, 0, 0.02], 50.0)
    else:
        g = _drift_graph(M, [0, 0.01, 0, 0, 0, 1.0], [0, 0.0005, 0, 0.002, 0, 0.004], 100.0)
    poses, ij, Z, w, true_poses = g
    Pj = np.asarray(jpg.optimize_pose_graph_cg(*map(jnp.asarray, (poses, ij, Z, w))).poses)
    Pt = tpg.optimize_pose_graph_cg(*map(_t, (poses, ij, Z, w))).poses.numpy()
    err = lambda P: np.linalg.norm((P[-1] @ np.linalg.inv(true_poses[-1]))[:3, 3])
    if M == 12:
        np.testing.assert_allclose(Pt, Pj, atol=1e-4)
    else:
        np.testing.assert_allclose(Pt[:, :3, :3], Pj[:, :3, :3], atol=1e-3)
        extent = np.abs(Pj[:, :3, 3]).max()
        np.testing.assert_allclose(Pt[:, :3, 3], Pj[:, :3, 3], atol=2.5e-4 * extent)
        assert abs(err(Pt) - err(Pj)) < 5e-3
    assert err(Pt) < 0.5 * err(poses)


def _two_views(seed=3, n=256):
    rng = np.random.default_rng(seed)
    uv = rng.uniform([200, 80], [1000, 300], (n, 2)).astype(np.float32)
    z = rng.uniform(6, 25, (n,)).astype(np.float32)
    Xc = np.stack([(uv[:, 0] - CX) * z / FX, (uv[:, 1] - CY) * z / FY, z], -1).astype(np.float32)
    T2 = _pose([0.01, -0.02, 0.0, 0.5, 0.02, 0.8]).astype(np.float32)
    Xc2 = (T2[:3, :3] @ Xc.T).T + T2[:3, 3]
    uv2 = np.stack([FX * Xc2[:, 0] / Xc2[:, 2] + CX, FY * Xc2[:, 1] / Xc2[:, 2] + CY], -1)
    desc = rng.choice([-1, 1], size=(n, 256)).astype(np.int8)
    return uv, Xc, T2, uv2.astype(np.float32), Xc2.astype(np.float32), desc


def test_triangulate_matches_jax():
    uv, Xc, T2, uv2, _, _ = _two_views()
    Kmat = np.asarray([[FX, 0, CX], [0, FY, CY], [0, 0, 1]], np.float32)
    P1, P2 = Kmat @ np.eye(4, dtype=np.float32)[:3], Kmat @ T2[:3]
    Xj = np.asarray(jinit.triangulate(*map(jnp.asarray, (P1, P2, uv, uv2))))
    Xt = tinit.triangulate(*map(_t, (P1, P2, uv, uv2))).numpy()
    np.testing.assert_allclose(Xt, Xj, atol=1e-4, rtol=1e-5)
    np.testing.assert_allclose(Xt, Xc, atol=0.05)
    # a vanishing homogeneous coordinate divides by 1e-12, not by zero
    inf_pt = np.array([[0.0, 0.0]], np.float32)
    P = np.asarray([[1, 0, 0, 0], [0, 1, 0, 0], [0, 0, 0, 1]], np.float32)
    assert np.isfinite(tinit.triangulate(_t(P), _t(P), _t(inf_pt), _t(inf_pt)).numpy()).all()


def test_triangulate_between_matches_jax():
    uv, Xc, T2, uv2, Xc2, desc = _two_views()
    n = len(uv)
    kw0 = dict(index=0, Tcw=np.eye(4, dtype=np.float32), uv=uv, desc=desc,
               valid=np.ones(n, bool), Xw=Xc)
    kw1 = dict(index=1, Tcw=T2, uv=uv2, desc=desc, valid=np.ones(n, bool), Xw=Xc2)
    js = jkf.KeyframeStore(min_gap=1)
    ts = tkf.KeyframeStore(min_gap=1, device="cpu")
    for kw in (kw0, kw1):
        js.maybe_add(jkf.Keyframe(**kw))
        ts.maybe_add(tkf.Keyframe(**kw))
    Xj, okj = js.triangulate_between(0, 1, FX, FY, CX, CY)
    Xt, okt = ts.triangulate_between(0, 1, FX, FY, CX, CY)
    np.testing.assert_array_equal(okt, okj)
    assert okt.sum() > 0.8 * n
    np.testing.assert_allclose(Xt[okt], Xj[okj], atol=1e-4, rtol=1e-5)


def _drifted_loop(scale=1.0):
    """test_loop_closing's drifted 8-frame trajectory back at keyframe 0;
    ``scale`` shrinks the current keyframe's measured points (monocular
    scale drift the Sim3 then measures)."""
    kf0 = make_kf(0, seed=42)
    M = 8
    step = _pose([0.0, 0.004, 0.0, 0.02, 0.0, 0.4])
    traj = [np.eye(4, dtype=np.float32)]
    for _ in range(M - 1):
        traj.append((step @ traj[-1]).astype(np.float32))
    traj = np.stack(traj)
    Twc_bad = np.linalg.inv(traj[-1])
    Xc = kf0.Xw / scale
    Xw_stored = ((Twc_bad[:3, :3] @ Xc.T).T + Twc_bad[:3, 3]).astype(np.float32)
    cur = dict(index=M - 1, Tcw=traj[-1], uv=kf0.uv, desc=kf0.desc, valid=kf0.valid,
               Xw=Xw_stored)
    return kf0, cur, traj


@pytest.mark.parametrize("fix_scale,scale", [(True, 1.0), (False, 1.2)])
def test_close_loop_matches_jax(fix_scale, scale):
    kf0, cur, traj = _drifted_loop(scale)
    js = jkf.KeyframeStore(min_gap=1)
    js.maybe_add(kf0)
    ts = tkf.KeyframeStore(min_gap=1, device="cpu")
    ts.maybe_add(_port_kf(kf0))
    key = jax.random.PRNGKey(0)
    info_j, info_t = {}, {}
    cj, nj = js.close_loop(key, jkf.Keyframe(**cur), 0, traj, [0], FX, FY, CX, CY,
                           fix_scale=fix_scale, info=info_j, max_corr_frac=10.0)
    ct, nt = ts.close_loop(JaxKeySampler({7: key}, 1, 1), (7, "sim3"), tkf.Keyframe(**cur), 0,
                           traj, [0], FX, FY, CX, CY, fix_scale=fix_scale, info=info_t,
                           max_corr_frac=10.0)
    assert abs(nt - nj) <= 2 and nt > 20
    np.testing.assert_allclose(ct, np.asarray(cj), atol=1e-4)
    assert info_t.keys() == info_j.keys() == {"scale", "row_scale"}
    assert abs(info_t["scale"] - info_j["scale"]) < 1e-4
    np.testing.assert_allclose(info_t["row_scale"], info_j["row_scale"], atol=1e-4)
    if not fix_scale:
        assert abs(info_t["scale"] - scale) < 1e-3
    assert np.linalg.norm(ct[-1][:3, 3]) < 0.5 * np.linalg.norm(traj[-1][:3, 3])
    # the production drift gate refuses this fixture's whole-path drift
    info_j, info_t = {}, {}
    cj, nj = js.close_loop(key, jkf.Keyframe(**cur), 0, traj, [0], FX, FY, CX, CY,
                           fix_scale=fix_scale, info=info_j)
    ct, nt = ts.close_loop(JaxKeySampler({7: key}, 1, 1), (7, "sim3"), tkf.Keyframe(**cur), 0,
                           traj, [0], FX, FY, CX, CY, fix_scale=fix_scale, info=info_t)
    assert nt == nj == 0
    # the input trajectory, with the scale drift distributed when not fixed
    np.testing.assert_allclose(ct, np.asarray(cj), atol=1e-4)
    if fix_scale:
        np.testing.assert_array_equal(ct, traj)
    assert abs(info_t["rejected_implausible"] - info_j["rejected_implausible"]) < 1e-3


def test_global_ba_matches_jax_and_beats_pose_graph_only():
    js, T_true = _make_gba_world()
    ts = _port_store(js)
    K = len(js.frames)
    err_before = np.mean([np.linalg.norm((kf.Tcw @ np.linalg.inv(T_true[k]))[:3, 3])
                          for k, kf in enumerate(ts.frames)])
    oj = js.global_ba(FX, FY, CX, CY, BF, loop_pair=(0, K - 1))
    ot = ts.global_ba(FX, FY, CX, CY, BF, loop_pair=(0, K - 1))
    assert oj is not None and ot is not None
    (Tj, sj), (Tt, st) = oj, ot
    assert st["n_landmarks"] == sj["n_landmarks"] > 100
    assert st["n_edges"] == sj["n_edges"]
    assert abs(st["chi2_init"] - sj["chi2_init"]) <= 1e-3 * sj["chi2_init"]
    # after: both at the float32 floor of this noise-free world, which moves
    # by ~0.3 % between two runs of the JAX package itself
    assert max(st["chi2"], sj["chi2"]) < 1e-4 * sj["chi2_init"]
    assert abs(st["chi2"] - sj["chi2"]) <= 1e-5 * sj["chi2_init"]
    np.testing.assert_allclose(np.stack(Tt), np.stack(Tj), atol=1e-3)
    for a, b in zip(ts.frames, js.frames):
        np.testing.assert_allclose(a.Tcw, b.Tcw, atol=1e-3)
        np.testing.assert_allclose(a.Xw, b.Xw, atol=1e-3, rtol=1e-4)
    err_after = np.mean([np.linalg.norm((Tt[k] @ np.linalg.inv(T_true[k]))[:3, 3])
                         for k in range(K)])
    assert err_after < 0.5 * err_before, (err_before, err_after)


def test_global_ba_rejects_degenerate_store():
    js, _ = _make_gba_world(K=2)
    ts = _port_store(js)
    before = [kf.Tcw.copy() for kf in ts.frames]
    assert js.global_ba(FX, FY, CX, CY, BF) is None
    assert ts.global_ba(FX, FY, CX, CY, BF) is None
    for a, b in zip(ts.frames, before):
        np.testing.assert_array_equal(a.Tcw, b)


def test_loop_candidate_consistency_gate():
    """The sequence of test_system_state.test_loop_candidate_consistency_gate
    through the port's gate."""
    s = TSystem(DEFAULT_CONFIG, keyframe_gap=5, device="cpu")
    seq = [(10, False), (None, False), (50, False), (90, False), (12, False), (14, False),
           (17, True), (18, True)]
    assert [s._note_loop_candidate(c) for c, _ in seq] == [want for _, want in seq]
    s._loop_history.clear()                 # what an accepted closure does
    assert not s._note_loop_candidate(19)
    s1 = TSystem(DEFAULT_CONFIG, loop_consistency=1, device="cpu")
    assert s1._note_loop_candidate(3)
    assert not s1._note_loop_candidate(None)


def test_keyframe_store_default_device_is_the_card():
    """Without device=, the store runs on the card; with no card it raises."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device exists: the default has a card to run on")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tkf.KeyframeStore()
