"""Parity of the port's keyframe path with the JAX package (CPU): the stereo
Gauss-Newton, TrackLocalMap (``local_map_refine``), the fuse scan, the
keyframe store's scores, culling and eviction, the DLT and RANSAC PnP.

Tolerances, with their reasons:
* local-map and stereo-GN poses atol 1e-4: float32 Gauss-Newton with sums
  in another order; the matches, duplicate flags, in-view flags and indices
  are integers from exact Hamming distances and must be equal;
* PnP poses atol 1e-3: both packages score the same replayed hypotheses,
  but each DLT is an SVD of a float32 system whose nullspace the two
  LAPACK paths round differently; inlier counts +-2 (points within
  rounding of the reprojection gate).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from multimot_track_tpu import config as jconfig
from multimot_track_tpu.geometry import se3 as jse3
from multimot_track_tpu.pipeline import keyframes as jkf
from multimot_track_tpu.solvers import pnp as jpnp
from multimot_track_tpu.solvers import ransac as jransac
from multimot_track_tpu_torch import config as tconfig
from multimot_track_tpu_torch.pipeline import keyframes as tkf
from multimot_track_tpu_torch.solvers import pnp as tpnp
from multimot_track_tpu_torch.solvers import ransac as transac
from test_torch_bow import jax_vocab_seed
from test_torch_ransac import JaxKeySampler

torch.set_num_threads(1)

FX, FY, CX, CY, W, H = 460.0, 460.0, 320.0, 192.0, 640, 384
BF = FX * 0.5


def _t(a):
    return torch.from_numpy(np.array(a))


def _pose(xi):
    return np.asarray(jse3.exp_se3(jnp.asarray(np.asarray(xi, np.float32))))


def _points(rng, n, T_cw, zmin=4.0, zmax=30.0):
    """n world points seen by camera T_cw at uniform pixels and depths."""
    uv = np.stack([rng.uniform(5, W - 5, n), rng.uniform(5, H - 5, n)], -1)
    z = rng.uniform(zmin, zmax, n)
    Xc = np.stack([(uv[:, 0] - CX) * z / FX, (uv[:, 1] - CY) * z / FY, z], -1)
    Twc = np.linalg.inv(T_cw)
    return (Xc @ Twc[:3, :3].T + Twc[:3, 3]).astype(np.float32)


def _project(T, Xw):
    Xc = Xw @ T[:3, :3].T + T[:3, 3]
    return np.stack([FX * Xc[:, 0] / Xc[:, 2] + CX, FY * Xc[:, 1] / Xc[:, 2] + CY], -1), Xc[:, 2]


def _flip(rng, desc, max_flips=10):
    d = desc.copy()
    for i in range(len(d)):
        d[i, rng.choice(256, size=rng.integers(0, max_flips), replace=False)] *= -1
    return d


@pytest.fixture(scope="module")
def local_map_scene():
    """A 3-keyframe local map (250 landmarks, each stored three times with
    fresh position noise and bit flips so that copies of one landmark
    compete for one keypoint, plus 150 unrelated points) and a current
    frame observing the 250 landmarks plus 50 clutter keypoints."""
    rng = np.random.default_rng(0)
    T_true = _pose([0.01, -0.02, 0.005, 0.1, -0.05, 1.2])
    base = _points(rng, 250, T_true)
    base_desc = np.where(rng.uniform(size=(250, 256)) < 0.5, 1, -1).astype(np.int8)
    Xw = np.concatenate([base + rng.normal(0, 0.02, base.shape) for _ in range(3)]
                        + [_points(rng, 150, T_true)]).astype(np.float32)
    desc_m = np.concatenate([_flip(rng, base_desc) for _ in range(3)]
                            + [np.where(rng.uniform(size=(150, 256)) < 0.5, 1, -1)]
                            ).astype(np.int8)
    valid_m = rng.uniform(size=Xw.shape[0]) < 0.95
    uv_true, z_true = _project(T_true, base)
    uv_cur = np.concatenate([uv_true + rng.normal(0, 0.5, uv_true.shape),
                             np.stack([rng.uniform(0, W, 50), rng.uniform(0, H, 50)], -1)])
    z_cur = np.concatenate([z_true * (1 + rng.normal(0, 0.01, 250)), rng.uniform(3, 40, 50)])
    desc_cur = np.concatenate([_flip(rng, base_desc),
                               np.where(rng.uniform(size=(50, 256)) < 0.5, 1, -1)]).astype(np.int8)
    valid_cur = rng.uniform(size=300) < 0.95
    T_init = (_pose([0.002, 0.001, -0.002, 0.05, 0.03, -0.08]) @ T_true).astype(np.float32)
    return (T_init, Xw, desc_m, valid_m, uv_cur.astype(np.float32), desc_cur, valid_cur,
            z_cur.astype(np.float32)), T_true


def test_gn_refine_stereo_matches_jax(local_map_scene):
    (T_init, Xw, *_), T_true = local_map_scene
    rng = np.random.default_rng(1)
    uv, z = _project(T_true, Xw)
    uv = (uv + rng.normal(0, 0.3, uv.shape)).astype(np.float32)
    disp = (BF / z).astype(np.float32)
    w = (rng.uniform(size=len(Xw)) < 0.9).astype(np.float32)
    w_disp = (1.0 / (1.0 + (z / 15.0) ** 2)).astype(np.float32)
    args = (T_init, Xw, uv, disp, w, w_disp)
    Tj = np.asarray(jransac._gn_refine_stereo(*map(jnp.asarray, args), 8, FX, FY, CX, CY, BF))
    Tt = transac._gn_refine_stereo(*map(_t, args), 8, FX, FY, CX, CY, BF).numpy()
    np.testing.assert_allclose(Tt, Tj, atol=1e-4)
    np.testing.assert_allclose(Tt, T_true, atol=2e-2)


def test_local_map_refine_matches_jax(local_map_scene):
    args, T_true = local_map_scene
    Tj, nj, mj = jkf.local_map_refine(*map(jnp.asarray, args), FX, FY, CX, CY, W, H, BF,
                                      radius=12.0, thresh=3.0)
    Tt, nt, mt = tkf.local_map_refine(*map(_t, args), FX, FY, CX, CY, W, H, BF,
                                      radius=12.0, thresh=3.0)
    assert int(mt) == int(mj) and int(mt) > 150
    assert abs(int(nt) - int(nj)) <= 2
    np.testing.assert_allclose(Tt.numpy(), np.asarray(Tj), atol=1e-4)
    # the refinement pulled the 10 cm init onto the landmarks
    assert np.abs(Tt.numpy() - T_true)[:3, 3].max() < 0.03


@pytest.fixture(scope="module")
def fuse_scene():
    """A new keyframe (N = 300) and L = 3 previous keyframes, each holding
    copies of some of the new keyframe's landmarks (duplicates to fuse),
    points out of view or behind, and unrelated points."""
    rng = np.random.default_rng(2)
    T_new = _pose([0.0, 0.01, 0.0, 0.0, 0.0, 2.0])
    N = 300
    X_new = _points(rng, N, T_new)
    d_new = np.where(rng.uniform(size=(N, 256)) < 0.5, 1, -1).astype(np.int8)
    uv_new, _ = _project(T_new, X_new)
    prev_X, prev_d, prev_v = [], [], []
    for l in range(3):
        take = rng.permutation(N)[: 120 + 30 * l]
        X = _points(rng, N, T_new, zmin=-5.0, zmax=60.0)        # some behind the camera
        X[: len(take)] = X_new[take] + rng.normal(0, 0.01 * (l + 1), (len(take), 3))
        d = np.where(rng.uniform(size=(N, 256)) < 0.5, 1, -1).astype(np.int8)
        d[: len(take)] = _flip(rng, d_new[take], max_flips=30)
        prev_X.append(X)
        prev_d.append(d)
        prev_v.append(rng.uniform(size=N) < 0.9)
    return (T_new, d_new, uv_new.astype(np.float32), rng.uniform(size=N) < 0.95, X_new,
            np.stack(prev_X).astype(np.float32), np.stack(prev_d), np.stack(prev_v))


def test_fuse_scan_matches_jax(fuse_scene):
    pj = np.asarray(jkf._fuse_scan(*map(jnp.asarray, fuse_scene), FX, FY, CX, CY, W, H,
                                   6.0, 0.02))
    pt = tkf._fuse_scan(*map(_t, fuse_scene), FX, FY, CX, CY, W, H, 6.0, 0.02)
    assert pt.dtype == torch.int32
    np.testing.assert_array_equal(pt.numpy(), pj)
    assert pj[0].sum() > 100 and (pj[1] == 0).any()


def _store_pair(rng, n_kf, N=200, capacity=64, gap=1, pool_size=60, after_add=None,
                vocab_seed=None):
    """The same keyframes in a JAX store and a port store; descriptors from
    a shared pool so neighbours are covisible.  ``after_add(js, ts)`` runs
    after each keyframe; ``vocab_seed`` goes to the port store."""
    pool = np.where(rng.uniform(size=(pool_size, 256)) < 0.5, 1, -1).astype(np.int8)
    js, ts = jkf.KeyframeStore(capacity=capacity, min_gap=gap), \
        tkf.KeyframeStore(capacity=capacity, min_gap=gap, device="cpu", vocab_seed=vocab_seed)
    for i in range(n_kf):
        T = _pose([0.0, 0.0, 0.0, 0.0, 0.0, 0.5 * i])
        desc = _flip(rng, pool[(np.arange(N) + 7 * i) % pool_size], max_flips=20)
        kw = dict(index=3 * i if i % 4 else 3 * i + 1, Tcw=T.astype(np.float32),
                  uv=rng.uniform(0, W, (N, 2)).astype(np.float32), desc=desc,
                  valid=rng.uniform(size=N) < 0.9, Xw=_points(rng, N, T))
        js.maybe_add(jkf.Keyframe(**{k: np.copy(v) for k, v in kw.items()}))
        ts.maybe_add(tkf.Keyframe(**{k: np.copy(v) for k, v in kw.items()}))
        if after_add is not None:
            after_add(js, ts)
    return js, ts, pool


def test_store_scores_culling_and_eviction_match_jax():
    rng = np.random.default_rng(5)
    js, ts, pool = _store_pair(rng, 9)
    q = _flip(rng, pool[np.arange(200) % 60], max_flips=20)
    vq = rng.uniform(size=200) < 0.9
    sj = js.similarity_scores(jnp.asarray(q), jnp.asarray(vq), exclude_last=0)
    st = ts.similarity_scores(_t(q), _t(vq), exclude_last=0)
    np.testing.assert_array_equal(st, sj)
    assert st.max() > 0
    assert ts.detect_loop(_t(q), _t(vq), min_matches=1) == \
        js.detect_loop(jnp.asarray(q), jnp.asarray(vq), min_matches=1)
    assert ts.covisibility(2, 3) == js.covisibility(2, 3)
    assert ts.cull_redundant(overlap=0.3) == js.cull_redundant(overlap=0.3)
    assert [k.index for k in ts.frames] == [k.index for k in js.frames]
    # skeleton eviction at capacity
    js2, ts2, _ = _store_pair(np.random.default_rng(6), 14, capacity=8)
    assert len(ts2.frames) == 8
    assert [k.index for k in ts2.frames] == [k.index for k in js2.frames]


def test_store_at_the_default_capacity_evicts_and_retrieves_as_jax():
    """130 keyframes into stores of the default ``kf_capacity`` (96): the
    same skeleton evictions in the same order and the same held indices
    after every add; then, past ``bow_threshold``, the same loop candidate
    and scores for a revisit of the first keyframes' descriptors (the
    vocabulary's k-means seeds replayed from the JAX draw)."""
    cap = tconfig.DEFAULT_CONFIG.backend.kf_capacity
    assert cap == jconfig.DEFAULT_CONFIG.backend.kf_capacity == 96
    held, evicted = {"jax": [], "port": []}, {"jax": [], "port": []}

    def after_add(js, ts):
        for name, st in (("jax", js), ("port", ts)):
            now = [k.index for k in st.frames]
            evicted[name] += [i for i in held[name] if i not in now]
            held[name] = now
        assert held["port"] == held["jax"]

    rng = np.random.default_rng(9)
    js, ts, pool = _store_pair(rng, 130, capacity=cap, after_add=after_add,
                               vocab_seed=jax_vocab_seed)
    assert evicted["port"] == evicted["jax"] and len(evicted["port"]) == 130 - cap
    assert len(ts.frames) == cap and ts.frames[0].index == 1     # the skeleton keeps the first
    assert len(ts.frames) > ts.bow_threshold == js.bow_threshold
    q = _flip(rng, pool[np.arange(200) % 60], max_flips=20)
    vq = rng.uniform(size=200) < 0.9
    st = ts.similarity_scores(_t(q), _t(vq))
    np.testing.assert_array_equal(st, js.similarity_scores(jnp.asarray(q), jnp.asarray(vq)))
    cand = ts.detect_loop(_t(q), _t(vq))
    assert cand is not None and st.max() >= 40
    assert cand == js.detect_loop(jnp.asarray(q), jnp.asarray(vq))


def test_store_local_map_and_fuse_and_cull_match_jax():
    rng = np.random.default_rng(7)
    js, ts, _ = _store_pair(rng, 6)
    for s in (js, ts):
        s.frames[1].live[:50] = False
    Xj, dj, vj = js.local_map(n_kf=3, max_depth=20.0)
    Xt, dt, vt = ts.local_map(n_kf=3, max_depth=20.0)
    np.testing.assert_array_equal(vt.numpy(), np.asarray(vj))
    np.testing.assert_array_equal(dt.numpy(), np.asarray(dj))
    np.testing.assert_array_equal(Xt.numpy(), np.asarray(Xj))
    kw = dict(fx=FX, fy=FY, cx=CX, cy=CY, width=W, height=H, radius=40.0, rel3d=5.0)
    assert ts.fuse_and_cull(**kw) == js.fuse_and_cull(**kw)
    for a, b in zip(ts.frames, js.frames):
        for f in ("seen", "found", "live", "bad"):
            np.testing.assert_array_equal(getattr(a, f), getattr(b, f), err_msg=f)
    assert ts.n_fuse_scans == 1 and ts.n_live_points() == js.n_live_points()


def test_similarity_scores_refuse_bow_scale():
    """Past ``bow_threshold`` a store of fewer training descriptors (5 x 16)
    than vocabulary words (256) cannot seed k-means: both packages refuse.
    ``tests/test_torch_bow.py`` holds the BoW path itself to the JAX package."""
    rng = np.random.default_rng(8)
    js, ts, _ = _store_pair(rng, 5, N=16)
    js.bow_threshold = ts.bow_threshold = 4
    with pytest.raises(ValueError):
        js.similarity_scores(jnp.asarray(js.frames[0].desc), jnp.asarray(js.frames[0].valid))
    with pytest.raises(ValueError, match="vocabulary seeds"):
        ts.similarity_scores(_t(ts.frames[0].desc), _t(ts.frames[0].valid))


def test_dlt_pose_matches_jax():
    rng = np.random.default_rng(3)
    T_true = _pose([0.02, -0.01, 0.03, 0.3, -0.1, 0.8])
    Xw = np.stack([_points(rng, 10, T_true) for _ in range(16)])
    uv = np.stack([_project(T_true, x)[0] for x in Xw]).astype(np.float32)
    Tj = np.asarray(jpnp.dlt_pose(jnp.asarray(Xw), jnp.asarray(uv), FX, FY, CX, CY))
    Tt = tpnp.dlt_pose(_t(Xw), _t(uv), FX, FY, CX, CY).numpy()
    np.testing.assert_allclose(Tt, Tj, atol=1e-3)
    np.testing.assert_allclose(Tt, np.broadcast_to(T_true, Tt.shape), atol=1e-2)


@pytest.mark.parametrize("seed", [4, 9])
def test_ransac_pnp_with_replayed_samples_matches_jax(seed):
    rng = np.random.default_rng(seed)
    T_true = _pose([0.01, 0.02, -0.01, -0.2, 0.1, 1.5])
    N = 400
    Xw = _points(rng, N, T_true)
    uv, _ = _project(T_true, Xw)
    uv = uv + rng.normal(0, 0.5, uv.shape)
    out = rng.uniform(size=N) < 0.3
    uv[out] = np.stack([rng.uniform(0, W, out.sum()), rng.uniform(0, H, out.sum())], -1)
    uv = uv.astype(np.float32)
    valid = rng.uniform(size=N) < 0.9
    key = jax.random.PRNGKey(seed)
    rj = jpnp.ransac_pnp(key, jnp.asarray(Xw), jnp.asarray(uv), jnp.asarray(valid),
                         FX, FY, CX, CY)
    sampler = JaxKeySampler({17: key}, 1, 1)
    rt = tpnp.ransac_pnp(_t(Xw), _t(uv), _t(valid), FX, FY, CX, CY,
                         sampler=sampler, site=(17, "pnp"))
    np.testing.assert_allclose(rt.T.numpy(), np.asarray(rj.T), atol=1e-3)
    assert abs(int(rt.n_inliers) - int(rj.n_inliers)) <= 2
    np.testing.assert_allclose(rt.T.numpy(), T_true, atol=2e-2)


def test_multinomial_sampler_draws_min_set():
    g = torch.Generator().manual_seed(0)
    p = torch.zeros(1, 40)
    p[0, 10:20] = 0.1
    idx = transac.MultinomialSampler(g)(p, 50, [(0, "pnp")], k=10)
    assert idx.shape == (1, 50, 10) and int(idx.min()) >= 10 and int(idx.max()) < 20
