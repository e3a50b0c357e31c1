"""The window path's modules: the PyTorch port against the JAX package (CPU).

The same seeded inputs go through both packages: ``bilinear_sample``,
``refine_position``, ``se3.adjoint``, the track builders of
``frontend/tracks``, the window solvers and the two window refiners.

Tolerances: bilinear gathers exact and the blend to 1e-6; refine_position
uv and score 1e-5; the adjoint 1e-6; tracks: alive identical, uv 1e-4 plus
1e-6 relative (a float32 ulp is 6e-5 at 500 px, and the sub-pixel
parabola of chain_tracks_zncc moves a position by a few ulps when the
scores round apart; ``build_window_tracks`` identical given the JAX descriptors, >= 99 % of
tracks end to end: the IC-angle moment sums round apart, see
test_torch_orb); ``solve_window_ba`` poses 1e-4, inverse depths and chi2
rtol 1e-3; ``refine_window`` J rtol 1e-4 against ``jax.jacfwd``, poses and
motions 1e-4; the refiners on wire tensors poses 1e-3, ``n_live`` equal.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from scipy import ndimage

from multimot_track_tpu import config as jconfig
from multimot_track_tpu.frontend import fast as jfast
from multimot_track_tpu.frontend import tracks as jtracks
from multimot_track_tpu.geometry import camera as jcam
from multimot_track_tpu.geometry import se3 as jse3
from multimot_track_tpu.io.synth import make_multimover_frames, synth_camera_config
from multimot_track_tpu.ops import photometric as jphot
from multimot_track_tpu.ops import wire as jwire
from multimot_track_tpu.pipeline import window_refine as jwr
from multimot_track_tpu.solvers import multi_window_ba as jmwba
from multimot_track_tpu.solvers import window_ba as jwba
from multimot_track_tpu_torch import config as tconfig
from multimot_track_tpu_torch.frontend import orb as torb
from multimot_track_tpu_torch.frontend import tracks as ttracks
from multimot_track_tpu_torch.geometry import camera as tcam
from multimot_track_tpu_torch.geometry import se3 as tse3
from multimot_track_tpu_torch.io.synth import synth_camera_config as t_synth_cam
from multimot_track_tpu_torch.ops import photometric as tphot
from multimot_track_tpu_torch.ops import wire as twire
from multimot_track_tpu_torch.pipeline import window_refine as twr
from multimot_track_tpu_torch.solvers import multi_window_ba as tmwba
from multimot_track_tpu_torch.solvers import window_ba as twba
import test_multi_window
import test_window_ba
from test_torch_tracker import small_config
from torch_seeding import seeded

torch.set_num_threads(1)


def t(a):
    return torch.from_numpy(np.array(a))


def n(x):
    return x.numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


@pytest.fixture(scope="module")
def frames():
    return make_multimover_frames(n_frames=5)


# ---------------------------------------------------------------- primitives

@pytest.mark.parametrize("kind", ["f32", "f32x2", "u8", "i16x2"])
def test_bilinear_sample_matches_jax(kind):
    rng = np.random.default_rng(3)
    H, W = 37, 53
    shape = (H, W, 2) if kind.endswith("x2") else (H, W)
    if kind.startswith("f32"):
        img = rng.normal(0, 50, shape).astype(np.float32)
    elif kind == "u8":
        img = rng.integers(0, 256, shape).astype(np.uint8)
    else:
        img = rng.integers(-4000, 4000, shape).astype(np.int16)
    border = [[0, 0], [W - 1.001, H - 1.001], [W - 1, H - 1], [W + 5, -2], [-1, H],
              [W - 1.0005, 3.5], [2.5, H - 1.001], [0, H - 1.001]]
    uv = np.concatenate([rng.uniform([-3, -3], [W + 3, H + 3], (202, 2)), border])
    uv = uv.astype(np.float32).reshape(70, 3, 2)
    out_t = tcam.bilinear_sample(t(img), t(uv))
    out_j = np.asarray(jcam.bilinear_sample(jnp.asarray(img), jnp.asarray(uv)))
    assert out_t.dtype == torch.float32 and out_j.dtype == np.float32
    assert out_t.shape == out_j.shape == uv.shape[:-1] + shape[2:]
    np.testing.assert_allclose(n(out_t), out_j, rtol=1e-6, atol=1e-6)
    # at integer positions the blend is the gathered pixel itself
    iy, ix = rng.integers(0, H - 1, 40), rng.integers(0, W - 1, 40)
    at = np.stack([ix, iy], -1).astype(np.float32)
    np.testing.assert_array_equal(n(tcam.bilinear_sample(t(img), t(at))),
                                  img[iy, ix].astype(np.float32))
    np.testing.assert_array_equal(
        np.asarray(jcam.bilinear_sample(jnp.asarray(img), jnp.asarray(at))),
        img[iy, ix].astype(np.float32))


def test_refine_position_matches_jax():
    rng = np.random.default_rng(4)
    H, W = 60, 80
    img0 = ndimage.gaussian_filter(rng.normal(0, 60, (H, W)), 1.5).astype(np.float32) + 128
    img1 = ndimage.shift(img0, (-0.7, 1.3), order=3, mode="nearest").astype(np.float32)
    # near the image border the clamped support makes the candidate patches
    # of neighbouring offsets equal, and their scores tie up to rounding:
    # keep the predictions s + 3 px inside
    uv = rng.uniform(6, [W - 6, H - 6], (80, 2)).astype(np.float32)
    pred = (uv + np.float32([1.3, -0.7]) + rng.normal(0, 0.8, uv.shape)).astype(np.float32)
    ref = np.asarray(jphot.extract_patches(jnp.asarray(img0), jnp.asarray(uv), 2))
    for s in (1, 2):
        uv_j, sc_j = jphot.refine_position(jnp.asarray(img1), jnp.asarray(pred),
                                           jnp.asarray(ref), 2, search_radius=s)
        uv_t, sc_t = tphot.refine_position(t(img1), t(pred), t(ref), 2, search_radius=s)
        np.testing.assert_allclose(n(uv_t), np.asarray(uv_j), atol=1e-5)
        np.testing.assert_allclose(n(sc_t), np.asarray(sc_j), atol=1e-5)
    # the re-centering recovers the shift where the image has texture
    inner = np.all((uv > 6) & (uv < [W - 6, H - 6]), -1)
    assert np.median(np.abs(n(uv_t) - uv - [1.3, -0.7])[inner]) < 0.2


def test_adjoint_matches_jax():
    rng = np.random.default_rng(5)
    xi = rng.normal(0, [0.3, 0.3, 0.3, 2.0, 2.0, 2.0], (7, 6)).astype(np.float32)
    T = np.asarray(jse3.exp_se3(jnp.asarray(xi)))
    Ad_t = tse3.adjoint(t(T))
    np.testing.assert_allclose(n(Ad_t), np.asarray(jse3.adjoint(jnp.asarray(T))), atol=1e-6)
    # T exp(eta) T^-1 = exp(Ad(T) eta)
    eta = t(rng.normal(0, 0.05, (7, 6)).astype(np.float32))
    lhs = t(T) @ tse3.exp_se3(eta) @ tse3.inverse(t(T))
    rhs = tse3.exp_se3((Ad_t @ eta[..., None])[..., 0])
    np.testing.assert_allclose(n(lhs), n(rhs), atol=1e-4)


# -------------------------------------------------------------------- tracks

def _window_inputs(frames, F=3):
    fr = frames[:F]
    grays = np.stack([fd.gray for fd in fr]).astype(np.float32)
    flows = np.stack([fd.flow for fd in fr[:-1]]).astype(np.float32)
    sems = np.stack([fd.sem_mask for fd in fr]).astype(np.int32)
    depth0 = np.asarray(jcam.disparity_png_to_depth(jnp.asarray(fr[0].depth_raw),
                                                    synth_camera_config().bf))
    kp = jfast.detect_pyramid(jnp.asarray(grays[0]), n_levels=4, n_total=1024)
    return grays, flows, sems, depth0, np.asarray(kp.uv), np.asarray(kp.valid)


def _same_tracks(tr_t, tr_j, atol=1e-4, rtol=1e-6):
    np.testing.assert_array_equal(n(tr_t.alive), np.asarray(tr_j.alive))
    np.testing.assert_allclose(n(tr_t.uv), np.asarray(tr_j.uv), atol=atol, rtol=rtol)


def test_chain_tracks_match_jax(frames):
    grays, flows, sems, _, uv0, v0 = _window_inputs(frames)
    tr_j = jtracks.chain_tracks(jnp.asarray(uv0), jnp.asarray(v0), jnp.asarray(flows),
                                jnp.asarray(sems))
    tr_t = ttracks.chain_tracks(t(uv0), t(v0), t(flows), t(sems))
    _same_tracks(tr_t, tr_j)
    assert 0 < int(tr_t.alive[-1].sum()) < int(tr_t.alive[0].sum())


def test_chain_tracks_zncc_match_jax(frames):
    grays, flows, sems, _, uv0, v0 = _window_inputs(frames)
    tr_j = jtracks.chain_tracks_zncc(jnp.asarray(uv0), jnp.asarray(v0), jnp.asarray(flows),
                                     jnp.asarray(grays), jnp.asarray(sems))
    tr_t = ttracks.chain_tracks_zncc(t(uv0), t(v0), t(flows), t(grays), t(sems))
    _same_tracks(tr_t, tr_j)
    assert int(tr_t.alive[-1].sum()) > 0


def test_link_detections_match_jax():
    rng = np.random.default_rng(6)
    F, N = 4, 300
    kp_uv = rng.uniform(0, 600, (F, N, 2)).astype(np.float32)
    kp_valid = rng.uniform(size=(F, N)) < 0.9
    idx = rng.integers(0, N, (F - 1, N)).astype(np.int32)
    ok = rng.uniform(size=(F - 1, N)) < 0.8
    tr_j = jtracks.link_detections(*(jnp.asarray(a) for a in (kp_uv, kp_valid, idx, ok)))
    tr_t = ttracks.link_detections(t(kp_uv), t(kp_valid), t(idx), t(ok))
    _same_tracks(tr_t, tr_j, atol=0, rtol=0)


def _build_tracks(frames, F=3):
    grays, flows, sems, depth0, _, _ = _window_inputs(frames, F)
    tr_j, z_j = jtracks.build_window_tracks(grays, flows, depth0, sems)
    return (grays, flows, sems, depth0), tr_j, np.asarray(z_j)


def test_build_window_tracks_given_jax_descriptors(frames, monkeypatch):
    """With the JAX descriptors the tracks are identical: the matching and
    linking themselves are exact."""
    from multimot_track_tpu.frontend import orb as jorb

    (grays, flows, sems, depth0), tr_j, z_j = _build_tracks(frames)

    def jax_describe(img, uv):
        d, a = jorb.describe(jnp.asarray(n(img)), jnp.asarray(n(uv)))
        return t(d), t(a)

    monkeypatch.setattr(torb, "describe", jax_describe)
    tr_t, z_t = ttracks.build_window_tracks(t(grays), t(flows), t(depth0), t(sems),
                                            backend="torch")
    np.testing.assert_array_equal(n(z_t), z_j)
    _same_tracks(tr_t, tr_j, atol=0, rtol=0)
    assert int(tr_t.alive[-1].sum()) > 50


def test_build_window_tracks_end_to_end(frames):
    (grays, flows, sems, depth0), tr_j, z_j = _build_tracks(frames)
    tr_t, z_t = ttracks.build_window_tracks(t(grays), t(flows), t(depth0), t(sems))
    np.testing.assert_array_equal(n(z_t), z_j)
    alive_t, alive_j = n(tr_t.alive), np.asarray(tr_j.alive)
    same = (alive_t == alive_j).all(0) & (
        (np.abs(n(tr_t.uv) - np.asarray(tr_j.uv)).max(-1) <= 1e-4) | ~alive_j).all(0)
    assert same.mean() >= 0.99, same.mean()


# ------------------------------------------------------------------- solvers

def make_solver_window():
    return seeded(test_window_ba, 21, test_window_ba.make_window)


@pytest.fixture(scope="module")
def window():
    return make_solver_window()


@pytest.mark.parametrize("odo", [0.0, 2500.0])
def test_solve_window_ba_matches_jax(window, odo):
    """Near convergence the two float32 objectives round apart by ~1e-5
    relative, so an LM step that changes the cost by less than that is
    taken by one package and not the other; on this window that moves a
    pose by < 3e-5."""
    uv, alive, z_meas, init, _, _ = window
    params = dict(iters=30, odo_prior_weight=odo)
    c = test_window_ba.CAM
    res_j = jwba.solve_window_ba(jnp.asarray(init), jnp.asarray(uv), jnp.asarray(alive),
                                 jnp.asarray(z_meas), c.fx, c.fy, c.cx, c.cy,
                                 params=jwba.WindowBAParams(**params))
    res_t = twba.solve_window_ba(t(init), t(uv), t(alive), t(z_meas), c.fx, c.fy, c.cx, c.cy,
                                 params=twba.WindowBAParams(**params))
    np.testing.assert_allclose(n(res_t.poses), np.asarray(res_j.poses), atol=1e-4)
    np.testing.assert_allclose(n(res_t.inv_depth), np.asarray(res_j.inv_depth), rtol=1e-3)
    np.testing.assert_allclose(float(res_t.chi2), float(res_j.chi2), rtol=1e-3)
    # the solve moved the poses
    assert np.abs(n(res_t.poses) - init).max() > 1e-3


MW_PARAMS = dict(iters=6, w_smooth=100.0, w_odo=4e4, w_motion_prior=800.0, obj_init_gate_px=1.5)


@pytest.fixture(scope="module")
def multiwindow():
    return make_multiwindow()


def make_multiwindow():
    """A 4-frame window with two object slots (the second valid on two of
    the three pairs), perturbed online poses and motions, and 10 % of the
    object points pushed off by 5 px (the gate drops them)."""
    rng = np.random.default_rng(52)
    F, K = 4, 2
    poses, H_stack, st_uv, st_flow, st_z, ob_uv, ob_flow, ob_z = seeded(
        test_multi_window, 51, test_multi_window.synth_multiwindow, F, K)
    p_init = [poses[0]]
    for f in range(1, F):
        d = np.concatenate([rng.normal(0, 0.002, 3), rng.normal(0, 0.03, 3)]).astype(np.float32)
        p_init.append(np.asarray(jse3.exp_se3(jnp.asarray(d))) @ poses[f])
    h_init = np.empty_like(H_stack)
    for f in range(F - 1):
        for k in range(K):
            d = np.concatenate([rng.normal(0, 0.002, 3),
                                rng.normal(0, 0.02, 3)]).astype(np.float32)
            h_init[f, k] = np.asarray(jse3.exp_se3(jnp.asarray(d))) @ H_stack[f, k]
    ob_flow = ob_flow.copy()
    bad = rng.uniform(size=ob_flow.shape[:-1]) < 0.1
    ob_flow[bad] += 5.0
    m_valid = np.ones((F - 1, K), bool)
    m_valid[1, 1] = False
    st_w = (rng.uniform(size=st_z.shape) < 0.9) / (1.0 + (st_z / 15.0) ** 2)
    return (np.stack(p_init).astype(np.float32), h_init.astype(np.float32), m_valid,
            st_uv, st_flow, st_z, st_w.astype(np.float32), ob_uv, ob_flow.astype(np.float32),
            ob_z, np.ones(ob_uv.shape[:3], bool))


def _jax_residuals(v, args, p):
    """jax transcription of ``multi_window_ba.refine_window``'s residuals
    (after its object gate); pinned to the reference by its chi2 below."""
    (poses_init, motions_init, motions_valid, st_uv, st_flow, st_depth, st_valid,
     ob_uv, ob_flow, ob_depth, ob_valid) = args
    c = test_multi_window.CAM
    F, K = poses_init.shape[0], motions_init.shape[1]
    Z_odo = jnp.einsum("fij,fjk->fik", poses_init[1:], jse3.inverse(poses_init[:-1]))
    xi = v[: 6 * (F - 1)].reshape(F - 1, 6)
    eta = v[6 * (F - 1):].reshape(F - 1, K, 6)
    T = jnp.concatenate([poses_init[:1], jse3.exp_se3(xi) @ poses_init[1:]], axis=0)
    H = jse3.exp_se3(eta) @ motions_init
    Twl, Tc = jse3.inverse(T[:-1]), T[1:]

    def rw(r, w, mask):
        wi = jax.lax.stop_gradient(
            jnp.minimum(1.0, p.huber_px / jnp.sqrt(jnp.sum(r * r, -1) + 1e-12)))
        return (mask.astype(r.dtype) * jnp.sqrt(w * wi))[..., None] * r

    Xl = jcam.backproject(st_uv, st_depth, c.fx, c.fy, c.cx, c.cy)
    Xw = jnp.einsum("fij,fnj->fni", Twl[:, :3, :3], Xl) + Twl[:, None, :3, 3]
    y = jnp.einsum("fij,fnj->fni", Tc[:, :3, :3], Xw) + Tc[:, None, :3, 3]
    out_s = rw((st_uv + st_flow) - jcam.project(y, c.fx, c.fy, c.cx, c.cy), p.w_static,
               st_valid).reshape(-1)
    Xo = jcam.backproject(ob_uv, ob_depth, c.fx, c.fy, c.cx, c.cy)
    Xw_o = jnp.einsum("fij,fkmj->fkmi", Twl[:, :3, :3], Xo) + Twl[:, None, None, :3, 3]
    Xh = jnp.einsum("fkij,fkmj->fkmi", H[..., :3, :3], Xw_o) + H[..., None, :3, 3]
    yo = jnp.einsum("fij,fkmj->fkmi", Tc[:, :3, :3], Xh) + Tc[:, None, None, :3, 3]
    r_o = (ob_uv + ob_flow) - jcam.project(yo, c.fx, c.fy, c.cx, c.cy)
    w_o = ob_valid.astype(r_o.dtype) * motions_valid[..., None].astype(r_o.dtype)
    out_o = rw(r_o, p.w_object, w_o).reshape(-1)
    r_m = jse3.log_se3(jnp.einsum("fkij,fkjl->fkil", jse3.inverse(H[:-1]), H[1:]))
    w_m = (motions_valid[:-1] & motions_valid[1:]).astype(jnp.float32)
    out_m = (jnp.sqrt(p.w_smooth) * w_m[..., None] * r_m).reshape(-1)
    M_odo = jnp.einsum("fij,fjk,fkl->fil", T[1:], jse3.inverse(T[:-1]), jse3.inverse(Z_odo))
    out_odo = (jnp.sqrt(p.w_odo) * jse3.log_se3(M_odo)).reshape(-1)
    out_mp = (jnp.sqrt(p.w_motion_prior) * motions_valid[..., None].astype(eta.dtype)
              * eta).reshape(-1)
    return jnp.concatenate([out_s, out_o, out_m, out_odo, out_mp])


def _jax_gate(args, p):
    """jax transcription of refine_window's one-shot object gate."""
    a = [jnp.asarray(x) for x in args]
    poses_init, motions_init, ob_uv, ob_flow, ob_depth = a[0], a[1], a[7], a[8], a[9]
    c = test_multi_window.CAM
    Twl0, Tc0 = jse3.inverse(poses_init[:-1]), poses_init[1:]
    Xo0 = jcam.backproject(ob_uv, ob_depth, c.fx, c.fy, c.cx, c.cy)
    Xw0 = jnp.einsum("fij,fkmj->fkmi", Twl0[:, :3, :3], Xo0) + Twl0[:, None, None, :3, 3]
    Xh0 = (jnp.einsum("fkij,fkmj->fkmi", motions_init[..., :3, :3], Xw0)
           + motions_init[..., None, :3, 3])
    yo0 = jnp.einsum("fij,fkmj->fkmi", Tc0[:, :3, :3], Xh0) + Tc0[:, None, None, :3, 3]
    r0 = (ob_uv + ob_flow) - jcam.project(yo0, c.fx, c.fy, c.cx, c.cy)
    a[10] = a[10] * (jnp.sum(r0 * r0, -1) < p.obj_init_gate_px ** 2).astype(a[10].dtype)
    return a


def test_refine_window_jacobian_matches_jax(multiwindow):
    """J of the port's residual model (forward mode over the unweighted
    residuals, times the frozen row weights) against jax.jacfwd of the
    reference's residuals (stop_gradient on the IRLS weight), at v = 0,
    where the odometry residuals are exactly the identity, and at a
    random v.  (At rotation deltas ~1e-3 rad both float32 Jacobians sit
    ~1e-4 relative on either side of the float64 one: exp_so3's
    (1 - cos)/theta^2 cancels; the random v turns by ~1e-2 rad.)"""
    p = jmwba.MultiWindowParams(**MW_PARAMS)
    c = test_multi_window.CAM
    jargs = _jax_gate(multiwindow, p)
    f = lambda v: _jax_residuals(v, jargs, p)
    pb = tmwba.window_problem(*(t(x) for x in multiwindow), c.fx, c.fy, c.cx, c.cy,
                              tmwba.MultiWindowParams(**MW_PARAMS))
    # the transcription is the reference: the same objective at the init
    res0 = jmwba.refine_window(*(jnp.asarray(x) for x in multiwindow), c.fx, c.fy, c.cx, c.cy,
                               params=p._replace(iters=0))
    r0 = f(jnp.zeros(pb.D))
    np.testing.assert_allclose(float(jnp.sum(r0 * r0)), float(res0.chi2), rtol=1e-5)
    assert float(jnp.sum(jargs[10])) < jargs[10].size      # the gate dropped points
    rng = np.random.default_rng(7)
    for v in (np.zeros(pb.D, np.float32),
              (rng.normal(0, 1, pb.D) * np.tile([1e-2] * 3 + [5e-2] * 3, pb.D // 6)
               ).astype(np.float32)):
        J_j = np.asarray(jax.jacfwd(f)(jnp.asarray(v)))
        r_raw = pb.raw_residuals(t(v))
        s = pb.row_scale(r_raw)
        J_t = n(s[:, None] * torch.func.jacfwd(pb.raw_residuals)(t(v)))
        assert np.isfinite(J_t).all() and J_t.shape == J_j.shape
        np.testing.assert_allclose(J_t, J_j, rtol=1e-4, atol=1e-4 * np.abs(J_j).max())
        np.testing.assert_allclose(n(s * r_raw), np.asarray(f(jnp.asarray(v))),
                                   rtol=1e-4, atol=1e-4)


def test_refine_window_matches_jax(multiwindow):
    c = test_multi_window.CAM
    res_j = jmwba.refine_window(*(jnp.asarray(x) for x in multiwindow), c.fx, c.fy, c.cx, c.cy,
                                params=jmwba.MultiWindowParams(**MW_PARAMS))
    res_t = tmwba.refine_window(*(t(x) for x in multiwindow), c.fx, c.fy, c.cx, c.cy,
                                params=tmwba.MultiWindowParams(**MW_PARAMS))
    np.testing.assert_allclose(n(res_t.poses), np.asarray(res_j.poses), atol=1e-4)
    np.testing.assert_allclose(n(res_t.motions), np.asarray(res_j.motions), atol=1e-4)
    np.testing.assert_allclose(float(res_t.chi2), float(res_j.chi2), rtol=1e-3)
    assert np.abs(n(res_t.poses) - multiwindow[0]).max() > 1e-3


# ------------------------------------------------------------------ refiners

JCFG = small_config(jconfig, synth_camera_config())
TCFG = small_config(tconfig, t_synth_cam())


def _wire(pkg, frames):
    g = np.stack([np.clip(np.round(fd.gray), 0, 255).astype(np.uint8) for fd in frames])
    d = np.stack([pkg.pack_depth12(np.clip(fd.depth_raw, 0, 65535).astype(np.uint16))
                  for fd in frames])
    f = np.stack([pkg.pack_flow12_half(fd.flow) for fd in frames[:-1]])
    s = np.stack([pkg.pack_sem4(fd.sem_mask) for fd in frames])
    return g, d, f, s


def _online_poses(frames):
    """Window poses relative to frame 0 from the ground truth, perturbed as
    an online pass would leave them."""
    rng = np.random.default_rng(8)
    Twc0 = frames[0].pose_gt
    out = [np.eye(4, dtype=np.float32)]
    for fd in frames[1:]:
        d = np.concatenate([rng.normal(0, 1e-3, 3), rng.normal(0, 0.01, 3)]).astype(np.float32)
        out.append(np.asarray(jse3.exp_se3(jnp.asarray(d)))
                   @ np.linalg.inv(fd.pose_gt) @ Twc0)
    return np.stack(out).astype(np.float32)


def test_refine_trailing_window_matches_jax(frames):
    poses = _online_poses(frames)
    gj, dj, fj, sj = _wire(jwire, frames)
    gt, dt, ft, st = _wire(twire, frames)
    P_j, n_j = jwr.refine_trailing_window(jnp.asarray(poses), jnp.asarray(gj),
                                          jnp.asarray(dj[0]), jnp.asarray(fj),
                                          jnp.asarray(sj), JCFG)
    P_t, n_t = twr.refine_trailing_window(t(poses), t(gt), t(dt[0]), t(ft), t(st), TCFG)
    assert int(n_t) == int(n_j) >= TCFG.backend.min_window_tracks
    np.testing.assert_allclose(n(P_t), np.asarray(P_j), atol=1e-3)
    assert np.abs(n(P_t) - poses).max() > 1e-3


def test_refine_joint_window_matches_jax(frames):
    poses = _online_poses(frames)
    K = TCFG.padding.k_obj_max
    H_init = np.tile(np.eye(4, dtype=np.float32), (len(frames) - 1, K, 1, 1))
    H_valid = np.zeros((len(frames) - 1, K), bool)
    for f, (a, b) in enumerate(zip(frames[:-1], frames[1:])):
        for k in range(K):
            ia, ib = np.flatnonzero(a.obj_ids_gt == k + 1), np.flatnonzero(b.obj_ids_gt == k + 1)
            if ia.size and ib.size:
                P_lc = b.obj_poses_gt[ib[0]] @ np.linalg.inv(a.obj_poses_gt[ia[0]])
                H_init[f, k] = np.linalg.inv(poses[f + 1]) @ P_lc @ poses[f]
                H_valid[f, k] = True
    assert H_valid.any()
    gj, dj, fj, sj = _wire(jwire, frames)
    gt, dt, ft, st = _wire(twire, frames)
    P_j, M_j, c_j = jwr.refine_joint_window(
        jnp.asarray(poses), jnp.asarray(H_init), jnp.asarray(H_valid), jnp.asarray(gj),
        jnp.asarray(dj), jnp.asarray(fj), jnp.asarray(sj), JCFG)
    P_t, M_t, c_t = twr.refine_joint_window(t(poses), t(H_init), t(H_valid), t(gt), t(dt),
                                            t(ft), t(st), TCFG)
    np.testing.assert_allclose(n(P_t), np.asarray(P_j), atol=1e-3)
    np.testing.assert_allclose(n(M_t), np.asarray(M_j), atol=1e-3)
    np.testing.assert_allclose(float(c_t), float(c_j), rtol=1e-3)
    assert np.abs(n(P_t) - poses).max() > 1e-4
