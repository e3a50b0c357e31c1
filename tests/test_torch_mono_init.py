"""The monocular bootstrap's modules against the JAX package (CPU): lens
undistortion (``geometry/camera``) and the H/F initializer
(``solvers/initializer``), on the same inputs and the same replayed draws.

* ``undistort_points`` / ``distort_normalized`` on tests/test_euroc.py's
  EuRoC distortion: within 1e-5 px of the JAX functions (measured 0), and
  the round trip within 0.01 px as there;
* ``eight_point_F`` / ``four_point_H`` on 64 random sets of 8 and 4
  distinct points of
  tests/test_geom_solvers.py's initializer scene, within 1e-4 after both
  are scaled to unit norm with one sign (a nullspace has either sign);
  ``decompose_homography``'s 8 candidates as a set, within 1e-4;
* ``initialize_mono`` on that scene (the F model), its plane-dominant
  variant (the H model) and the pure plane (refused), and on the
  distinct-texture junction's frames 0 -> 6 at the KITTI camera, matched
  by the port's frontend: the same ``ok``, model and inlier set, T21
  within 1e-4 (1e-3 on the plane-dominant scene, where the JAX package's
  own float32 error is 9.3e-4: see that test).  The JAX package's draws are replayed from its key
  (``(frame, "mono_F")`` / ``(frame, "mono_H")`` are the two halves of
  ``split(key)``).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from multimot_track_tpu.config import CameraConfig as JCameraConfig
from multimot_track_tpu.geometry import camera as jcamera
from multimot_track_tpu.geometry import se3 as jse3
from multimot_track_tpu.io import synth as jsynth
from multimot_track_tpu.solvers import initializer as jinit
from multimot_track_tpu_torch.config import DEFAULT_CONFIG, CameraConfig
from multimot_track_tpu_torch.geometry import camera as tcamera
from multimot_track_tpu_torch.io import synth as tsynth
from multimot_track_tpu_torch.io.kitti import _rgb_to_gray
from multimot_track_tpu_torch.ops import matching
from multimot_track_tpu_torch.pipeline.mono import MonoTracker
from multimot_track_tpu_torch.solvers import initializer as tinit

torch.set_num_threads(1)

CAM = JCameraConfig()
EUROC = (458.654, 457.296, 367.215, 248.375)
EUROC_DIST = (-0.28340811, 0.07395907, 0.00019359, 1.76187114e-05)


class InitKeySampler:
    """Replays ``initialize_mono``'s two ``jax.random.choice`` draws from
    the key it is given: the F sets from ``split(key)[0]``, the H sets from
    ``split(key)[1]``."""

    def __init__(self, key):
        self.kF, self.kH = jax.random.split(key)

    def __call__(self, p, iters, sites, k=3):
        pn = p.cpu().numpy()
        keys = {"mono_F": self.kF, "mono_H": self.kH}
        idx = [np.asarray(jax.random.choice(keys[s[1]], pn.shape[1], shape=(iters, k),
                                            replace=True, p=jnp.asarray(pn[m])))
               for m, s in enumerate(sites.names())]
        return torch.from_numpy(np.stack(idx)).to(torch.int64)


def test_undistort_points_matches_jax():
    fx, fy, cx, cy = EUROC
    rng = np.random.default_rng(0)
    uv_true = rng.uniform([40, 40], [712, 440], (500, 2)).astype(np.float32)
    xy = np.stack([(uv_true[:, 0] - cx) / fx, (uv_true[:, 1] - cy) / fy], -1)
    xyd_t = tcamera.distort_normalized(torch.from_numpy(xy), *EUROC_DIST)
    xyd_j = np.asarray(jcamera.distort_normalized(jnp.asarray(xy), *EUROC_DIST))
    np.testing.assert_allclose(xyd_t.numpy(), xyd_j, atol=1e-6)
    uv_d = np.stack([xyd_j[:, 0] * fx + cx, xyd_j[:, 1] * fy + cy], -1).astype(np.float32)
    rec_t = tcamera.undistort_points(torch.from_numpy(uv_d), fx, fy, cx, cy, *EUROC_DIST).numpy()
    rec_j = np.asarray(jcamera.undistort_points(jnp.asarray(uv_d), fx, fy, cx, cy, *EUROC_DIST))
    assert np.abs(rec_t - rec_j).max() <= 1e-5
    assert np.abs(rec_t - uv_true).max() < 0.01
    ident = tcamera.undistort_points(torch.from_numpy(uv_true), fx, fy, cx, cy, 0.0, 0.0, 0.0, 0.0)
    assert float((ident - torch.from_numpy(uv_true)).abs().max()) < 1e-3


def scene(rng, n=400):
    """tests/test_geom_solvers.py's initializer scene: points 5-30 m deep
    seen from two poses, 0.3 px of noise on the second view."""
    uv = rng.uniform([100, 50], [CAM.width - 100, CAM.height - 50], (n, 2)).astype(np.float32)
    z = rng.uniform(5, 30, (n,)).astype(np.float32)
    X = np.asarray(jcamera.backproject(jnp.asarray(uv), jnp.asarray(z), CAM.fx, CAM.fy,
                                       CAM.cx, CAM.cy))
    T = jse3.exp_se3(jnp.asarray([0.01, -0.02, 0.005, 0.3, -0.05, 0.8], jnp.float32))
    uv2 = np.array(jcamera.project(jse3.transform(T, jnp.asarray(X)), CAM.fx, CAM.fy,
                                   CAM.cx, CAM.cy))
    uv2 += rng.normal(scale=0.3, size=uv2.shape)
    return uv, uv2.astype(np.float32)


def planar_scene(off_plane: bool):
    """tests/test_geom_solvers.py's plane-dominant scene (85 % of the points
    on one plane, 15 % off it) or, without ``off_plane``, the pure plane."""
    rng = np.random.default_rng(7)
    n_pl = np.asarray([0.05, -0.3, 0.95])
    n_pl /= np.linalg.norm(n_pl)
    uv = rng.uniform([150, 80], [CAM.width - 150, CAM.height - 80], (400, 2)).astype(np.float32)
    rays = np.asarray(jcamera.backproject(jnp.asarray(uv), jnp.ones(400, np.float32), CAM.fx,
                                          CAM.fy, CAM.cx, CAM.cy))
    z = 15.0 / (rays @ n_pl)
    if off_plane:
        z[340:] = rng.uniform(4, 8, (60,))
    X = (rays * z[:, None]).astype(np.float32)
    T = jse3.exp_se3(jnp.asarray([0.02, -0.04, 0.01, 1.2, -0.3, 0.8], jnp.float32))
    uv2 = np.array(jcamera.project(jse3.transform(T, jnp.asarray(X)), CAM.fx, CAM.fy,
                                   CAM.cx, CAM.cy))
    uv2 += rng.normal(scale=0.25, size=uv2.shape)
    return uv, uv2.astype(np.float32)


def unit(M):
    """(..., 3, 3) scaled to unit Frobenius norm, sign fixed by the largest
    entry."""
    M = M / np.linalg.norm(M.reshape(M.shape[:-2] + (9,)), axis=-1)[..., None, None]
    flat = M.reshape(M.shape[:-2] + (9,))
    sign = np.sign(np.take_along_axis(flat, np.abs(flat).argmax(-1)[..., None], -1))
    return M * sign[..., None]


def test_eight_point_and_four_point_match_jax():
    uv, uv2 = scene(np.random.default_rng(13))
    rng = np.random.default_rng(1)
    for k, jf, tf in ((8, jinit.eight_point_F, tinit.eight_point_F),
                      (4, jinit.four_point_H, tinit.four_point_H)):
        # distinct points: a repeated one leaves a 2-D nullspace, in which
        # either package's vector is right
        idx = np.stack([rng.choice(len(uv), k, replace=False) for _ in range(64)])
        Mj = np.asarray(jf(jnp.asarray(uv[idx]), jnp.asarray(uv2[idx])))
        Mt = tf(torch.from_numpy(uv[idx]), torch.from_numpy(uv2[idx])).numpy()
        np.testing.assert_allclose(unit(Mt), unit(Mj), atol=1e-4)


def test_decompose_homography_matches_jax():
    """tests/test_geom_solvers.py's calibrated homography: the 8 Faugeras
    candidates of both packages as sets (the order follows the SVD's
    signs), and the true motion among them."""
    K = np.asarray(CAM.K, np.float32)
    T = np.asarray(jse3.exp_se3(jnp.asarray([0.04, -0.03, 0.02, 0.3, -0.1, 0.5], jnp.float32)))
    n_true = np.asarray([0.1, -0.05, 0.99])
    n_true /= np.linalg.norm(n_true)
    H = (K @ (T[:3, :3] + np.outer(T[:3, 3], n_true) / 12.0) @ np.linalg.inv(K)).astype(np.float32)
    Rj, tj, nj, okj = (np.asarray(a) for a in jinit.decompose_homography(jnp.asarray(H),
                                                                          jnp.asarray(K)))
    Rt, tt, nt, okt = (a.numpy() for a in tinit.decompose_homography(torch.from_numpy(H),
                                                                      torch.from_numpy(K)))
    assert bool(okt) == bool(okj) is True
    cj = np.concatenate([Rj.reshape(8, 9), tj, nj], -1)
    ct = np.concatenate([Rt.reshape(8, 9), tt, nt], -1)
    d = np.abs(ct[:, None] - cj[None]).max(-1)             # (port, jax)
    assert sorted(d.argmin(1)) == list(range(8))
    assert d.min(1).max() <= 1e-4, d.min(1)
    ang = [np.degrees(np.arccos(np.clip((np.trace(R @ T[:3, :3].T) - 1) / 2, -1, 1)))
           for R in Rt]
    assert min(ang) < 0.2


def assert_same_init(rt, rj, valid, t_tol=1e-4):
    assert bool(rt.ok) == bool(rj.ok)
    assert bool(rt.used_homography) == bool(rj.used_homography)
    np.testing.assert_array_equal(rt.inliers.numpy(), np.asarray(rj.inliers))
    np.testing.assert_allclose(rt.T21.numpy(), np.asarray(rj.T21), atol=t_tol)
    inl = rt.inliers.numpy() & valid
    np.testing.assert_allclose(rt.points3d.numpy()[inl], np.asarray(rj.points3d)[inl],
                               rtol=1e-3, atol=1e-3)


@pytest.mark.parametrize("case,key,ok,homography", [
    ("general", 2, True, False), ("plane_dominant", 3, True, True), ("pure_plane", 3, False, None)])
def test_initialize_mono_matches_jax(case, key, ok, homography):
    """On the plane-dominant scene the pose comes from a 4-point
    homography's decomposition, and the JAX package's float32 T21 lies
    9.3e-4 from the same draws' float64 answer, the port's 1e-6: there the
    two are held to 1e-3 and the port to 1e-5 of float64."""
    if case == "general":
        uv, uv2 = scene(np.random.default_rng(13))
    else:
        uv, uv2 = planar_scene(off_plane=case == "plane_dominant")
    valid = np.ones(len(uv), bool)
    k = jax.random.PRNGKey(key)
    rj = jinit.initialize_mono(k, jnp.asarray(uv), jnp.asarray(uv2), jnp.asarray(valid),
                               CAM.fx, CAM.fy, CAM.cx, CAM.cy)
    args = (CAM.fx, CAM.fy, CAM.cx, CAM.cy)
    rt = tinit.initialize_mono(torch.from_numpy(uv), torch.from_numpy(uv2),
                               torch.from_numpy(valid), *args, sampler=InitKeySampler(k), frame=1)
    assert bool(rt.ok) is ok
    if homography is not None:
        assert bool(rt.used_homography) is homography
    t_tol = 1e-4
    if case == "plane_dominant":
        r64 = tinit.initialize_mono(torch.from_numpy(uv).double(), torch.from_numpy(uv2).double(),
                                    torch.from_numpy(valid), *args, sampler=InitKeySampler(k),
                                    frame=1)
        T64 = r64.T21.numpy()
        assert np.abs(rt.T21.numpy() - T64).max() <= 1e-5
        assert np.abs(np.asarray(rj.T21) - T64).max() > 1e-4     # the reference's own error
        t_tol = 1e-3
    assert_same_init(rt, rj, valid, t_tol)


@pytest.fixture(scope="module")
def junction_0_6():
    """The distinct-texture junction at t = 0, 6 and 12 (2.7 m apart),
    KITTI camera."""
    return tsynth.make_junction_frames(43, cam=dict(tsynth.KITTI_SYNTH_CAM), texture="distinct",
                                       times=(0, 6, 12))


def test_junction_render_matches_jax(junction_0_6):
    """Drift guard: the port's render of the monocular fixture's first frame
    is the JAX package's bit for bit."""
    build = jsynth._build_frames

    def first_only(cam, Twc_at, movers, n_frames, box, texture=None):
        return build(cam, Twc_at, movers, 1, box, texture)   # the 43-frame scene's t = 0

    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jsynth, "_build_frames", first_only)
        j = jsynth.make_junction_frames(43, cam=dict(jsynth.KITTI_SYNTH_CAM),
                                        texture="distinct")[0]
    np.testing.assert_array_equal(junction_0_6[0].gray, j.gray)
    np.testing.assert_array_equal(junction_0_6[0].pose_gt, j.pose_gt)


def test_initialize_mono_on_junction_frames_matches_jax(junction_0_6):
    cam = CameraConfig(**tsynth.KITTI_SYNTH_CAM)
    tr = MonoTracker(dataclasses.replace(DEFAULT_CONFIG, camera=cam), device="cpu")
    (uv_a, d_a, v_a), (uv_b, d_b, v_b) = (tr._frontend(f.gray) for f in junction_0_6[:2])
    m = matching.match_descriptors(d_a, d_b, v_a, v_b)
    uv1, uv2, valid = uv_a, uv_b[m.idx], m.valid
    assert int(valid.sum()) > 100
    k = jax.random.fold_in(jax.random.PRNGKey(0), 1)
    rj = jinit.initialize_mono(k, jnp.asarray(uv1.numpy()), jnp.asarray(uv2.numpy()),
                               jnp.asarray(valid.numpy()), cam.fx, cam.fy, cam.cx, cam.cy)
    rt = tinit.initialize_mono(uv1, uv2, valid, cam.fx, cam.fy, cam.cx, cam.cy,
                               sampler=InitKeySampler(k), frame=1)
    assert bool(rt.ok) and not bool(rt.used_homography)
    assert_same_init(rt, rj, valid.numpy())
    # the step's direction is the ground truth's (up to scale)
    T_gt = np.linalg.inv(junction_0_6[1].pose_gt) @ junction_0_6[0].pose_gt
    t_est = rt.T21.numpy()[:3, 3]
    assert np.dot(t_est, T_gt[:3, 3]) / np.linalg.norm(T_gt[:3, 3]) > 0.95


def test_initialize_mono_on_8bit_frames_jax_float32_error(junction_0_6):
    """Frames 6 -> 12 as a KITTI tree stores them (8-bit RGB, back to gray),
    the CLI's first successful bootstrap there: the same draws give the
    same ok and model, but the JAX package's float32 solve ends 4.5e-2 from
    the float64 answer (its best F hypothesis is another one: 78 inliers
    against 102) while the port's float32 solve is within 1e-6 of it.
    tests/test_torch_entry_mono.py's tolerance on that tree rests on this."""
    cam = CameraConfig(**tsynth.KITTI_SYNTH_CAM)
    tr = MonoTracker(dataclasses.replace(DEFAULT_CONFIG, camera=cam), device="cpu")
    feats = [tr._frontend(_rgb_to_gray(np.stack([tsynth._gray8(f.gray)] * 3, -1)))
             for f in junction_0_6[1:]]
    m = matching.match_descriptors(feats[0][1], feats[1][1], feats[0][2], feats[1][2])
    uv1, uv2, valid = feats[0][0], feats[1][0][m.idx], m.valid
    args = (cam.fx, cam.fy, cam.cx, cam.cy)
    k = jax.random.fold_in(jax.random.PRNGKey(0), 2)
    rj = jinit.initialize_mono(k, jnp.asarray(uv1.numpy()), jnp.asarray(uv2.numpy()),
                               jnp.asarray(valid.numpy()), *args)
    rt = tinit.initialize_mono(uv1, uv2, valid, *args, sampler=InitKeySampler(k), frame=2)
    r64 = tinit.initialize_mono(uv1.double(), uv2.double(), valid, *args,
                                sampler=InitKeySampler(k), frame=2)
    assert bool(rt.ok) == bool(rj.ok) == bool(r64.ok) is True
    assert bool(rt.used_homography) == bool(rj.used_homography) is False
    np.testing.assert_array_equal(rt.inliers.numpy(), r64.inliers.numpy())
    T64 = r64.T21.numpy()
    assert np.abs(rt.T21.numpy() - T64).max() <= 1e-5
    assert np.abs(np.asarray(rj.T21) - T64).max() > 1e-2
