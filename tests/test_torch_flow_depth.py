"""Parity of the port's flow+depth BA and its small geometry helpers with
the JAX package (CPU).

Inputs: ``tests/test_flow_depth_ba.py``'s two scenes, drawn in that file's
order from ``default_rng(61)``, and seeded small problems for the helpers.
Tolerances: the flow+depth LM's pose within 1e-4 of the JAX package's with
identical inlier masks (float32 sums in another order), the refined flows
within rtol 1e-4 / 5e-3 px and the mean reprojection error within rtol
1e-3 / 1e-4 px (the noise-free scene ends at ~7e-6 px); the noise-free
scene within 5e-3 of the truth, as the JAX test holds it; the helpers
within rtol 1e-5 (the same float32 formulas), and the JAX tests' own
bounds against numpy and scipy.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from scipy.spatial.transform import Rotation

from multimot_track_tpu.config import CameraConfig
from multimot_track_tpu.geometry import camera as jcamera
from multimot_track_tpu.geometry import se3 as jse3
from multimot_track_tpu.geometry import smallsolve as jsmall
from multimot_track_tpu.solvers import flow_ba as jflow
from multimot_track_tpu.solvers import horn as jhorn
from multimot_track_tpu_torch.geometry import se3 as tse3
from multimot_track_tpu_torch.geometry import smallsolve as tsmall
from multimot_track_tpu_torch.solvers import flow_ba as tflow
from multimot_track_tpu_torch.solvers import horn as thorn

torch.set_num_threads(1)

CAM = CameraConfig()
T_ATOL = 1e-4
RTOL, ATOL = 1e-5, 1e-6


def _scene(rng, n=512, depth_noise_frac=0.08, flow_noise=0.05):
    uv = rng.uniform([80, 40], [CAM.width - 80, CAM.height - 40], (n, 2)).astype(np.float32)
    z = rng.uniform(5.0, 30.0, (n,)).astype(np.float32)
    X = np.asarray(jcamera.backproject(jnp.asarray(uv), jnp.asarray(z), CAM.fx, CAM.fy,
                                       CAM.cx, CAM.cy))
    xi = np.asarray([0.01, -0.02, 0.005, 0.3, -0.1, 1.1], np.float32)
    T_true = np.asarray(jse3.exp_se3(jnp.asarray(xi)))
    uv_cur = np.asarray(jcamera.project(jse3.transform(jnp.asarray(T_true), jnp.asarray(X)),
                                        CAM.fx, CAM.fy, CAM.cx, CAM.cy))
    flow = (uv_cur - uv + rng.normal(scale=flow_noise, size=(n, 2))).astype(np.float32)
    z_meas = (z * (1 + rng.normal(scale=depth_noise_frac, size=n))).astype(np.float32)
    return uv, z, z_meas, flow, T_true


@pytest.fixture(scope="module")
def scenes():
    rng = np.random.default_rng(61)
    noisy = _scene(rng)
    clean = _scene(rng, depth_noise_frac=0.0, flow_noise=0.0)
    return {"noisy": noisy, "noise_free": clean}


def _both(uv, flow, z, params_kw):
    n = uv.shape[0]
    jres = jflow.solve_flow_depth_ba(
        jnp.eye(4), jnp.eye(4), jnp.asarray(uv), jnp.asarray(flow), jnp.asarray(z),
        jnp.ones(n, bool), CAM.fx, CAM.fy, CAM.cx, CAM.cy,
        params=jflow.FlowDepthBAParams(**params_kw))
    eye = torch.eye(4)
    tres = tflow.solve_flow_depth_ba(
        eye, eye, torch.from_numpy(uv), torch.from_numpy(flow), torch.from_numpy(z),
        torch.ones(n, dtype=torch.bool), CAM.fx, CAM.fy, CAM.cx, CAM.cy,
        params=tflow.FlowDepthBAParams(**params_kw))
    return jres, tres


def _t_err(T, T_true):
    E = np.asarray(T) @ np.linalg.inv(T_true)
    return np.linalg.norm(E[:3, 3])


@pytest.mark.parametrize("case", ["noisy", "noise_free"])
def test_flow_depth_ba_matches_jax(scenes, case):
    uv, z_true, z_meas, flow, T_true = scenes[case]
    z = z_meas if case == "noisy" else z_true
    kw = dict(iters=100, depth_prior_info=0.5) if case == "noisy" else dict(iters=100)
    jres, tres = _both(uv, flow, z, kw)
    np.testing.assert_allclose(tres.T.numpy(), np.asarray(jres.T), atol=T_ATOL)
    np.testing.assert_array_equal(tres.inliers.numpy(), np.asarray(jres.inliers))
    assert int(tres.n_inliers) == int(jres.n_inliers)
    # refined flows of up to ~40 px after up to 100 float32 LM steps
    np.testing.assert_allclose(tres.flow.numpy(), np.asarray(jres.flow), rtol=1e-4, atol=5e-3)
    np.testing.assert_allclose(float(tres.mean_reproj), float(jres.mean_reproj), rtol=1e-3,
                               atol=1e-4)
    assert np.isfinite(tres.T.numpy()).all()
    if case == "noise_free":
        assert _t_err(tres.T.numpy(), T_true) < 5e-3


def test_flow_depth_beats_fixed_depth_under_depth_noise(scenes):
    """``test_flow_depth_ba.py``'s behavioural gate on the port alone."""
    uv, _, z_meas, flow, T_true = scenes["noisy"]
    n = uv.shape[0]
    eye = torch.eye(4)[None]
    fixed = tflow.solve_flow_ba(
        eye, eye, torch.from_numpy(uv)[None], torch.from_numpy(flow)[None],
        torch.from_numpy(z_meas)[None], torch.ones(1, n, dtype=torch.bool),
        CAM.fx, CAM.fy, CAM.cx, CAM.cy, params=tflow.FlowBAParams(iters=100))
    _, joint = _both(uv, flow, z_meas, dict(iters=100, depth_prior_info=0.5))
    assert _t_err(joint.T.numpy(), T_true) < 1.5 * _t_err(fixed.T[0].numpy(), T_true) + 1e-3
    assert int(joint.n_inliers) >= int(fixed.n_inliers[0])


def _spd(rng, n, batch):
    A = rng.normal(size=batch + (n, n)).astype(np.float32)
    return A @ np.swapaxes(A, -1, -2) + n * np.eye(n, dtype=np.float32)


def test_solve_spd3_and_inv_spd3_match():
    rng = np.random.default_rng(7)
    H = _spd(rng, 3, (512,))
    g = rng.normal(size=(512, 3)).astype(np.float32)
    x = tsmall.solve_spd3(torch.from_numpy(H), torch.from_numpy(g)).numpy()
    Hi = tsmall.inv_spd3(torch.from_numpy(H)).numpy()
    np.testing.assert_allclose(x, np.asarray(jsmall.solve_spd3(jnp.asarray(H), jnp.asarray(g))),
                               rtol=RTOL, atol=ATOL)
    np.testing.assert_allclose(Hi, np.asarray(jsmall.inv_spd3(jnp.asarray(H))),
                               rtol=RTOL, atol=ATOL)
    # the JAX test's bounds against numpy
    np.testing.assert_allclose(x, np.linalg.solve(H, g[..., None])[..., 0], rtol=2e-3, atol=2e-4)
    np.testing.assert_allclose(Hi, np.linalg.inv(H), rtol=2e-3, atol=2e-4)


def test_euler_y_and_transform_points_match():
    yaw = np.asarray([0.3, -1.2, 2.9], np.float32)
    R = tse3.euler_y_to_R(torch.from_numpy(yaw)).numpy()
    np.testing.assert_allclose(R, np.asarray(jse3.euler_y_to_R(jnp.asarray(yaw))),
                               rtol=RTOL, atol=ATOL)
    np.testing.assert_allclose(R[0], Rotation.from_euler("y", 0.3).as_matrix(), atol=1e-6)
    rng = np.random.default_rng(3)
    T = np.array(jse3.exp_se3(jnp.asarray(rng.normal(0, 0.3, (2, 6)).astype(np.float32))))
    pts = rng.normal(0, 5, (2, 40, 3)).astype(np.float32)
    np.testing.assert_allclose(
        tse3.transform_points(torch.from_numpy(T), torch.from_numpy(pts)).numpy(),
        np.asarray(jse3.transform_points(jnp.asarray(T), jnp.asarray(pts))),
        rtol=RTOL, atol=1e-5)


@pytest.mark.parametrize("weighted", [False, True])
def test_rigid_align_svd_matches(weighted):
    rng = np.random.default_rng(11)
    T_true = np.asarray(jse3.exp_se3(jnp.asarray(rng.normal(0, 0.5, (3, 6)).astype(np.float32))))
    src = rng.normal(0, 3, (3, 64, 3)).astype(np.float32)
    dst = (np.einsum("bij,bnj->bni", T_true[:, :3, :3], src) + T_true[:, None, :3, 3]
           + rng.normal(0, 0.01, src.shape)).astype(np.float32)
    w = rng.uniform(0.1, 1.0, (3, 64)).astype(np.float32) if weighted else None
    Tj = np.asarray(jhorn.rigid_align_svd(jnp.asarray(src), jnp.asarray(dst),
                                          None if w is None else jnp.asarray(w)))
    Tt = thorn.rigid_align_svd(torch.from_numpy(src), torch.from_numpy(dst),
                               None if w is None else torch.from_numpy(w)).numpy()
    np.testing.assert_allclose(Tt, Tj, atol=1e-5)
    np.testing.assert_allclose(Tt, T_true, atol=0.02)


def test_solve_flow_ba_batched_matches():
    rng = np.random.default_rng(5)
    K, N = 3, 256
    uv = rng.uniform([80, 40], [CAM.width - 80, CAM.height - 40], (K, N, 2)).astype(np.float32)
    z = rng.uniform(5.0, 30.0, (K, N)).astype(np.float32)
    flow = rng.normal(0, 2.0, (K, N, 2)).astype(np.float32)
    valid = rng.random((K, N)) < 0.9
    Twl = np.array(jse3.exp_se3(jnp.asarray([0.01, 0.02, -0.01, 0.1, 0.0, 0.3], jnp.float32)))
    T0 = np.tile(np.eye(4, dtype=np.float32), (K, 1, 1))
    p = dict(iters=30)
    jr = jflow.solve_flow_ba_batched(jnp.asarray(T0), jnp.asarray(Twl), jnp.asarray(uv),
                                     jnp.asarray(flow), jnp.asarray(z), jnp.asarray(valid),
                                     CAM.fx, CAM.fy, CAM.cx, CAM.cy, jflow.FlowBAParams(**p))
    tr = tflow.solve_flow_ba_batched(torch.from_numpy(T0), torch.from_numpy(Twl),
                                     torch.from_numpy(uv), torch.from_numpy(flow),
                                     torch.from_numpy(z), torch.from_numpy(valid),
                                     CAM.fx, CAM.fy, CAM.cx, CAM.cy, tflow.FlowBAParams(**p))
    np.testing.assert_allclose(tr.T.numpy(), np.asarray(jr.T), atol=T_ATOL)
    np.testing.assert_array_equal(tr.n_inliers.numpy(), np.asarray(jr.n_inliers))
