"""Kernel K3 (csrc/window_ba_lm.cu, the trailing-window BA's LM in one
launch) against its plain torch version ``solvers/window_ba.solve_window_ba``.
Imports no jax, so the GPU machine runs this file as is:

    python -m pytest --noconftest -m gpu tests/test_torch_window_kernel.py

Tests that need the card carry the ``gpu`` marker and skip without one (the
kernel has no CPU mode).  Tolerances are those of the plain version against
the JAX package (tests/test_torch_window.py): poses atol 1e-4, inverse
depths and chi2 rtol 1e-3 — float32 sums in another order, and near
convergence an LM step that changes the cost by less than its rounding is
taken by one version and not the other.  They hold on windows without
gross outliers, as that comparison's window has none.  On the two-frame
window without the odometry prior (the scale along the motion rests on
the depth priors alone) the plain version itself lands 1.1e-4 apart on
the card and on the CPU, each a float32 rounding of the same algorithm;
so K3 is held to the plain version on the card or on the CPU, at the
tolerances, and must meet them against one of the two.  A track whose
observations are all Huber outliers has an inverse depth that float32
does not resolve to 1e-3: the plain version itself lands up to 7e-3 from
its float64 solution on such windows.  There both versions are held to
the float64 solution, K3 to no worse than twice the plain version's
error.  Along a flat direction of the objective float32 cannot resolve
the poses either: on some clean windows K3 lands 5e-5 to 1.3e-4 from the
float64 solution, the plain version on the card or the CPU elsewhere
(tests/torch_window_problem draws both kinds).  There K3 is held by the
objective in float64: no worse than the worst plain float32 result plus
the float32 rounding of the sum, the poses loosely.
"""

import dataclasses
import math

import numpy as np
import pytest
import torch

from multimot_track_tpu_torch.solvers import window_ba, window_ba_cuda
from multimot_track_tpu_torch.solvers.window_ba import WindowBAParams, solve_window_ba
from multimot_track_tpu_torch.solvers.window_ba_cuda import solve_window_ba_cuda
from torch_window_problem import CAM, cams, make_window, objective

torch.set_num_threads(1)

POSE_ATOL, RHO_RTOL, CHI2_RTOL = 1e-4, 1e-3, 1e-3


# ---------------------------------------------------------------- the CPU

def test_window_kernel_wrapper_refuses_cpu_tensors():
    with pytest.raises(ValueError, match="CUDA"):
        solve_window_ba_cuda(*make_window(N=64), *cams())


def _no_cuda_call():
    raise AssertionError("the wrapper reached the CUDA library before its checks")


@pytest.mark.parametrize("bad,match", [
    (dict(depth0=lambda a: a.to("meta")), "depth0 is on meta"),
    (dict(poses_init=lambda a: a.double()), "poses_init"),
    (dict(alive=lambda a: a.float()), "alive"),
    (dict(depth0=lambda a: a[:-1]), "depth0"),
    (dict(uv=lambda a: a[..., :1]), "uv"),
    (dict(uv=lambda a: a.transpose(0, 1).contiguous().transpose(0, 1)), "uv must be contiguous"),
    (dict(poses_init=lambda a: a.transpose(1, 2)), "poses_init must be contiguous"),
])
def test_window_wrapper_checks_raise_before_any_cuda_call(monkeypatch, bad, match):
    monkeypatch.setattr(window_ba_cuda, "_lib", _no_cuda_call)
    kw = dict(zip(("poses_init", "uv", "alive", "depth0"), make_window(N=64)))
    (name, fix), = bad.items()
    kw[name] = fix(kw[name])
    with pytest.raises(ValueError, match=match):
        solve_window_ba_cuda(**kw, fx=CAM.fx, fy=CAM.fy, cx=CAM.cx, cy=CAM.cy)


@pytest.mark.parametrize("F", [1, 17])
def test_window_wrapper_refuses_window_sizes_it_cannot_hold(monkeypatch, F):
    monkeypatch.setattr(window_ba_cuda, "_lib", _no_cuda_call)
    poses, uv, alive, z = make_window(F=2, N=8)
    rep = lambda a: a[:1].expand((F,) + a.shape[1:]).contiguous()
    with pytest.raises(ValueError, match="frames"):
        solve_window_ba_cuda(rep(poses), rep(uv), rep(alive), z, *cams())


@pytest.mark.parametrize("odo", [0.0, 2500.0])
def test_auto_on_cpu_tensors_is_the_plain_version(odo):
    args = make_window(F=4, N=96, seed=3)
    p = WindowBAParams(iters=6, odo_prior_weight=odo)
    before = solve_window_ba_cuda.launches
    a = window_ba.solve_window_ba_auto(*args, *cams(), params=p)
    r = solve_window_ba(*args, *cams(), params=p)
    assert solve_window_ba_cuda.launches == before
    for x, y in zip(a, r):
        assert torch.equal(x, y)
    assert np.abs((a.poses - args[0]).numpy()).max() > 1e-3     # the solve moved the poses


def test_window_problem_is_seeded_and_keeps_lost_tracks_dead():
    """The window generator that these tests and ``chip_smoke.py --k3-only``
    share: one seed gives one window; a track lost stays lost; a track
    without a finite depth is dead from frame 0; every live observation is
    inside the image."""
    a, b = make_window(F=5, N=300, seed=4), make_window(F=5, N=300, seed=4)
    for x, y in zip(a, b):
        assert torch.equal(x, y)
    assert not torch.equal(a[1], make_window(F=5, N=300, seed=5)[1])
    poses, uv, alive, z = a
    assert torch.equal(poses[0], torch.eye(4))
    assert (alive[1:] <= alive[:-1]).all()
    assert not alive[:, ~torch.isfinite(z)].any()
    u = uv[1:][alive[1:]]
    assert ((u[:, 0] > 5) & (u[:, 0] < CAM.width - 5) & (u[:, 1] > 5)
            & (u[:, 1] < CAM.height - 5)).all()
    assert 0.5 < alive[-1].float().mean() < 1.0


@pytest.mark.parametrize("N", [1, 255, 256, 257, 2048, 5000])
def test_window_cluster_plan_covers_every_track_once(N):
    """The plan, and the kernel's cut of the tracks under it (CTA r takes
    [r S, r S + S) of N, S = ceil(N / C)): every track once, no CTA more
    than needed, at most one tile a CTA below 8 CTAs."""
    C = window_ba_cuda.cluster_plan(N)
    assert C in (1, 2, 4, 8)
    assert C == 1 or N > (C // 2) * window_ba_cuda.THREADS      # no CTA more than needed
    S = -(-N // C)
    seen = np.zeros(N, np.int64)
    for r in range(C):
        seen[min(r * S, N):min(r * S + S, N)] += 1
    assert (seen == 1).all()
    assert S <= max(window_ba_cuda.THREADS, -(-N // 8))
    assert C == {2048: 8, 5000: 8, 1: 1, 255: 1, 256: 1, 257: 2}[N]


# ---------------------------------------------------------------- the card

@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the CUDA kernels have no CPU mode")
    return torch.device("cuda", 0)


def both(args, dev, params):
    """(K3, plain) on the card on the same inputs."""
    a = [x.to(dev) for x in args]
    k = solve_window_ba_cuda(*a, *cams(), params=params)
    p = solve_window_ba(*a, *cams(), params=params)
    torch.cuda.synchronize()
    return k, p


def float64_solution(args, dev, params):
    return solve_window_ba(*[x.to(dev).double() if x.is_floating_point() else x.to(dev)
                             for x in args], *cams(), params=params)


def misses(x, y):
    """The tolerances ``x`` misses against ``y``: {name: (difference, limit)}."""
    n = lambda t: t.double().cpu().numpy()
    d = {"poses": (np.abs(n(x.poses) - n(y.poses)).max(), POSE_ATOL),
         "inv_depth": ((np.abs(n(x.inv_depth) - n(y.inv_depth)) / np.abs(n(y.inv_depth))).max(),
                       RHO_RTOL),
         "chi2": (abs(float(x.chi2) - float(y.chi2)) / abs(float(y.chi2)), CHI2_RTOL)}
    return {k: v for k, v in d.items() if not v[0] <= v[1]}


def assert_close(k, *plain):
    """K3 finite and within the tolerances of one of the ``plain`` results."""
    assert np.isfinite(k.poses.cpu().numpy()).all()
    assert np.isfinite(k.inv_depth.cpu().numpy()).all()
    bad = [misses(k, p) for p in plain]
    assert not all(bad), bad


@pytest.mark.gpu
@pytest.mark.parametrize("odo", [0.0, 2500.0])
@pytest.mark.parametrize("N", [512, 2048])
@pytest.mark.parametrize("F", [2, 3, 5, 16])
def test_window_kernel_matches_plain_version(cuda_device, F, N, odo):
    args = make_window(F=F, N=N, seed=F * 100 + N)
    params = WindowBAParams(iters=30, odo_prior_weight=odo)
    before = solve_window_ba_cuda.launches
    k, p = both(args, cuda_device, params)
    assert solve_window_ba_cuda.launches == before + 1
    assert_close(k, p, solve_window_ba(*args, *cams(), params=params))
    assert np.abs(k.poses.cpu().numpy() - args[0].numpy()).max() > 1e-3


@pytest.mark.gpu
@pytest.mark.parametrize("F", [3, 5])
def test_window_kernel_as_accurate_as_plain_with_outliers(cuda_device, F):
    """2 % of the observations ~20 px off: K3 and the plain version in
    float32 against the plain version in float64."""
    args = make_window(F=F, N=2048, seed=F * 100 + 2048, outlier_frac=0.02)
    params = WindowBAParams(iters=30, odo_prior_weight=2500.0)
    k, p = both(args, cuda_device, params)
    r = float64_solution(args, cuda_device, params)

    def err(x):
        return (float((x.poses.double() - r.poses).abs().max()),
                float(((x.inv_depth.double() - r.inv_depth).abs() / r.inv_depth.abs()).max()))
    (kp, kr), (pp, pr) = err(k), err(p)
    assert np.isfinite(k.poses.cpu().numpy()).all()
    assert kp <= max(2 * pp, 1e-5) and kr <= max(2 * pr, 1e-4), (kp, pp, kr, pr)
    np.testing.assert_allclose(float(k.chi2), float(r.chi2), rtol=CHI2_RTOL)


@pytest.mark.gpu
@pytest.mark.parametrize("F,odo", [(5, 2500.0), (5, 0.0), (3, 2500.0)])
@pytest.mark.parametrize("seed", range(1000, 1006))
def test_window_kernel_reaches_the_float64_objective(cuda_device, seed, F, odo):
    """Clean windows on which float32 leaves the poses along a flat
    direction (K3 5e-5 to 1.3e-4 from the float64 solution on four of
    them): K3's objective, summed in float64, is no more above the float64
    solve's than the worst of the plain version's on the card and on the
    CPU, plus the float32 rounding of the objective's sum (log2 of its
    terms, in units of float32 epsilon of the objective); the poses within
    1e-3 of the float64 solution; K3's chi2 is the objective at its
    result."""
    args = make_window(F=F, N=2048, seed=seed)
    params = WindowBAParams(iters=30, odo_prior_weight=odo)
    k, p = both(args, cuda_device, params)
    r = float64_solution(args, cuda_device, params)
    best = objective(args, r, params)
    excess = lambda x: objective(args, x, params) - best
    worst_plain = max(excess(p), excess(solve_window_ba(*args, *cams(), params=params)))
    valid0 = args[2][0] & (args[3] > 0)
    n_terms = int((args[2][1:] & valid0).sum()) + int(valid0.sum()) + 6 * (F - 1)
    rounding = math.log2(n_terms) * np.finfo(np.float32).eps * best
    assert excess(k) <= worst_plain + rounding, (excess(k), worst_plain, rounding)
    assert float((k.poses.double() - r.poses).abs().max()) <= 1e-3
    np.testing.assert_allclose(float(k.chi2), objective(args, k, params), rtol=1e-5)


@pytest.mark.gpu
@pytest.mark.parametrize("live", [0, 30])
def test_window_kernel_dead_and_sparse_windows(cuda_device, live):
    """Every track dead after frame 0, or only 30 alive through the window:
    finite outputs equal to the plain version's."""
    poses, uv, alive, z = make_window(F=5, N=2048, seed=7, dead_frac=0.0)
    alive = alive.clone()
    alive[1:, live:] = False
    k, p = both((poses, uv, alive, z), cuda_device, WindowBAParams(iters=30,
                                                                   odo_prior_weight=2500.0))
    assert_close(k, p)


@pytest.mark.gpu
@pytest.mark.parametrize("F,N", [(5, 2048), (16, 5000)])
def test_window_kernel_repeats_bit_for_bit(cuda_device, F, N):
    a = [x.to(cuda_device) for x in make_window(F=F, N=N, seed=11)]
    p = WindowBAParams(iters=30, odo_prior_weight=2500.0)
    r1 = solve_window_ba_cuda(*a, *cams(), params=p)
    r2 = solve_window_ba_cuda(*a, *cams(), params=p)
    for x, y in zip(r1, r2):
        assert torch.equal(x, y)


@pytest.mark.gpu
def test_live_system_launches_k3_once_per_refined_window(cuda_device):
    """The live system with the trailing window on: on the card, fused and
    unfused, one K3 launch per refined window; on the CPU, none."""
    from multimot_track_tpu_torch import config as C
    from multimot_track_tpu_torch.io.synth import (KITTI_SYNTH_CAM, make_junction_frames,
                                                   make_multimover_frames, synth_camera_config)
    from multimot_track_tpu_torch.pipeline.system import MultiMotSystem

    def run(cfg, frames, device):
        s = MultiMotSystem(cfg, keyframe_gap=1, device=device)
        before = solve_window_ba_cuda.launches
        out = [s.track_rgbd(fd) for fd in frames] + [s.flush()]
        assert all(np.isfinite(r.Tcw_cur).all() for r in out if r is not None)
        return s, solve_window_ba_cuda.launches - before

    D = C.DEFAULT_CONFIG
    frames = make_junction_frames(n_frames=8, cam=dict(KITTI_SYNTH_CAM))
    for fused in (True, False):
        cfg = dataclasses.replace(D, backend=dataclasses.replace(D.backend, fused_refine=fused))
        s, n = run(cfg, frames, cuda_device)
        assert s.n_win_dispatched == len(frames) - D.backend.window_size + 1
        assert n == s.n_win_dispatched, (fused, n, s.n_win_dispatched)

    small = dataclasses.replace(
        D, camera=synth_camera_config(),
        frontend=dataclasses.replace(D.frontend, n_features=1000, n_levels=4),
        padding=dataclasses.replace(D.padding, n_static_max=512, n_obj_pts_max=2048,
                                    n_per_obj_max=1024, k_obj_max=4, k_obj_solve=2),
        backend=dataclasses.replace(D.backend, window_size=3, joint_window_refine=False))
    s, n = run(small, make_multimover_frames(n_frames=4), "cpu")
    assert s.n_win_dispatched == 2 and n == 0
