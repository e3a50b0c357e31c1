"""Kernel K4 (csrc/local_map_gn.cu, TrackLocalMap's stereo Gauss-Newton in
one launch) against its plain torch version ``keyframes.local_map_gn``.
Imports no jax, so the GPU machine runs this file as is:

    python -m pytest --noconftest -m gpu tests/test_torch_local_map_kernel.py

Tests that need the card carry the ``gpu`` marker and skip without one (the
kernel has no CPU mode).  Tolerances, with their reasons:

* poses atol 1e-4, as the plain version is held to the JAX package
  (tests/test_torch_keyframes.py): float32 sums over the map points in
  another order (K4: per thread, then a warp tree, then the warps in
  order; the plain version: the einsum's own order), which moves the pose
  by a few 1e-7 here;
* inlier counts within 2: a point within rounding of the 3 px gate may land
  on either side of it;
* against the plain version in float64, K4's pose error is at most twice
  the plain float32 version's, or 1e-6 where both are below that: the
  float32 spacing at the pose's largest entry (~2 m) is 2.4e-7, so below
  four spacings the comparison reads the last rounding, not the solve;
* one map point leaves three of the six pose directions to the 1e-6
  damping alone, whose Cholesky pivots float32 cannot resolve (the plain
  version returns NaN there): at M = 1 both versions are held only to the
  gate's verdict, a rejection.

The live system's poses with K4 and with the plain version are held within
1e-4 m over 20 junction frames, the same acceptance on every frame: the
summation order's few 1e-7 must not grow through the frames.  Over a whole
benchmark drive the two are compared call by call on the same inputs: there
a later stage of the system can turn ~1e-5 m into a different trajectory,
so whole trajectories are not compared.
"""

import dataclasses

import numpy as np
import pytest
import torch

from multimot_track_tpu_torch import config as C
from multimot_track_tpu_torch.io.synth import make_multimover_frames, synth_camera_config
from multimot_track_tpu_torch.pipeline import keyframes
from multimot_track_tpu_torch.pipeline.keyframes import local_map_gn, local_map_gn_auto
from multimot_track_tpu_torch.pipeline.system import MultiMotSystem
from multimot_track_tpu_torch.solvers import local_map_gn_cuda as k4_module
from multimot_track_tpu_torch.solvers.local_map_gn_cuda import local_map_gn_cuda
from torch_local_map_problem import cams, make_local_map

torch.set_num_threads(1)

POSE_ATOL, COUNT_TOL, F64_FLOOR = 1e-4, 2, 1e-6
LIVE_POSE_ATOL = 1e-4
MIN_INLIERS = C.DEFAULT_CONFIG.backend.local_map_min_inliers


# ---------------------------------------------------------------- the CPU

def test_local_map_kernel_wrapper_refuses_cpu_tensors():
    with pytest.raises(ValueError, match="CUDA"):
        local_map_gn_cuda(*make_local_map(M=64), *cams())


def _no_cuda_call():
    raise AssertionError("the wrapper reached the CUDA library before its checks")


@pytest.mark.parametrize("bad,match", [
    (dict(w_disp=lambda a: a.to("meta")), "w_disp is on meta"),
    (dict(T_init=lambda a: a.double()), "T_init"),
    (dict(matched=lambda a: a.float()), "matched"),
    (dict(disp_obs=lambda a: a[:-1]), "disp_obs"),
    (dict(Xw=lambda a: a[:, :2]), "Xw"),
    (dict(uv_obs=lambda a: a[..., :1]), "uv_obs"),
    (dict(uv_obs=lambda a: a.t().contiguous().t()), "uv_obs must be contiguous"),
    (dict(T_init=lambda a: a.t()), "T_init must be contiguous"),
])
def test_local_map_wrapper_checks_raise_before_any_cuda_call(monkeypatch, bad, match):
    monkeypatch.setattr(k4_module, "_lib", _no_cuda_call)
    kw = dict(zip(("T_init", "Xw", "uv_obs", "disp_obs", "w_disp", "matched"),
                  make_local_map(M=64)))
    (name, fix), = bad.items()
    kw[name] = fix(kw[name])
    with pytest.raises(ValueError, match=match):
        local_map_gn_cuda(**kw, fx=1.0, fy=1.0, cx=0.0, cy=0.0, bf=1.0)


@pytest.mark.parametrize("kw", [dict(gn_iters=-1), dict(rounds=-1)])
def test_local_map_wrapper_refuses_negative_counts(monkeypatch, kw):
    monkeypatch.setattr(k4_module, "_lib", _no_cuda_call)
    with pytest.raises(ValueError, match="must be >= 0"):
        local_map_gn_cuda(*make_local_map(M=8), *cams(), **kw)


@pytest.mark.parametrize("depth", [True, False])
def test_auto_on_cpu_tensors_is_the_plain_version(depth):
    args = make_local_map(M=300, seed=3, depth=depth)
    before = local_map_gn_cuda.launches
    Ta, na = local_map_gn_auto(*args, *cams())
    Tp, np_ = local_map_gn(*args, *cams())
    assert local_map_gn_cuda.launches == before
    assert torch.equal(Ta, Tp) and torch.equal(na, np_)
    assert na.dtype == torch.int64 and Ta.shape == (4, 4)
    assert (Ta - args[0]).abs().max() > 1e-2          # the solve moved the pose
    assert int(na) > MIN_INLIERS


@pytest.mark.parametrize("M", [0, 1, 50])
def test_map_without_a_match_returns_the_init_pose(M):
    """No matched point: every weight is 0, H the damping alone, g 0, so
    each step is exp(0) and the pose stays T_init exactly; 0 inliers."""
    T_init, Xw, uv, disp, wd, matched = make_local_map(M=max(M, 1), seed=5)[:6]
    args = (T_init, Xw[:M], uv[:M], disp[:M], wd[:M] * 0, torch.zeros(M, dtype=torch.bool))
    T, n = local_map_gn_auto(*args, *cams())
    assert torch.equal(T, T_init) and int(n) == 0


def test_local_map_problem_is_seeded():
    """The problem generator that these tests and ``chip_smoke.py
    --k4-only`` share: one seed gives one problem; the disparity weights
    follow the match and depth masks; no depth leaves every disparity row
    weightless."""
    a, b = make_local_map(M=500, seed=4), make_local_map(M=500, seed=4)
    for x, y in zip(a, b):
        assert torch.equal(x, y)
    assert not torch.equal(a[2], make_local_map(M=500, seed=5)[2])
    T_init, Xw, uv, disp, wd, matched = a
    assert 0.8 < float(matched.float().mean()) < 0.9
    assert (wd[~matched] == 0).all() and (wd[matched] > 0).float().mean() > 0.8
    assert (make_local_map(M=500, seed=4, depth=False)[4] == 0).all()


@pytest.fixture(scope="module")
def cpu_live_counts():
    """A short live run on the CPU, fused and unfused TrackLocalMap: the
    refinements dispatched and the ``local_map/gn/k4`` counter."""
    D = C.DEFAULT_CONFIG
    frames = make_multimover_frames(n_frames=3)
    out = {}
    for fused in (True, False):
        cfg = dataclasses.replace(
            D, camera=synth_camera_config(),
            frontend=dataclasses.replace(D.frontend, n_features=1000, n_levels=4),
            padding=dataclasses.replace(D.padding, n_static_max=512, n_obj_pts_max=2048,
                                        n_per_obj_max=1024, k_obj_max=4, k_obj_solve=2),
            backend=dataclasses.replace(D.backend, window_refine=False,
                                        joint_window_refine=False, fused_refine=fused))
        s = MultiMotSystem(cfg, keyframe_gap=1, enable_loop_closing=False, device="cpu")
        before = local_map_gn_cuda.launches
        for fd in frames:
            s.track_rgbd(fd)
        s.flush()
        out[fused] = (s.n_lm_dispatched, s.stage_counts.get("local_map/gn/k4"),
                      local_map_gn_cuda.launches - before)
    return out


@pytest.mark.parametrize("fused", [True, False])
def test_counter_reads_zero_on_every_cpu_local_map_call(cpu_live_counts, fused):
    n_calls, counts, launches = cpu_live_counts[fused]
    assert n_calls >= 1
    assert counts == [0] * n_calls
    assert launches == 0


# ---------------------------------------------------------------- the card

@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the CUDA kernels have no CPU mode")
    return torch.device("cuda", 0)


def both(args, dev):
    """(K4, plain) on the card on the same inputs."""
    a = [x.to(dev) for x in args]
    k = local_map_gn_cuda(*a, *cams())
    p = local_map_gn(*a, *cams())
    torch.cuda.synchronize()
    return k, p


def rejected(T, n):
    """The gate's verdict on a result: too few inliers or not finite."""
    return int(n) < MIN_INLIERS or not bool(torch.isfinite(T).all())


@pytest.mark.gpu
@pytest.mark.parametrize("outliers", [0.0, 0.1])
@pytest.mark.parametrize("depth", [True, False])
@pytest.mark.parametrize("M", [1, 1000, 1024, 2048, 3072, 5000])
def test_local_map_kernel_matches_plain_version(cuda_device, M, depth, outliers):
    args = make_local_map(M=M, seed=M + 7 * depth, depth=depth, outlier_frac=outliers)
    before = local_map_gn_cuda.launches
    (Tk, nk), (Tp, np_) = both(args, cuda_device)
    assert local_map_gn_cuda.launches == before + 1
    assert nk.dtype == torch.int64 and Tk.dtype == torch.float32
    if M == 1:
        assert rejected(Tk, nk) and rejected(Tp, np_)
        return
    assert torch.isfinite(Tk).all()
    assert float((Tk - Tp).abs().max()) <= POSE_ATOL, float((Tk - Tp).abs().max())
    assert abs(int(nk) - int(np_)) <= COUNT_TOL, (int(nk), int(np_))
    assert float((Tk.cpu() - args[0]).abs().max()) > 1e-2     # the solve moved the pose
    assert not rejected(Tk, nk)


@pytest.mark.gpu
@pytest.mark.parametrize("depth", [True, False])
@pytest.mark.parametrize("M", [1000, 3072, 5000])
def test_local_map_kernel_as_accurate_as_plain(cuda_device, M, depth):
    """K4 and the plain version in float32 against the plain version in
    float64, 10 % outliers."""
    args = make_local_map(M=M, seed=100 + M, depth=depth)
    (Tk, _), (Tp, _) = both(args, cuda_device)
    T64, _ = local_map_gn(*[x.to(cuda_device).double() if x.is_floating_point()
                            else x.to(cuda_device) for x in args], *cams())
    ek = float((Tk.double() - T64).abs().max())
    ep = float((Tp.double() - T64).abs().max())
    assert ek <= max(2 * ep, F64_FLOOR), (ek, ep)


@pytest.mark.gpu
@pytest.mark.parametrize("M", [1000, 3072, 5000])
def test_local_map_kernel_repeats_bit_for_bit(cuda_device, M):
    a = [x.to(cuda_device) for x in make_local_map(M=M, seed=11)]
    T1, n1 = local_map_gn_cuda(*a, *cams())
    T2, n2 = local_map_gn_cuda(*a, *cams())
    assert torch.equal(T1, T2) and torch.equal(n1, n2)


@pytest.mark.gpu
def test_local_map_kernel_nan_init_is_rejected(cuda_device):
    a = [x.to(cuda_device) for x in make_local_map(M=1024, seed=12)]
    a[0] = torch.full_like(a[0], float("nan"))
    T, n = local_map_gn_cuda(*a, *cams())
    assert not bool(torch.isfinite(T).all()) and rejected(T, n)


@pytest.mark.gpu
def test_local_map_kernel_without_a_match(cuda_device):
    T_init, Xw, uv, disp, wd, _ = [x.to(cuda_device) for x in make_local_map(M=700, seed=13)]
    none = torch.zeros(700, dtype=torch.bool, device=cuda_device)
    for M in (0, 700):
        T, n = local_map_gn_cuda(T_init, Xw[:M], uv[:M], disp[:M], wd[:M] * 0, none[:M], *cams())
        assert torch.equal(T, T_init) and int(n) == 0


def _live_config(fused=True):
    D = C.DEFAULT_CONFIG
    return dataclasses.replace(D, backend=dataclasses.replace(D.backend, fused_refine=fused))


@pytest.mark.gpu
def test_live_system_launches_k4_once_per_local_map_call(cuda_device):
    """The live system on the card, fused and unfused: one K4 launch and a
    ``local_map/gn/k4`` count of 1 per local-map call."""
    from multimot_track_tpu_torch.io.synth import KITTI_SYNTH_CAM, make_junction_frames

    frames = make_junction_frames(n_frames=8, cam=dict(KITTI_SYNTH_CAM))
    for fused in (True, False):
        s = MultiMotSystem(_live_config(fused), keyframe_gap=1, device=cuda_device)
        before = local_map_gn_cuda.launches
        out = [s.track_rgbd(fd) for fd in frames] + [s.flush()]
        assert all(np.isfinite(r.Tcw_cur).all() for r in out if r is not None)
        n = local_map_gn_cuda.launches - before
        assert s.n_lm_dispatched >= len(frames) - 2, (fused, s.n_lm_dispatched)
        assert n == s.n_lm_dispatched, (fused, n, s.n_lm_dispatched)
        assert s.stage_counts["local_map/gn/k4"] == [1] * n


@pytest.mark.gpu
def test_live_junction_with_k4_follows_the_plain_version(cuda_device, monkeypatch):
    """20 junction frames at DEFAULT_CONFIG with K4, then with the plain
    version forced through the auto route: the same acceptance on every
    frame, the delivered and the recorded poses within 1e-4 m."""
    from multimot_track_tpu_torch.io.synth import KITTI_SYNTH_CAM, make_junction_frames

    frames = make_junction_frames(n_frames=20, cam=dict(KITTI_SYNTH_CAM))

    def run():
        s = MultiMotSystem(_live_config(), device=cuda_device)
        out = [s.track_rgbd(fd) for fd in frames] + [s.flush()]
        return s, np.stack([r.Tcw_cur for r in out if r is not None])

    before = local_map_gn_cuda.launches
    sk, Tk = run()
    assert local_map_gn_cuda.launches - before == sk.n_lm_dispatched > 0
    monkeypatch.setattr(keyframes, "local_map_gn_auto",
                        lambda *a, **kw: local_map_gn(*a, **kw))
    before = local_map_gn_cuda.launches
    sp, Tp = run()
    assert local_map_gn_cuda.launches == before
    assert sk.n_lm_dispatched == sp.n_lm_dispatched
    assert sk.lm_accepted_frames == sp.lm_accepted_frames and sk.lm_accepted_frames
    assert Tk.shape == Tp.shape == (len(frames) - 1, 4, 4)     # the first frame has no pair
    assert np.abs(Tk[:, :3, 3] - Tp[:, :3, 3]).max() <= LIVE_POSE_ATOL
    Pk, Pp = (np.stack([np.asarray(P) for P in s.map.camera_poses]) for s in (sk, sp))
    assert np.abs(Pk[:, :3, 3] - Pp[:, :3, 3]).max() <= LIVE_POSE_ATOL



# a benchmark seed whose second junction drive fails the cell's limits at frame 28
# with K4 on the main path and passes them with the plain version
JUNCTION_SEED = 2718281807


@pytest.mark.gpu
def test_k4_matches_plain_on_every_local_map_call_of_a_benchmark_drive(cuda_device,
                                                                        monkeypatch):
    """A whole drive of the benchmark's ``live-junction`` cell (its 144
    frames under one seed's noise, on the fresh system of the cell's second
    drive) with K4 on the main path, the plain version run beside it on the
    same inputs at every local-map call: every call within the poses' 1e-4
    and the counts' 2 of the module's tolerances.  Whole trajectories are
    not compared here: a stage after the local map turns their float32
    differences of ~1e-5 m into poses 0.155 m apart at frame 28 at this
    seed (PERF.md section 7)."""
    from portbench import harness, inputs

    cell = harness.Cell("live-junction")
    clean, _ = inputs.clean_frames(cell)
    live = cell.entry().make(cell, inputs.noisy_frames(cell, clean, JUNCTION_SEED),
                             JUNCTION_SEED, False, "cuda")
    del clean
    calls = []

    def both(*a, **kw):
        Tk, nk = local_map_gn_auto(*a, **kw)
        Tp, np_ = local_map_gn(*a, **kw)
        calls.append((float((Tk - Tp).abs().max()), int(nk), int(np_)))
        return Tk, nk

    monkeypatch.setattr(keyframes, "local_map_gn_auto", both)
    before = local_map_gn_cuda.launches
    s = live.system(1)
    for fd in live.fds:
        s.track_rgbd(fd, uploaded=s.upload(fd))
    s.flush()
    assert len(live.fds) == 144
    assert local_map_gn_cuda.launches - before == len(calls) == s.n_lm_dispatched >= 130
    bad = [(i, c) for i, c in enumerate(calls)
           if not (c[0] <= POSE_ATOL and abs(c[1] - c[2]) <= COUNT_TOL)]
    assert not bad, bad
