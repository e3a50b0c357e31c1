"""The hand-written CUDA kernels against their plain torch versions: K1
(csrc/flow_ba_lm.cu) and K2 (csrc/match_projected.cu).  Imports no jax, so
the GPU machine runs this file as is:

    python -m pytest --noconftest -m gpu tests/test_torch_kernels.py

Tests that need the card carry the ``gpu`` marker and skip without one (the
kernels have no CPU mode).  K1 tolerance: T atol 2e-4, inlier counts +-2,
mean reprojection rtol 5 % — float32 sums in another order, the contract of
the JAX package's Pallas kernel against XLA.  K2 is exact: integer Hamming
distances, the same gate rounding and the same tie order.
"""

import dataclasses

import numpy as np
import pytest
import torch

from multimot_track_tpu_torch.geometry import camera, se3
from multimot_track_tpu_torch.ops import matching
from multimot_track_tpu_torch.ops.match_cuda import match_projected_cuda
from multimot_track_tpu_torch.solvers import flow_ba, flow_ba_cuda
from multimot_track_tpu_torch.solvers.flow_ba_cuda import solve_flow_ba_cuda

torch.set_num_threads(1)

FX, FY, CX, CY = 721.5377, 721.5377, 609.5593, 172.854
T_ATOL, N_TOL, REPROJ_RTOL = 2e-4, 2, 0.05


def problems(M, N, seed=0, device="cpu"):
    """M seeded instances: points at 4-30 m, a true motion each, 0.05 px
    flow noise, 10 % gross outliers, 20 % invalid."""
    rng = np.random.default_rng(seed)
    uv = np.stack([rng.uniform(50, 1150, (M, N)), rng.uniform(50, 330, (M, N))], -1)
    depth = rng.uniform(4.0, 30.0, (M, N))
    t = lambda a: torch.from_numpy(np.asarray(a, np.float32))
    T_true = se3.exp_se3(t(rng.normal(0, 1, (M, 6)) * [0.004, 0.004, 0.004, 0.2, 0.05, 0.8]))
    X = camera.backproject(t(uv), t(depth), FX, FY, CX, CY)
    flow = camera.project(se3.transform(T_true, X), FX, FY, CX, CY).numpy() - uv
    flow += rng.normal(0, 0.05, flow.shape)
    out = rng.uniform(size=(M, N)) < 0.1
    flow[out] += rng.normal(0, 20.0, (int(out.sum()), 2))
    eye = torch.eye(4).expand(M, 4, 4)
    args = (eye, eye, t(uv), t(flow), t(depth), torch.from_numpy(rng.uniform(size=(M, N)) < 0.8))
    return tuple(a.to(device) for a in args), T_true


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the CUDA kernels have no CPU mode")
    return torch.device("cuda", 0)


def test_kernel_wrapper_refuses_cpu_tensors():
    args, _ = problems(1, 64)
    with pytest.raises(ValueError, match="CUDA"):
        solve_flow_ba_cuda(*args, FX, FY, CX, CY)


# K1's path shapes (live camera / object, batched camera / object, a
# two-instance camera stage), N without 128-lane alignment, 15000 points
# (more than one CTA's shared memory holds), and one that streams points
# beyond what a cluster holds on chip
PLAN_SHAPES = [(1, 2048), (18, 4096), (11, 2048), (198, 4096), (2, 2048), (3, 1000),
               (2, 15000), (1, 40000)]


@pytest.mark.parametrize("M,N", PLAN_SHAPES)
def test_cluster_plan_covers_every_point_once(M, N):
    C, P = flow_ba_cuda.cluster_plan(M, N)
    assert C in (1, 2, 4, 8) and P in (1, 2, 4, 8, 16)
    assert C == 1 or N >= C * flow_ba_cuda.THREADS
    slices = flow_ba_cuda.cta_slices(N, C, P)
    assert len(slices) == C
    seen = np.zeros(N, np.int64)
    for begin, held_end, end in slices:
        assert begin <= held_end <= end and held_end - begin <= P * flow_ba_cuda.THREADS
        seen[begin:end] += 1
    assert (seen == 1).all()
    streams = any(held_end < end for _, held_end, end in slices)
    assert streams == (N > C * flow_ba_cuda.MAX_P * flow_ba_cuda.THREADS)
    assert (flow_ba_cuda._scratch(M, N, C, P, "meta") is not None) == streams
    # one instance spread over 8 SMs; 144 or 72 CTAs of the live object stage
    # in one wave; the batched object stage in waves of small CTAs
    expect_c = {(1, 2048): (8,), (18, 4096): (4, 8), (11, 2048): (8,), (198, 4096): (2, 4)}
    assert C in expect_c.get((M, N), (C,))


def _no_cuda_call():
    raise AssertionError("the wrapper reached the CUDA library before its checks")


@pytest.mark.parametrize("bad,match", [
    (dict(depth=lambda a: a.double()), "depth"),
    (dict(T_init=lambda a: a.double()), "T_init"),
    (dict(valid=lambda a: a.float()), "valid"),
    (dict(valid=lambda a: a[:, :-1]), "valid"),
    (dict(obs=lambda a: torch.cat([a, a], 1)[:, ::2]), "obs: rows must be contiguous"),
    (dict(Twl=lambda a: a.transpose(1, 2)), "Twl: rows must be contiguous"),
    (dict(point_weight=lambda a: torch.ones(a.shape[1] + 1)), "point_weight"),
])
def test_wrapper_checks_raise_before_any_cuda_call(monkeypatch, bad, match):
    monkeypatch.setattr(flow_ba_cuda, "_lib", _no_cuda_call)
    (T0, Twl, obs, fm, depth, valid), _ = problems(3, 64)
    kw = dict(T_init=T0.contiguous(), Twl=Twl, obs=obs, flow_meas=fm, depth=depth,
              valid=valid, point_weight=None)
    (name, fix), = bad.items()
    kw[name] = fix(kw[name] if kw[name] is not None else depth)
    with pytest.raises(ValueError, match=match):
        solve_flow_ba_cuda(fx=FX, fy=FY, cx=CX, cy=CY, **kw)


def test_wrapper_takes_broadcast_poses_and_weights(monkeypatch):
    """A stride-0 Twl / T_init and an (N,) point weight pass the checks
    with instance stride 0 (no copy); only the device check then refuses
    the CPU tensors."""
    monkeypatch.setattr(flow_ba_cuda, "_lib", _no_cuda_call)
    (T0, Twl, obs, fm, depth, valid), _ = problems(3, 64)
    assert Twl.stride(0) == 0
    with pytest.raises(ValueError, match="needs CUDA tensors"):
        solve_flow_ba_cuda(T0, Twl, obs, fm, depth, valid, FX, FY, CX, CY,
                           point_weight=torch.ones(64))


@pytest.mark.gpu
@pytest.mark.parametrize("M,N,weighted,iters", [
    (2, 2048, True, 50),       # a camera stage (depth-weighted ego solve)
    (18, 4096, False, 100),    # an object stage
    (3, 1000, False, 50),      # N with no 128-lane alignment
    (2, 15000, False, 30),     # 1875 points per CTA of a cluster of 8
    (1, 2048, True, 50),       # the live camera stage: one instance on 8 SMs
    (2, 40000, False, 30),     # beyond 4096 points per CTA: streamed in the kernel
])
def test_cuda_kernel_matches_plain_version(cuda_device, M, N, weighted, iters):
    args, T_true = problems(M, N, seed=M * N, device=cuda_device)
    pw = 1.0 / (1.0 + (args[4] / 15.0) ** 2) if weighted else None
    p = flow_ba.FlowBAParams(iters=iters, prior_info=0.3 if weighted else 0.5,
                             rp_thres=0.04 if weighted else 0.01)
    before = solve_flow_ba_cuda.launches
    k = solve_flow_ba_cuda(*args, FX, FY, CX, CY, params=p, point_weight=pw)
    torch.cuda.synchronize()
    assert solve_flow_ba_cuda.launches == before + 1
    r = flow_ba.solve_flow_ba(*args, FX, FY, CX, CY, params=p, point_weight=pw)
    np.testing.assert_allclose(k.T.cpu().numpy(), r.T.cpu().numpy(), atol=T_ATOL)
    np.testing.assert_allclose(k.T.cpu().numpy(), T_true.numpy(), atol=1e-2)
    assert int((k.n_inliers - r.n_inliers).abs().max()) <= N_TOL
    np.testing.assert_allclose(k.mean_reproj.cpu().numpy(), r.mean_reproj.cpu().numpy(),
                               rtol=REPROJ_RTOL, atol=1e-4)
    np.testing.assert_allclose(k.chi2.cpu().numpy(), r.chi2.cpu().numpy(), rtol=1e-2, atol=1e-4)


@pytest.mark.gpu
def test_cuda_kernel_matches_plain_version_batched_object_stage(cuda_device):
    """198 x 4096, the batched object stage, held to the contract with the
    plain version (pose, inlier counts, mean reprojection).  Over 198
    instances an LM stop can fall one iteration apart on float32 rounding,
    which moves a few points' flows by ~1e-2 px, so the per-point chi2 is
    held to the kernel's own pose and flow, and to the plain version on all
    but 1e-4 of the points."""
    M, N = 198, 4096
    args, T_true = problems(M, N, seed=M * N, device=cuda_device)
    p = flow_ba.FlowBAParams(iters=100, prior_info=0.5, rp_thres=0.01)
    k = solve_flow_ba_cuda(*args, FX, FY, CX, CY, params=p)
    r = flow_ba.solve_flow_ba(*args, FX, FY, CX, CY, params=p)
    np.testing.assert_allclose(k.T.cpu().numpy(), r.T.cpu().numpy(), atol=T_ATOL)
    np.testing.assert_allclose(k.T.cpu().numpy(), T_true.numpy(), atol=1e-2)
    assert int((k.n_inliers - r.n_inliers).abs().max()) <= N_TOL
    np.testing.assert_allclose(k.mean_reproj.cpu().numpy(), r.mean_reproj.cpu().numpy(),
                               rtol=REPROJ_RTOL, atol=1e-4)
    _, Twl, obs, _, depth, valid = args
    Xw = flow_ba.world_points(Twl, obs, depth, FX, FY, CX, CY)
    res = obs + k.flow - camera.project(se3.transform(k.T, Xw), FX, FY, CX, CY)
    own = p.reproj_info * (res * res).sum(-1)
    np.testing.assert_allclose(k.chi2.cpu().numpy(), own.cpu().numpy(), rtol=1e-3, atol=1e-5)
    close = torch.isclose(k.chi2, r.chi2, rtol=1e-2, atol=1e-4)
    assert int((~close).sum()) <= M * N // 10 ** 4
    assert torch.equal(k.inliers, (valid & (depth > 0)) & (k.chi2 <= p.rp_thres))


@pytest.mark.gpu
@pytest.mark.parametrize("M,N,weighted", [(1, 2048, True), (18, 4096, False), (2, 40000, False)])
def test_cuda_kernel_repeats_bit_for_bit(cuda_device, M, N, weighted):
    """Fixed-order cluster reductions, no atomics: two launches agree in
    every bit of every output."""
    args, _ = problems(M, N, seed=7, device=cuda_device)
    pw = 1.0 / (1.0 + (args[4] / 15.0) ** 2) if weighted else None
    a = solve_flow_ba_cuda(*args, FX, FY, CX, CY, point_weight=pw)
    b = solve_flow_ba_cuda(*args, FX, FY, CX, CY, point_weight=pw)
    for x, y in zip(a, b):
        assert torch.equal(x, y)


@pytest.mark.gpu
def test_cuda_kernel_broadcast_inputs_equal_materialised(cuda_device):
    """A stride-0 Twl and an (N,) point weight read the same numbers as
    their materialised copies, so the outputs are identical."""
    M, N = 5, 3000
    args, _ = problems(M, N, seed=3, device=cuda_device)
    T0, _, obs, fm, depth, valid = args
    Twl = se3.exp_se3(torch.tensor([[0.01, -0.02, 0.005, 0.3, -0.1, 0.8]],
                                   device=cuda_device))[0].expand(M, 4, 4)
    pw = torch.linspace(0.2, 1.0, N, device=cuda_device)
    p = flow_ba.FlowBAParams(iters=50)
    a = solve_flow_ba_cuda(T0, Twl, obs, fm, depth, valid, FX, FY, CX, CY, params=p,
                           point_weight=pw)
    b = solve_flow_ba_cuda(T0.contiguous(), Twl.contiguous(), obs, fm, depth, valid,
                           FX, FY, CX, CY, params=p,
                           point_weight=pw.expand(M, N).contiguous())
    for x, y in zip(a, b):
        assert torch.equal(x, y)
    r = flow_ba.solve_flow_ba(T0, Twl, obs, fm, depth, valid, FX, FY, CX, CY, params=p,
                              point_weight=pw)
    np.testing.assert_allclose(a.T.cpu().numpy(), r.T.cpu().numpy(), atol=T_ATOL)
    assert int((a.n_inliers - r.n_inliers).abs().max()) <= N_TOL


@pytest.mark.gpu
def test_slice_through_kernel_matches_plain_and_counts_launches(cuda_device):
    from multimot_track_tpu_torch import config as C
    from multimot_track_tpu_torch.io.synth import make_multimover_frames, synth_camera_config
    from multimot_track_tpu_torch.pipeline import batch

    D = C.DEFAULT_CONFIG
    cfg = dataclasses.replace(
        D, camera=synth_camera_config(),
        padding=dataclasses.replace(D.padding, n_static_max=1024, n_obj_pts_max=4096,
                                    k_obj_max=4, k_obj_solve=2))
    frames = make_multimover_frames(n_frames=4)
    solve_flow_ba_cuda.launches = 0
    Tk, rk, reck = batch.run_sequence_batched(frames, cfg, seed=1, device=cuda_device,
                                              max_pairs_per_call=2)
    assert solve_flow_ba_cuda.launches == 5 * 2          # 2 chunks of pairs
    Tp, rp, recp = batch.run_sequence_batched(frames, cfg, seed=1, device=cuda_device,
                                              max_pairs_per_call=2, backend="torch")
    np.testing.assert_allclose(Tk, Tp, atol=1e-3)
    np.testing.assert_array_equal(rk.objects.active, rp.objects.active)
    assert [r["track_id"] for r in reck] == [r["track_id"] for r in recp]


def match_problem(L, N, M, radius, seed=0, device="cpu"):
    """Seeded K2 inputs at a path shape: descriptors drawn from a small pool
    (exact ties), 10 % invalid rows on both sides, points on the gate
    radius, and one query whose every candidate is out of range."""
    rng = np.random.default_rng(seed)
    pool = np.where(rng.uniform(size=(32, 256)) < 0.5, 1, -1).astype(np.int8)

    def draw(n):
        d = pool[rng.integers(32, size=n)].copy()
        flip = rng.uniform(size=(n, 256)) < 0.02
        return np.where(flip & (rng.uniform(size=(n, 1)) < 0.5), -d, d)

    desc_b = draw(M)
    uv_b = np.round(rng.uniform(0, [1242, 375], (M, 2))).astype(np.float32)
    desc_a = draw(L * N).reshape(L, N, 256)
    uv_a = uv_b[rng.integers(M, size=(L, N))] + rng.normal(0, radius / 2, (L, N, 2))
    uv_a = uv_a.astype(np.float32)
    uv_a[0, :4] = uv_b[:4] + np.float32(radius) * np.array([1.0, 0.0], np.float32)
    uv_a[-1, -1] = (1e4, 1e4)
    va = rng.uniform(size=(L, N)) < 0.9
    vb = rng.uniform(size=M) < 0.9
    t = lambda a: torch.from_numpy(np.ascontiguousarray(a)).to(device)
    return tuple(map(t, (desc_a, uv_a, va, desc_b, uv_b, vb)))


def test_match_kernel_wrapper_refuses_cpu_tensors():
    with pytest.raises(ValueError, match="CUDA"):
        match_projected_cuda(*match_problem(1, 8, 8, 12.0), radius=12.0)


@pytest.mark.gpu
@pytest.mark.parametrize("L,N,M,radius", [
    (1, 3072, 1024, 12.0),     # TrackLocalMap: 3 keyframes x 1024 against the frame's 1024
    (4, 1024, 1024, 6.0),      # the fuse scan: 4 previous keyframes against the new one
    (2, 333, 77, 15.0),        # ragged query tile, references not a tile multiple
])
def test_match_kernel_equals_plain_version(cuda_device, L, N, M, radius):
    args = match_problem(L, N, M, radius, seed=L * N + M, device=cuda_device)
    before = match_projected_cuda.launches
    bk, sk, ik = match_projected_cuda(*args, radius=radius)
    torch.cuda.synchronize()
    assert match_projected_cuda.launches == before + 1
    bp, sp, ip = matching.match_projected_plain(*args, radius=radius)
    assert torch.equal(bk, bp) and torch.equal(sk, sp) and torch.equal(ik, ip)
    assert bool(((bk == sk) & (bk < 1e9)).any())          # ties were exercised
    assert float(bk[-1, -1]) == 1e9 and int(ik[-1, -1]) == 0
    r = matching.match_projected_auto(*args, radius=radius)
    assert match_projected_cuda.launches == before + 2
    assert torch.equal(r.idx, ip)
