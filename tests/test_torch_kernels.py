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
import time

import numpy as np
import pytest
import torch

from multimot_track_tpu_torch.geometry import camera, se3
from multimot_track_tpu_torch.ops import match_cuda, matching
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
    plain = dataclasses.replace(cfg, solver=dataclasses.replace(cfg.solver,
                                                                flow_ba_backend="torch"))
    Tp, rp, recp = batch.run_sequence_batched(frames, plain, seed=1, device=cuda_device,
                                              max_pairs_per_call=2)
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
    (1, 3072, 3072, 15.0),     # window tracks: one frame's keypoints against the next's
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


# K2's plan: path shapes, a ragged query count, M = 1, M not a multiple of
# C * T, and M beyond one tile of every CTA of a cluster of 8
MATCH_PLAN_SHAPES = [(3072, 1024), (4096, 1024), (3072, 3072), (1024, 1024), (2048, 1024),
                     (999, 1024), (666, 77), (300, 1), (1400, 1001), (64, 12000),
                     (5000, 40000)]


@pytest.mark.parametrize("rows,M", MATCH_PLAN_SHAPES)
def test_match_plan_covers_every_reference_once(rows, M):
    C = match_cuda.match_plan(rows, M)
    T = match_cuda.THREADS_PER_QUERY
    assert C in (1, 2, 4, 8) and C <= match_cuda.MAX_CLUSTER
    assert match_cuda.smem_bytes() <= 48 * 1024            # static: at most 48 KB
    assert 2 * match_cuda.smem_bytes() <= 227 * 1024        # two CTAs per SM
    slices = match_cuda.ref_slices(M, C)
    seen = np.zeros(M, np.int64)
    end = 0
    for b, e in slices:                    # ascending and contiguous, in merge order
        assert b <= e and (b == e or b == end)
        seen[b:e] += 1
        end = max(end, e)
    assert (seen == 1).all()
    S = -(-M // C)
    tiles = sum(-(-(min(r * S + S, M) - min(r * S, M)) // match_cuda.SLOTS) for r in range(C))
    assert len(slices) == tiles * T
    assert all(e - b <= -(-match_cuda.SLOTS // T) for b, e in slices)
    clusters = -(-rows // (match_cuda.THREADS // T))
    assert C == 1 or clusters <= match_cuda.RESIDENT[C]      # one wave
    # the path shapes in one wave: 8-24 clusters of 8 (64-192 CTAs); the
    # fuse scan's 32 clusters in clusters of 4
    expect = {(1024, 1024): 8, (2048, 1024): 8, (3072, 1024): 8, (3072, 3072): 8,
              (4096, 1024): 4}
    assert C == expect.get((rows, M), C)
    assert M >= C * T * match_cuda.MIN_REFS or C == 1       # no thread short of work
    if M >= 12000:
        assert tiles > C                   # some CTA walks its share in several tiles


@pytest.mark.parametrize("bad,match", [
    (dict(desc_a=lambda a: a.float()), "desc_a"),
    (dict(uv_pred=lambda a: a.double()), "uv_pred"),
    (dict(valid_a=lambda a: a.to(torch.uint8)), "valid_a"),
    (dict(desc_b=lambda a: a[:, :128]), "desc_b"),
    (dict(valid_b=lambda a: a[:-1]), "valid_b"),
    (dict(desc_b=lambda a: a[:0], uv_b=lambda a: a[:0], valid_b=lambda a: a[:0]),
     "at least one reference"),
])
def test_match_wrapper_checks_raise_before_any_cuda_call(monkeypatch, bad, match):
    monkeypatch.setattr(match_cuda, "_lib", _no_cuda_call)
    names = ("desc_a", "uv_pred", "valid_a", "desc_b", "uv_b", "valid_b")
    kw = dict(zip(names, match_problem(2, 24, 40, 12.0)))
    for name, fix in bad.items():
        kw[name] = fix(kw[name])
    with pytest.raises(ValueError, match=match):
        match_projected_cuda(**kw, radius=12.0)


# layouts the kernel cannot read in place: (input, view of it, alignment the
# kernel needs), each with the same values as the contiguous tensor
MATCH_LAYOUTS = {
    "desc_a strided": ("desc_a", lambda a: torch.stack([a, a], -1)[..., 0], 16),
    "uv_pred transposed": ("uv_pred", lambda a: a.transpose(0, 1).contiguous().transpose(0, 1), 8),
    "uv_pred column slice": ("uv_pred", lambda a: torch.cat([a, a], -1)[..., :2], 8),
    "valid_b strided": ("valid_b", lambda a: torch.stack([a, a], 1)[:, 0], 1),
    "uv_b offset": ("uv_b", lambda a: torch.cat([a.new_zeros(1), a.flatten()])[1:].view(-1, 2), 8),
    "desc_b offset": ("desc_b", lambda a: torch.cat([a.new_zeros(8), a.flatten()])[8:].view(-1, 256),
                      16),
}


@pytest.mark.parametrize("case", list(MATCH_LAYOUTS))
def test_match_wrapper_copies_a_layout_it_cannot_read(case):
    """The JAX function takes any layout; K2's wrapper hands the kernel a
    contiguous, aligned copy of an input it cannot read in place, and the
    input itself when it can."""
    name, view, align = MATCH_LAYOUTS[case]
    names = ("desc_a", "uv_pred", "valid_a", "desc_b", "uv_b", "valid_b")
    t = dict(zip(names, match_problem(2, 24, 40, 12.0)))[name]
    v = view(t)
    assert torch.equal(v, t) and not (v.is_contiguous() and v.data_ptr() % align == 0)
    r = match_cuda._readable(v, align)
    assert r.is_contiguous() and r.data_ptr() % align == 0 and torch.equal(r, t)
    assert match_cuda._readable(t, align) is t


@pytest.mark.gpu
@pytest.mark.parametrize("case", list(MATCH_LAYOUTS))
def test_match_kernel_any_layout_equals_contiguous_call(cuda_device, case):
    name, view, _ = MATCH_LAYOUTS[case]
    names = ("desc_a", "uv_pred", "valid_a", "desc_b", "uv_b", "valid_b")
    kw = dict(zip(names, match_problem(2, 300, 500, 12.0, seed=5, device=cuda_device)))
    want = match_projected_cuda(**kw, radius=12.0)
    kw[name] = view(kw[name])
    got = match_projected_cuda(**kw, radius=12.0)
    for x, y in zip(got, want):
        assert torch.equal(x, y)


def _merge(lo, hi):
    """The kernel's merge of a lower slice's (best, second, idx) with the
    next higher slice's."""
    take = hi[0] < lo[0]
    return (torch.where(take, hi[0], lo[0]),
            torch.where(take, torch.minimum(hi[1], lo[0]), torch.minimum(lo[1], hi[0])),
            torch.where(take, hi[2], lo[2]))


def _match_variant(args, variant):
    desc_a, uv_a, va, desc_b, uv_b, vb = args
    if variant == "identical":             # every gated distance 0: ties everywhere
        desc_a = desc_b[:1].expand(desc_a.shape).clone()
        desc_b = desc_b[:1].expand(desc_b.shape).clone()
    elif variant == "no_valid_refs":       # every candidate gated out
        vb = torch.zeros_like(vb)
    return desc_a, uv_a, va, desc_b, uv_b, vb


@pytest.mark.parametrize("L,N,M,radius,variant", [
    (2, 333, 1001, 15.0, "ties"),
    (1, 64, 12000, 15.0, "ties"),          # three tiles per CTA
    (3, 100, 1024, 12.0, "identical"),
    (2, 100, 77, 15.0, "no_valid_refs"),
    (1, 50, 1, 15.0, "ties"),
])
def test_match_merge_rule_equals_full_plain(L, N, M, radius, variant):
    """The plain version on each thread's slice of the references (indices
    offset), merged in ascending order by the kernel's rule, equals the
    plain version on all of them: ties, all-gated rows and empty slices."""
    args = _match_variant(match_problem(L, N, M, radius, seed=M + N), variant)
    desc_a, uv_a, va, desc_b, uv_b, vb = args
    C = match_cuda.match_plan(L * N, M)
    inf = torch.full((L, N), float("inf"))
    acc = (inf, inf, torch.zeros((L, N), dtype=torch.int64))
    n_empty = 0
    for b, e in match_cuda.ref_slices(M, C):
        if b == e:
            part = inf, inf, torch.zeros_like(acc[2])
            n_empty += 1
        else:
            best, second, idx = matching.match_projected_plain(
                desc_a, uv_a, va, desc_b[b:e], uv_b[b:e], vb[b:e], radius)
            part = best, second, idx + b
        acc = _merge(acc, part)
    full = matching.match_projected_plain(*args, radius=radius)
    for x, y in zip(acc, full):
        assert torch.equal(x, y)
    if variant == "no_valid_refs":
        assert (full[0] == 1e9).all() and (full[2] == 0).all()
    if M == 1:
        assert n_empty > 0


MATCH_EDGE_CASES = {
    "M=1": (1, 300, 1, 15.0, "ties"),
    "M not a multiple of C*T": (2, 700, 1001, 12.0, "ties"),
    "tiled shared memory": (1, 640, 12000, 15.0, "ties"),
    "identical descriptors": (3, 256, 1024, 12.0, "identical"),
    "no valid reference": (2, 300, 500, 15.0, "no_valid_refs"),
    "ragged query tile": (3, 333, 1024, 12.0, "ties"),
    "every pair gated in": (1, 300, 700, 2000.0, "ties"),
}


@pytest.mark.gpu
@pytest.mark.parametrize("case", list(MATCH_EDGE_CASES))
def test_match_kernel_edge_cases_equal_plain_version(cuda_device, case):
    L, N, M, radius, variant = MATCH_EDGE_CASES[case]
    args = _match_variant(match_problem(L, N, M, radius, seed=L * N + M, device=cuda_device),
                          variant)
    bk, sk, ik = match_projected_cuda(*args, radius=radius)
    bp, sp, ip = matching.match_projected_plain(*args, radius=radius)
    assert torch.equal(bk, bp) and torch.equal(sk, sp) and torch.equal(ik, ip)
    assert ik.dtype == torch.int64


@pytest.mark.gpu
def test_match_kernel_one_device_kernel_and_repeats(cuda_device):
    """One device kernel per call and nothing else on the stream; two
    launches agree in every bit.  The profiler's warm-up step takes one
    untimed call, as chip_smoke.py's phase 5 does."""
    from torch.profiler import ProfilerActivity, profile, schedule

    args = match_problem(1, 3072, 1024, 12.0, seed=11, device=cuda_device)
    first = match_projected_cuda(*args, radius=12.0)
    torch.cuda.synchronize()
    before = match_projected_cuda.launches
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA],
                 schedule=schedule(wait=0, warmup=1, active=1, repeat=1)) as prof:
        for _ in range(2):
            again = match_projected_cuda(*args, radius=12.0)
            torch.cuda.synchronize()
            time.sleep(0.002)
            prof.step()
    kernels = [e.name for e in prof.events()
               if e.device_type == torch.autograd.DeviceType.CUDA
               and not e.name.startswith("ProfilerStep")]
    assert len(kernels) == 1 and "match_projected_kernel" in kernels[0], kernels
    assert match_projected_cuda.launches == before + 2
    for x, y in zip(first, again):
        assert torch.equal(x, y)


@pytest.mark.gpu
def test_match_kernel_no_queries_launches_nothing(cuda_device):
    desc_a, uv_a, va, desc_b, uv_b, vb = match_problem(1, 8, 64, 12.0, device=cuda_device)
    before = match_projected_cuda.launches
    best, second, idx = match_projected_cuda(desc_a[:, :0], uv_a[:, :0], va[:, :0],
                                             desc_b, uv_b, vb, radius=12.0)
    assert best.shape == second.shape == idx.shape == (1, 0) and idx.dtype == torch.int64
    assert match_projected_cuda.launches == before
