"""The hand-written CUDA kernel K1 (csrc/flow_ba_lm.cu) against its plain
torch version.  Imports no jax, so the GPU machine runs this file as is:

    python -m pytest -m gpu tests/test_torch_kernels.py

Tests that need the card carry the ``gpu`` marker and skip without one (the
kernel has no CPU mode).  Tolerance: T atol 2e-4, inlier counts +-2, mean
reprojection rtol 5 % — float32 sums in another order, the contract of the
JAX package's Pallas kernel against XLA.
"""

import dataclasses

import numpy as np
import pytest
import torch

from multimot_track_tpu_torch.geometry import camera, se3
from multimot_track_tpu_torch.solvers import flow_ba
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
        pytest.skip("needs a CUDA device: the flow-BA kernel has no CPU mode")
    return torch.device("cuda", 0)


def test_kernel_wrapper_refuses_cpu_tensors():
    args, _ = problems(1, 64)
    with pytest.raises(ValueError, match="CUDA"):
        solve_flow_ba_cuda(*args, FX, FY, CX, CY)


@pytest.mark.gpu
@pytest.mark.parametrize("M,N,weighted,iters", [
    (2, 2048, True, 50),       # a camera stage (depth-weighted ego solve)
    (18, 4096, False, 100),    # an object stage
    (3, 1000, False, 50),      # N with no 128-lane alignment
    (2, 15000, False, 30),     # flow buffers in global scratch, not shared memory
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
