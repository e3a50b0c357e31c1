"""Kernel K1 on the card: the flow-BA LM solve as one CUDA launch per stage.

The kernel (csrc/flow_ba_lm.cu) replaces the TPU kernel
``multimot_track_tpu.solvers.flow_ba_pallas.solve_flow_ba_pallas``: one
thread block per instance runs the whole Levenberg-Marquardt loop.  This
wrapper lays the per-point inputs out as SoA planes, allocates the outputs,
launches on PyTorch's current stream and raises if the launch is refused.
``solve_flow_ba_cuda.launches`` counts launches.  The plain version is
``solvers/flow_ba.solve_flow_ba``; there is no fallback to it here.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from multimot_track_tpu_torch import kernels
from multimot_track_tpu_torch.solvers.flow_ba import FlowBAParams, FlowBAResult, world_points

_SMEM_LIMIT = 200 * 1024   # flow buffers go to global scratch above this


@functools.lru_cache(maxsize=None)
def _lib() -> ctypes.CDLL:
    """Build (at first use) and bind csrc/flow_ba_lm.cu's C interface."""
    lib = kernels.load("flow_ba_lm")
    vp, f, i = ctypes.c_void_p, ctypes.c_float, ctypes.c_int
    lib.flow_ba_lm_launch.argtypes = [vp] * 7 + [i, i, i] + [f] * 9 + [vp]
    lib.flow_ba_lm_launch.restype = ctypes.c_int
    lib.flow_ba_lm_smem_bytes.argtypes = [i]
    lib.flow_ba_lm_smem_bytes.restype = ctypes.c_size_t
    return lib


def solve_flow_ba_cuda(
    T_init: torch.Tensor,       # (M, 4, 4)
    Twl: torch.Tensor,          # (M, 4, 4)
    obs: torch.Tensor,          # (M, N, 2)
    flow_meas: torch.Tensor,    # (M, N, 2)
    depth: torch.Tensor,        # (M, N)
    valid: torch.Tensor,        # (M, N) bool
    fx: float, fy: float, cx: float, cy: float,
    params: FlowBAParams = FlowBAParams(),
    point_weight: torch.Tensor = None,
) -> FlowBAResult:
    """M flow-BA instances in one kernel launch.  Same contract as
    ``flow_ba.solve_flow_ba``; the tensors must be float32 on one CUDA
    device."""
    if not obs.is_cuda:
        raise ValueError("solve_flow_ba_cuda needs CUDA tensors; "
                         "use backend='torch' for CPU tensors")
    M, N = obs.shape[0], obs.shape[1]
    dev = obs.device
    for name, t, shape in (("T_init", T_init, (M, 4, 4)), ("Twl", Twl, (M, 4, 4)),
                           ("flow_meas", flow_meas, (M, N, 2)), ("depth", depth, (M, N)),
                           ("valid", valid, (M, N))):
        if tuple(t.shape) != shape or t.device != dev:
            raise ValueError(f"{name}: expected shape {shape} on {dev}, "
                             f"got {tuple(t.shape)} on {t.device}")
    f32 = torch.float32
    valid = valid & (depth > 0)
    wpt = (torch.ones((M, N), dtype=f32, device=dev) if point_weight is None
           else point_weight.to(f32).expand(M, N))
    Xw = world_points(Twl, obs, depth, fx, fy, cx, cy)
    planes = torch.stack(
        [Xw[..., 0], Xw[..., 1], Xw[..., 2], obs[..., 0], obs[..., 1],
         flow_meas[..., 0], flow_meas[..., 1], valid.to(f32), wpt], 1
    ).to(f32).contiguous()                                         # (M, 9, N)
    tin = T_init.to(f32).reshape(M, 16).contiguous()
    tout = torch.empty((M, 16), dtype=f32, device=dev)
    fout = torch.empty((M, 2, N), dtype=f32, device=dev)
    chi2 = torch.empty((M, N), dtype=f32, device=dev)
    stats = torch.empty((M, 4), dtype=f32, device=dev)
    lib = _lib()
    scratch = (torch.empty((M, 4, N), dtype=f32, device=dev)
               if lib.flow_ba_lm_smem_bytes(N) > _SMEM_LIMIT else None)
    p = params
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        rc = lib.flow_ba_lm_launch(
            tin.data_ptr(), planes.data_ptr(), tout.data_ptr(), fout.data_ptr(),
            chi2.data_ptr(), stats.data_ptr(),
            scratch.data_ptr() if scratch is not None else None,
            M, N, int(p.iters),
            float(p.reproj_info), float(p.prior_info), float(p.rp_thres), float(p.tau),
            float(p.rel_tol), float(fx), float(fy), float(cx), float(cy), stream,
        )
    if rc != 0:
        raise RuntimeError(f"flow_ba_lm launch failed with CUDA error {rc} (M={M}, N={N})")
    if M > 0:                      # the C side launches nothing for M == 0
        solve_flow_ba_cuda.launches += 1
    return FlowBAResult(
        T=tout.view(M, 4, 4),
        flow=fout.transpose(1, 2),
        chi2=chi2,
        inliers=valid & (chi2 <= p.rp_thres),
        n_inliers=stats[:, 0].to(torch.int64),
        mean_reproj=stats[:, 1],
    )


solve_flow_ba_cuda.launches = 0
