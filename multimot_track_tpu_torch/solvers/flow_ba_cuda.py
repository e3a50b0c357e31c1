"""Kernel K1 on the card: the flow-BA LM solve as one CUDA launch per stage.

The kernel (csrc/flow_ba_lm.cu) replaces the TPU kernel
``multimot_track_tpu.solvers.flow_ba_pallas.solve_flow_ba_pallas``: one
thread-block cluster per instance runs the whole Levenberg-Marquardt loop.
The kernel reads the caller's tensors as they are (back-projection, the
validity mask and the point weights happen on the card), so this wrapper
only checks them, allocates the outputs with ``torch.empty``, launches on
PyTorch's current stream and raises if the launch is refused.
``solve_flow_ba_cuda.launches`` counts launches.  The plain version is
``solvers/flow_ba.solve_flow_ba``; there is no fallback to it here.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from multimot_track_tpu_torch import kernels
from multimot_track_tpu_torch.solvers.flow_ba import FlowBAParams, FlowBAResult

SMS = 132             # streaming multiprocessors of an H100 SXM
THREADS = 256         # threads per CTA (csrc/flow_ba_lm.cu kThreads)
MAX_CLUSTER = 8       # the portable cluster size
MAX_P = 16            # held points per thread at most (kMaxP): 4096 per CTA
CTAS_PER_SM = {1: 1, 2: 2, 4: 2, 8: 2, 16: 1}   # ctas_per_sm<P>() in the kernel
CHAIN = 3             # an LM iteration's reductions and 6x6 solve, in points per thread


def cluster_plan(M: int, N: int) -> tuple[int, int]:
    """(C, P) for M instances of N points: C CTAs per instance (1, 2, 4 or
    8, at least 256 points per CTA) and P held points per thread (the
    smallest power of two with P * 256 >= ceil(N / C), at most 16).  C
    minimises a count of the time an LM iteration takes, waves x (points
    per thread + CHAIN): waves of CTAs at CTAS_PER_SM[P] per SM, each thread
    walking its points, then the fixed chain of the iteration's two cluster
    reductions and its 6x6 solve (CHAIN fitted to the card's times, see
    tools/k1_plan_sweep.py).  Ties go to the smaller C."""
    best = None
    for C in (1, 2, 4, 8):
        if C > 1 and C * THREADS > N:
            break
        S = -(-N // C)
        P = 1
        while P < MAX_P and P * THREADS < S:
            P *= 2
        waves = -(-M * C // (SMS * CTAS_PER_SM[P]))
        cost = waves * (-(-S // THREADS) + CHAIN)
        if best is None or cost < best[0]:
            best = (cost, C, P)
    return best[1], best[2]


def cta_slices(N: int, C: int, P: int) -> list[tuple[int, int, int]]:
    """Each CTA's points as the kernel cuts them: (begin, end of the points
    held in shared memory, end); the rest up to ``end`` are streamed."""
    S = -(-N // C)
    out = []
    for r in range(C):
        begin = min(r * S, N)
        end = begin + min(N - begin, S)
        out.append((begin, min(end, begin + P * THREADS), end))
    return out


@functools.lru_cache(maxsize=None)
def _lib() -> ctypes.CDLL:
    """Build (at first use) and bind csrc/flow_ba_lm.cu's C interface; set
    the kernels' shared-memory limit once per load."""
    lib = kernels.load("flow_ba_lm")
    vp, ll, f, i = ctypes.c_void_p, ctypes.c_longlong, ctypes.c_float, ctypes.c_int
    lib.flow_ba_lm_launch.argtypes = ([vp, ll] * 7 + [vp] * 8 + [i] * 5 + [f] * 9 + [vp])
    lib.flow_ba_lm_launch.restype = i
    lib.flow_ba_lm_init.restype = i
    lib.flow_ba_lm_max_held.restype = i
    lib.flow_ba_lm_ctas_per_sm.argtypes = [i]
    lib.flow_ba_lm_ctas_per_sm.restype = i
    rc = lib.flow_ba_lm_init()
    if rc != 0:
        raise RuntimeError(f"flow_ba_lm: setting the shared-memory limit failed with CUDA error {rc}")
    if lib.flow_ba_lm_max_held() != MAX_P * THREADS:
        raise RuntimeError("flow_ba_lm: the kernel and the wrapper disagree on MAX_P")
    return lib


def _rows_contiguous(t: torch.Tensor) -> bool:
    """Every dim but the first (the instance) is contiguous; the instance
    stride is free (0 for a broadcast)."""
    expect = 1
    for n, s in zip(reversed(t.shape[1:]), reversed(t.stride()[1:])):
        if n != 1 and s != expect:
            return False
        expect *= n
    return True


def _check(T_init, Twl, obs, flow_meas, depth, valid, point_weight):
    """Raise ValueError on what the kernel does not take: a wrong shape or
    dtype, rows that are not contiguous, tensors off one CUDA device.
    Returns the kernel's (pointer, instance stride) arguments."""
    if obs.dim() != 3 or obs.shape[2] != 2:
        raise ValueError(f"obs: expected (M, N, 2), got {tuple(obs.shape)}")
    M, N = obs.shape[0], obs.shape[1]
    f32 = torch.float32
    named = [("T_init", T_init, (M, 4, 4), f32), ("Twl", Twl, (M, 4, 4), f32),
             ("obs", obs, (M, N, 2), f32), ("flow_meas", flow_meas, (M, N, 2), f32),
             ("depth", depth, (M, N), f32), ("valid", valid, (M, N), torch.bool)]
    if point_weight is not None:
        pw_shape = (N,) if point_weight.dim() == 1 else (M, N)
        named.append(("point_weight", point_weight, pw_shape, f32))
    dev = obs.device
    args = []
    for name, t, shape, dtype in named:
        if tuple(t.shape) != shape or t.dtype != dtype:
            raise ValueError(f"{name}: expected {shape} {dtype}, got {tuple(t.shape)} {t.dtype}")
        if not _rows_contiguous(t):
            raise ValueError(f"{name}: rows must be contiguous (strides {t.stride()}); "
                             "only the instance stride may differ")
        if t.device != dev:
            raise ValueError(f"{name} is on {t.device}, obs on {dev}")
        args += [t.data_ptr(), 0 if t.dim() == 1 else t.stride(0)]
    if point_weight is None:
        args += [None, 0]
    if not obs.is_cuda:
        raise ValueError("solve_flow_ba_cuda needs CUDA tensors; "
                         "use backend='torch' for CPU tensors")
    return args


def _outputs(M, N, dev):
    """T, flow, chi2, inliers, n_inliers, mean_reproj, iterations."""
    e = functools.partial(torch.empty, device=dev)
    return (e((M, 4, 4)), e((M, N, 2)), e((M, N)), e((M, N), dtype=torch.bool),
            e((M,), dtype=torch.int64), e((M,)), e((M,), dtype=torch.int32))


def _scratch(M, N, C, P, dev):
    """Flow buffers of the points a CTA streams, when there are any."""
    if -(-N // C) <= P * THREADS:
        return None
    return torch.empty((M, 4, N), dtype=torch.float32, device=dev)


def _launch(args, outs, scratch, M, N, C, P, fx, fy, cx, cy, p: FlowBAParams):
    """One launch onto ``outs``; raises if the card refuses it."""
    dev = outs[0].device
    with torch.cuda.device(dev):
        rc = _lib().flow_ba_lm_launch(
            *args, *(o.data_ptr() for o in outs),
            scratch.data_ptr() if scratch is not None else None,
            M, N, C, P, int(p.iters),
            float(p.reproj_info), float(p.prior_info), float(p.rp_thres), float(p.tau),
            float(p.rel_tol), float(fx), float(fy), float(cx), float(cy),
            torch.cuda.current_stream(dev).cuda_stream,
        )
    if rc != 0:
        raise RuntimeError(f"flow_ba_lm launch failed with CUDA error {rc} "
                           f"(M={M}, N={N}, cluster {C}, {P} points per thread)")
    if M > 0:                      # the C side launches nothing for M == 0
        solve_flow_ba_cuda.launches += 1


def _launcher(T_init, Twl, obs, flow_meas, depth, valid, fx, fy, cx, cy,
              params: FlowBAParams = FlowBAParams(), point_weight=None):
    """A callable that launches the kernel once onto outputs allocated here,
    once, and returns each instance's LM iteration count: the bare launch
    that ``chip_smoke.py`` times.  It holds the inputs, whose pointers it
    passes on every call."""
    inputs = (T_init, Twl, obs, flow_meas, depth, valid, point_weight)
    args = _check(*inputs)
    M, N = obs.shape[0], obs.shape[1]
    C, P = cluster_plan(M, N)
    outs = _outputs(M, N, obs.device)
    scratch = _scratch(M, N, C, P, obs.device)

    def bare(inputs=inputs):
        _launch(args, outs, scratch, M, N, C, P, fx, fy, cx, cy, params)
        return outs[6]
    return bare


def solve_flow_ba_cuda(
    T_init: torch.Tensor,       # (M, 4, 4)
    Twl: torch.Tensor,          # (M, 4, 4), any instance stride (0: broadcast)
    obs: torch.Tensor,          # (M, N, 2)
    flow_meas: torch.Tensor,    # (M, N, 2)
    depth: torch.Tensor,        # (M, N)
    valid: torch.Tensor,        # (M, N) bool
    fx: float, fy: float, cx: float, cy: float,
    params: FlowBAParams = FlowBAParams(),
    point_weight: torch.Tensor = None,   # (M, N), (N,) or None
) -> FlowBAResult:
    """M flow-BA instances in one kernel launch.  Same contract as
    ``flow_ba.solve_flow_ba``; float32 tensors (``valid`` bool) on one CUDA
    device, each instance's rows contiguous."""
    args = _check(T_init, Twl, obs, flow_meas, depth, valid, point_weight)
    M, N = obs.shape[0], obs.shape[1]
    C, P = cluster_plan(M, N)
    outs = _outputs(M, N, obs.device)
    _launch(args, outs, _scratch(M, N, C, P, obs.device), M, N, C, P, fx, fy, cx, cy, params)
    T, flow, chi2, inliers, n_inliers, mean_reproj, _ = outs
    return FlowBAResult(T=T, flow=flow, chi2=chi2, inliers=inliers, n_inliers=n_inliers,
                        mean_reproj=mean_reproj)


solve_flow_ba_cuda.launches = 0
