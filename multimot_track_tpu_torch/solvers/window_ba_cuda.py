"""Kernel K3 on the card: the trailing-window BA's LM as one CUDA launch.

The kernel (csrc/window_ba_lm.cu) replaces no TPU kernel: the JAX package
runs ``solvers/window_ba.solve_window_ba`` as an XLA ``while_loop``, and
the port's plain version runs it as a Python loop of eager ops, ~13,000
small launches a window.  One thread-block cluster runs the whole solve:
the frame-0 back-projection, the odometry targets, the seed of lambda and
exactly ``iters`` LM steps, then writes the poses, inverse depths and
chi2.  This wrapper only checks the inputs, allocates the outputs and a
scratch buffer with ``torch.empty``, launches on PyTorch's current stream
and raises if the launch is refused; it reads nothing back.
``solve_window_ba_cuda.launches`` counts launches.  The plain version is
``solvers/window_ba.solve_window_ba``; there is no fallback to it here.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from multimot_track_tpu_torch import kernels
from multimot_track_tpu_torch.solvers.window_ba import WindowBAParams, WindowBAResult

THREADS = 256         # threads per CTA, one track each per tile (csrc/window_ba_lm.cu kThreads)
MAX_CLUSTER = 8       # the portable cluster size
MAX_FRAMES = 16       # kMaxF: a reduced system of at most 6 x 15 = 90 unknowns


def cluster_plan(N: int) -> int:
    """CTAs in the window's cluster: the smallest power of two that gives
    each CTA at most one tile of 256 tracks, at most 8 (beyond that each
    CTA walks several tiles)."""
    C = 1
    while C < MAX_CLUSTER and C * THREADS < N:
        C *= 2
    return C


@functools.lru_cache(maxsize=None)
def _lib() -> ctypes.CDLL:
    """Build (at first use) and bind csrc/window_ba_lm.cu's C interface; set
    the kernel's shared-memory limit once per load."""
    lib = kernels.load("window_ba_lm")
    vp, i, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    lib.window_ba_lm_launch.argtypes = [vp] * 8 + [i] * 4 + [f] * 9 + [vp]
    lib.window_ba_lm_launch.restype = i
    lib.window_ba_lm_init.restype = i
    lib.window_ba_lm_max_frames.restype = i
    rc = lib.window_ba_lm_init()
    if rc != 0:
        raise RuntimeError(f"window_ba_lm: setting the shared-memory limit failed with CUDA error {rc}")
    if lib.window_ba_lm_max_frames() != MAX_FRAMES:
        raise RuntimeError("window_ba_lm: the kernel and the wrapper disagree on MAX_FRAMES")
    return lib


def _check(poses_init, uv, alive, depth0):
    """Raise ValueError on what the kernel does not take: a wrong shape or
    dtype, a tensor that is not contiguous, F outside 2..16, no track,
    tensors off one CUDA device."""
    if uv.dim() != 3 or uv.shape[2] != 2:
        raise ValueError(f"uv: expected (F, N, 2), got {tuple(uv.shape)}")
    F, N = uv.shape[0], uv.shape[1]
    if not 2 <= F <= MAX_FRAMES:
        raise ValueError(f"window of {F} frames: the kernel takes 2 to {MAX_FRAMES}")
    if N < 1:
        raise ValueError("the window has no track")
    f32 = torch.float32
    dev = uv.device
    for name, t, shape, dtype in (("poses_init", poses_init, (F, 4, 4), f32),
                                  ("uv", uv, (F, N, 2), f32),
                                  ("alive", alive, (F, N), torch.bool),
                                  ("depth0", depth0, (N,), f32)):
        if tuple(t.shape) != shape or t.dtype != dtype:
            raise ValueError(f"{name}: expected {shape} {dtype}, got {tuple(t.shape)} {t.dtype}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous (strides {t.stride()})")
        if t.device != dev:
            raise ValueError(f"{name} is on {t.device}, uv on {dev}")
    if not uv.is_cuda:
        raise ValueError("solve_window_ba_cuda needs CUDA tensors; "
                         "use solve_window_ba for CPU tensors")
    return F, N


def solve_window_ba_cuda(
    poses_init: torch.Tensor,   # (F, 4, 4) initial Tcw (pose[0] must be I)
    uv: torch.Tensor,           # (F, N, 2) track observations
    alive: torch.Tensor,        # (F, N) bool
    depth0: torch.Tensor,       # (N,) metric depth at the frame-0 observation
    fx: float, fy: float, cx: float, cy: float,
    params: WindowBAParams = WindowBAParams(),
) -> WindowBAResult:
    """One window in one kernel launch.  Same contract as
    ``window_ba.solve_window_ba``; contiguous float32 tensors (``alive``
    bool) on one CUDA device, 2 <= F <= 16."""
    F, N = _check(poses_init, uv, alive, depth0)
    D = 6 * (F - 1)
    C = cluster_plan(N)
    e = functools.partial(torch.empty, dtype=torch.float32, device=uv.device)
    poses, inv_depth, chi2, scratch = e((F, 4, 4)), e((N,)), e(()), e((D + 4, N))
    p = params
    dev = uv.device
    with torch.cuda.device(dev):
        rc = _lib().window_ba_lm_launch(
            poses_init.data_ptr(), uv.data_ptr(), alive.data_ptr(), depth0.data_ptr(),
            poses.data_ptr(), inv_depth.data_ptr(), chi2.data_ptr(), scratch.data_ptr(),
            F, N, C, int(p.iters), float(fx), float(fy), float(cx), float(cy),
            float(p.huber_px), float(p.huber_px ** 2), float(1.0 / p.depth_prior_sigma ** 2),
            float(p.tau), float(p.odo_prior_weight), torch.cuda.current_stream(dev).cuda_stream,
        )
    if rc != 0:
        raise RuntimeError(f"window_ba_lm launch failed with CUDA error {rc} "
                           f"(F={F}, N={N}, cluster {C})")
    solve_window_ba_cuda.launches += 1
    return WindowBAResult(poses=poses, inv_depth=inv_depth, chi2=chi2)


solve_window_ba_cuda.launches = 0
