"""Kernel K4 on the card: TrackLocalMap's stereo Gauss-Newton as one CUDA launch.

The kernel (csrc/local_map_gn.cu) replaces no TPU kernel: the JAX package
runs the local map's ``_gn_refine_stereo`` rounds as an XLA ``fori_loop``,
and the port's plain version, ``pipeline/keyframes.local_map_gn``, runs
them as a Python loop of eager ops, ~10,500 small launches and 32 host
syncs a call.  One CTA runs the whole schedule: the Huber rounds, the
inlier rounds and the inlier count at the final pose.  This wrapper only
checks the inputs, allocates the outputs with ``torch.empty``, launches
on PyTorch's current stream and raises if the launch is refused; it reads
nothing back.  ``local_map_gn_cuda.launches`` counts launches.  There is
no fallback to the plain version here.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from multimot_track_tpu_torch import kernels


@functools.lru_cache(maxsize=None)
def _lib() -> ctypes.CDLL:
    """Build (at first use) and bind csrc/local_map_gn.cu's C interface; set
    the kernel's shared-memory limit once per load."""
    lib = kernels.load("local_map_gn")
    vp, i, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    lib.local_map_gn_launch.argtypes = [vp] * 8 + [i] * 3 + [f] * 6 + [vp]
    lib.local_map_gn_launch.restype = i
    lib.local_map_gn_init.restype = i
    rc = lib.local_map_gn_init()
    if rc != 0:
        raise RuntimeError(f"local_map_gn: setting the shared-memory limit failed with CUDA error {rc}")
    return lib


def _check(T_init, Xw, uv_obs, disp_obs, w_disp, matched, gn_iters, rounds) -> int:
    """Raise ValueError on what the kernel does not take: a wrong shape or
    dtype, a tensor that is not contiguous, tensors off one CUDA device, a
    negative count of steps or rounds.  Returns M."""
    if Xw.dim() != 2 or Xw.shape[1] != 3:
        raise ValueError(f"Xw: expected (M, 3), got {tuple(Xw.shape)}")
    M = Xw.shape[0]
    f32 = torch.float32
    dev = Xw.device
    for name, t, shape, dtype in (("T_init", T_init, (4, 4), f32),
                                  ("Xw", Xw, (M, 3), f32),
                                  ("uv_obs", uv_obs, (M, 2), f32),
                                  ("disp_obs", disp_obs, (M,), f32),
                                  ("w_disp", w_disp, (M,), f32),
                                  ("matched", matched, (M,), torch.bool)):
        if tuple(t.shape) != shape or t.dtype != dtype:
            raise ValueError(f"{name}: expected {shape} {dtype}, got {tuple(t.shape)} {t.dtype}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous (strides {t.stride()})")
        if t.device != dev:
            raise ValueError(f"{name} is on {t.device}, Xw on {dev}")
    if gn_iters < 0 or rounds < 0:
        raise ValueError(f"gn_iters {gn_iters} and rounds {rounds} must be >= 0")
    if not Xw.is_cuda:
        raise ValueError("local_map_gn_cuda needs CUDA tensors; "
                         "use keyframes.local_map_gn for CPU tensors")
    return M


def local_map_gn_cuda(
    T_init: torch.Tensor,     # (4, 4) Tcw init
    Xw: torch.Tensor,         # (M, 3) local map points, world frame
    uv_obs: torch.Tensor,     # (M, 2) matched keypoints
    disp_obs: torch.Tensor,   # (M,) measured disparity
    w_disp: torch.Tensor,     # (M,) disparity row weight
    matched: torch.Tensor,    # (M,) bool
    fx: float, fy: float, cx: float, cy: float, bf: float,
    thresh: float = 3.0,
    gn_iters: int = 8,
    rounds: int = 2,
):
    """The whole local-map Gauss-Newton in one kernel launch.  Same contract
    as ``keyframes.local_map_gn``; contiguous float32 tensors (``matched``
    bool) on one CUDA device.  Returns (T (4, 4), n_inliers () int64)."""
    M = _check(T_init, Xw, uv_obs, disp_obs, w_disp, matched, gn_iters, rounds)
    dev = Xw.device
    T = torch.empty((4, 4), dtype=torch.float32, device=dev)
    n = torch.empty((), dtype=torch.int64, device=dev)
    with torch.cuda.device(dev):
        rc = _lib().local_map_gn_launch(
            T_init.data_ptr(), Xw.data_ptr(), uv_obs.data_ptr(), disp_obs.data_ptr(),
            w_disp.data_ptr(), matched.data_ptr(), T.data_ptr(), n.data_ptr(),
            M, int(gn_iters), int(rounds), float(fx), float(fy), float(cx), float(cy),
            float(bf), float(thresh), torch.cuda.current_stream(dev).cuda_stream,
        )
    if rc != 0:
        raise RuntimeError(f"local_map_gn launch failed with CUDA error {rc} (M={M})")
    local_map_gn_cuda.launches += 1
    return T, n


local_map_gn_cuda.launches = 0
