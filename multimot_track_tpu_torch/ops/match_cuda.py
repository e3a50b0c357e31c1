"""Kernel K2 on the card: projection-gated descriptor matching.

The kernel (csrc/match_projected.cu) replaces the TPU kernel
``multimot_track_tpu.ops.pallas_match.fused_match_projected``: per query it
returns the best and second-best gated Hamming distance and the best index
without forming the N x M matrix.  This wrapper checks its inputs,
allocates the outputs and the packed-bit scratch, launches on PyTorch's
current stream and raises if a launch is refused.
``match_projected_cuda.launches`` counts calls that launched.  The plain
version is ``ops/matching.match_projected_plain``; there is no fallback to
it here.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from multimot_track_tpu_torch import kernels


@functools.lru_cache(maxsize=None)
def _lib() -> ctypes.CDLL:
    """Build (at first use) and bind csrc/match_projected.cu's C interface."""
    lib = kernels.load("match_projected")
    vp, i, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    lib.match_projected_launch.argtypes = [vp] * 8 + [i, i, i, f] + [vp] * 4
    lib.match_projected_launch.restype = ctypes.c_int
    return lib


def _aligned(t: torch.Tensor) -> torch.Tensor:
    """Contiguous, and 16-byte aligned for the kernel's vector loads."""
    t = t.contiguous()
    return t if t.data_ptr() % 16 == 0 else t.clone()


def match_projected_cuda(
    desc_a: torch.Tensor,    # (..., N, 256) int8 sign form
    uv_pred: torch.Tensor,   # (..., N, 2) float32
    valid_a: torch.Tensor,   # (..., N) bool
    desc_b: torch.Tensor,    # (M, 256) int8 sign form, shared by the batch
    uv_b: torch.Tensor,      # (M, 2) float32
    valid_b: torch.Tensor,   # (M,) bool
    radius: float = 15.0,
):
    """Returns (best, second, idx), each (..., N): float32, float32, int64.
    Same contract as ``matching.match_projected_plain``; every leading axis
    of the queries is one batch of the single launch."""
    if not desc_a.is_cuda:
        raise ValueError("match_projected_cuda needs CUDA tensors; "
                         "use backend='torch' for CPU tensors")
    lead, n = tuple(desc_a.shape[:-2]), desc_a.shape[-2]
    m = desc_b.shape[0]
    dev = desc_a.device
    for name, t, shape, dtype in (
        ("desc_a", desc_a, lead + (n, 256), torch.int8),
        ("uv_pred", uv_pred, lead + (n, 2), torch.float32),
        ("valid_a", valid_a, lead + (n,), torch.bool),
        ("desc_b", desc_b, (m, 256), torch.int8),
        ("uv_b", uv_b, (m, 2), torch.float32),
        ("valid_b", valid_b, (m,), torch.bool),
    ):
        if tuple(t.shape) != shape or t.dtype != dtype or t.device != dev:
            raise ValueError(f"{name}: expected {shape} {dtype} on {dev}, "
                             f"got {tuple(t.shape)} {t.dtype} on {t.device}")
    if m < 1:
        raise ValueError("match_projected_cuda needs at least one reference")
    L = 1
    for s in lead:
        L *= s
    args = [_aligned(t) for t in (desc_a, uv_pred, valid_a.view(torch.uint8),
                                  desc_b, uv_b, valid_b.view(torch.uint8))]
    bits_a = torch.empty((L * n, 8), dtype=torch.int32, device=dev)
    bits_b = torch.empty((m, 8), dtype=torch.int32, device=dev)
    best = torch.empty(lead + (n,), dtype=torch.float32, device=dev)
    second = torch.empty(lead + (n,), dtype=torch.float32, device=dev)
    idx = torch.empty(lead + (n,), dtype=torch.int32, device=dev)
    lib = _lib()
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        rc = lib.match_projected_launch(
            *(t.data_ptr() for t in args), bits_a.data_ptr(), bits_b.data_ptr(),
            L, n, m, float(radius) * float(radius),
            best.data_ptr(), second.data_ptr(), idx.data_ptr(), stream,
        )
    if rc != 0:
        raise RuntimeError(f"match_projected launch failed with CUDA error {rc} "
                           f"(L={L}, N={n}, M={m})")
    if L * n > 0:                  # the C side launches nothing for empty queries
        match_projected_cuda.launches += 1
    return best, second, idx.to(torch.int64)


match_projected_cuda.launches = 0
