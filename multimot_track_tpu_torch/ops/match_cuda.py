"""Kernel K2 on the card: projection-gated descriptor matching.

The kernel (csrc/match_projected.cu) replaces the TPU kernel
``multimot_track_tpu.ops.pallas_match.fused_match_projected``: per query it
returns the best and second-best gated Hamming distance and the best index
without forming the N x M matrix.  It packs the descriptors' signs on chip
and writes the int64 index itself, so this wrapper only checks its inputs
(copying one whose layout the kernel cannot read in place), allocates the
outputs with ``torch.empty``, launches once on PyTorch's
current stream and raises if the launch is refused.
``match_projected_cuda.launches`` counts launches.  The plain version is
``ops/matching.match_projected_plain``; there is no fallback to it here.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from multimot_track_tpu_torch import kernels

THREADS = 512         # threads per CTA (csrc/match_projected.cu kThreads)
SLOTS = 512           # references a CTA stages in shared memory per tile (kSlots)
THREADS_PER_QUERY = 4  # (kT), so a cluster takes THREADS / 4 = 128 queries
GATE_CHUNK = 8        # gate tests the kernel issues together (kChunk)
MAX_CLUSTER = 8       # the portable cluster size
MIN_REFS = 8          # references per thread below which a wider cluster does not pay
# clusters of C CTAs the card holds at once (cudaOccupancyMaxActiveClusters
# on an H100 SXM; chip_smoke.py checks it)
RESIDENT = {1: 264, 2: 132, 4: 62, 8: 30}


def match_plan(rows: int, M: int) -> int:
    """C, the CTAs of each cluster, for ``rows`` queries against ``M``
    references: each CTA owns ceil(M / C) of them.  C is the largest power
    of two up to 8 that leaves each thread MIN_REFS references, halved
    until all ceil(rows / 128) clusters fit on the card at once (RESIDENT),
    so the launch runs in one wave."""
    C = MAX_CLUSTER
    while C > 1 and M < C * THREADS_PER_QUERY * MIN_REFS:
        C //= 2
    while C > 1 and -(-rows // (THREADS // THREADS_PER_QUERY)) > RESIDENT[C]:
        C //= 2
    return C


def ref_slices(M: int, C: int) -> list[tuple[int, int]]:
    """Every thread's references as the kernel cuts them, in the order the
    kernel merges them: for each CTA rank its share ceil(M / C), for each
    tile of up to SLOTS references of the share, the THREADS_PER_QUERY
    threads' contiguous sub-slices [begin, end) (empty ones included)."""
    S, T = -(-M // C), THREADS_PER_QUERY
    out = []
    for r in range(C):
        b0, b1 = min(r * S, M), min(r * S + S, M)
        for j0 in range(b0, b1, SLOTS):
            n = min(SLOTS, b1 - j0)
            length = -(-n // T)
            out += [(j0 + min(t * length, n), j0 + min(t * length + length, n))
                    for t in range(T)]
    return out


def smem_bytes() -> int:
    """Static shared memory of one CTA, as the kernel lays it out: a tile's
    packed references (32 B) and padded positions (8 B), the packed queries
    (32 B) and the partial results (16 B, per query and cluster rank).
    The positions are padded by one per sub-slice and by one gate chunk."""
    q = THREADS // THREADS_PER_QUERY
    return (SLOTS * 32 + (SLOTS + THREADS_PER_QUERY + GATE_CHUNK) * 8 + q * 32
            + (q + MAX_CLUSTER) * 16)


@functools.lru_cache(maxsize=None)
def _lib() -> ctypes.CDLL:
    """Build (at first use) and bind csrc/match_projected.cu's C interface."""
    lib = kernels.load("match_projected")
    vp, i, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    lib.match_projected_launch.argtypes = [vp] * 9 + [i] * 3 + [f, vp]
    lib.match_projected_launch.restype = i
    lib.match_projected_empty_launch.argtypes = [i, i, vp]
    lib.match_projected_empty_launch.restype = i
    lib.match_projected_max_clusters.argtypes = [i]
    lib.match_projected_max_clusters.restype = i
    lib.match_projected_shape.argtypes = [ctypes.POINTER(i)] * 3
    threads, slots, per_query = i(), i(), i()
    lib.match_projected_shape(ctypes.byref(threads), ctypes.byref(slots), ctypes.byref(per_query))
    if (threads.value, slots.value, per_query.value) != (THREADS, SLOTS, THREADS_PER_QUERY):
        raise RuntimeError("match_projected: the kernel and the wrapper disagree on its shape")
    return lib


def _readable(t: torch.Tensor, align: int) -> torch.Tensor:
    """``t`` itself when the kernel can read it in place (contiguous and
    ``align``-byte aligned), else a contiguous copy, which a fresh
    allocation aligns."""
    if t.is_contiguous() and t.data_ptr() % align == 0:
        return t
    return t.clone(memory_format=torch.contiguous_format)


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
    of the queries is one batch of the single launch.  The kernel reads a
    contiguous tensor with descriptors 16-byte and positions 8-byte aligned
    in place (fresh allocations are); any other layout, such as a column
    slice ``uv[:, :2]`` or a view at an odd offset, is copied to one first."""
    lead, n = tuple(desc_a.shape[:-2]), desc_a.shape[-2]
    m = desc_b.shape[0]
    named = (("desc_a", desc_a, lead + (n, 256), torch.int8),
             ("uv_pred", uv_pred, lead + (n, 2), torch.float32),
             ("valid_a", valid_a, lead + (n,), torch.bool),
             ("desc_b", desc_b, (m, 256), torch.int8),
             ("uv_b", uv_b, (m, 2), torch.float32),
             ("valid_b", valid_b, (m,), torch.bool))
    dev = desc_a.device
    for name, t, shape, dtype in named:
        if tuple(t.shape) != shape or t.dtype != dtype:
            raise ValueError(f"{name}: expected {shape} {dtype}, got {tuple(t.shape)} {t.dtype}")
        if t.device != dev:
            raise ValueError(f"{name} is on {t.device}, desc_a on {dev}")
    if m < 1:
        raise ValueError("match_projected_cuda needs at least one reference")
    if not desc_a.is_cuda:
        raise ValueError("match_projected_cuda needs CUDA tensors; "
                         "use backend='torch' for CPU tensors")
    named = tuple((name, _readable(t, {torch.int8: 16, torch.float32: 8, torch.bool: 1}[dtype]),
                   shape, dtype) for name, t, shape, dtype in named)
    best = torch.empty(lead + (n,), dtype=torch.float32, device=dev)
    second = torch.empty(lead + (n,), dtype=torch.float32, device=dev)
    idx = torch.empty(lead + (n,), dtype=torch.int64, device=dev)
    rows = best.numel()
    if rows == 0:
        return best, second, idx
    C = match_plan(rows, m)
    with torch.cuda.device(dev):
        rc = _lib().match_projected_launch(
            *(t.data_ptr() for _, t, _, _ in named), best.data_ptr(), second.data_ptr(),
            idx.data_ptr(), rows, m, C,
            float(radius) * float(radius), torch.cuda.current_stream(dev).cuda_stream,
        )
    if rc != 0:
        raise RuntimeError(f"match_projected launch failed with CUDA error {rc} "
                           f"(rows={rows}, M={m}, cluster {C})")
    match_projected_cuda.launches += 1
    return best, second, idx


match_projected_cuda.launches = 0
