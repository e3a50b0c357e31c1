"""The table of peaks and each kernel's least time on its inputs: a frozen
copy of ``chip_smoke.py``'s ``k1_bound_us`` / ``k2_bound_us`` and their
constants, so that a later change to the program cannot move the yardstick.

A call's bound is the larger of the operations its inputs need over the
published peak and each input byte read once plus each output byte written
once over the memory rate; a kernel's roofline share is the sum of its
calls' bounds over the sum of their device times.  Peaks: NVIDIA's data
sheet for the H100 SXM at its 700 W limit (dense, no sparsity).
"""

from __future__ import annotations

H100_FP32_FLOPS = 67e12        # float32 outside the tensor cores
H100_INT8_OPS = 1979e12        # int8 tensor cores, dense
H100_BYTES_PER_S = 3.35e12     # HBM3

# K1 (csrc/flow_ba_lm.cu), float32 operations per point: per LM iteration
# (linearise, Schur terms, 21 + 6 products; back-substitution, trial
# objective) and once per solve (back-projection, lambda seed, initial
# objective; final chi2 and inlier sums)
K1_FLOPS_PER_POINT_ITER = 295
K1_FLOPS_PER_POINT_ONCE = 120
# K2 (csrc/match_projected.cu): a 256-wide +-1 dot product per gated pair
K2_OPS_PER_PAIR = 512


def k1_bound_us(M: int, N: int, point_iters: float, nbytes: int):
    """(us, 'operations' | 'bytes') for one K1 call of M instances of N
    points whose LM ran ``point_iters`` = sum over instances of (valid
    points x iterations), reading and writing ``nbytes`` in all."""
    flops = K1_FLOPS_PER_POINT_ONCE * M * N + K1_FLOPS_PER_POINT_ITER * float(point_iters)
    t_ops, t_bytes = flops / H100_FP32_FLOPS, nbytes / H100_BYTES_PER_S
    return 1e6 * max(t_ops, t_bytes), ("operations" if t_ops >= t_bytes else "bytes")


def k2_bound_us(n_pairs: int, nbytes: int):
    """(us, 'operations' | 'bytes') for one K2 call with ``n_pairs`` valid
    query / reference pairs inside the gate, reading and writing ``nbytes``."""
    t_ops, t_bytes = K2_OPS_PER_PAIR * n_pairs / H100_INT8_OPS, nbytes / H100_BYTES_PER_S
    return 1e6 * max(t_ops, t_bytes), ("operations" if t_ops >= t_bytes else "bytes")


def tensor_bytes(tensors) -> int:
    return sum(t.numel() * t.element_size() for t in tensors if t is not None)


def k2_gated_pairs(uv_a, valid_a, uv_b, valid_b, radius: float) -> int:
    """Valid query / reference pairs within ``radius`` pixels: the pairs
    whose descriptors K2 compares (queries in blocks, to bound memory)."""
    ua, va = uv_a.reshape(-1, 2), valid_a.reshape(-1)
    r2, n = float(radius) * float(radius), 0
    for i in range(0, ua.shape[0], 1024):
        d2 = ((ua[i:i + 1024, None, :] - uv_b[None]) ** 2).sum(-1)
        n += int(((d2 <= r2) & va[i:i + 1024, None] & valid_b[None]).sum())
    return n
