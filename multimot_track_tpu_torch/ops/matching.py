"""Descriptor matching on torch tensors.

Port of ``multimot_track_tpu.ops.matching``: for {-1, +1} sign-form
descriptors the Hamming distance is (256 - s_a . s_b) / 2, so brute-force
matching is one float32 matrix product (every product is +-1 and every sum
an integer below 2^24, so the result is exact) followed by masks and a
best / second-best reduction.

What had to be written out to match ``jax.lax.top_k``: the best entry is
``argmin`` (the first minimum, so ties go to the lowest index) and the
second is the minimum with only that one entry masked, so a tied second
equals the best, as ``top_k`` gives.  ``rotation_consistency`` takes its
histogram top-k through ``fast.topk_stable``.

``match_projected`` is the plain version of kernel K2
(ops/match_cuda.py, csrc/match_projected.cu); ``match_projected_auto``
dispatches between the two with no fallback.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from multimot_track_tpu_torch.frontend.fast import topk_stable

TH_LOW = 50        # reference ORBmatcher::TH_LOW (best-match gate)
TH_HIGH = 100      # reference ORBmatcher::TH_HIGH
HISTO_BINS = 30    # rotation-consistency histogram bins (HISTO_LENGTH)
BIG = 1e9          # distance of a masked entry


class MatchResult(NamedTuple):
    idx: torch.Tensor      # (..., N) best match in B for each A (int64)
    dist: torch.Tensor     # (..., N) its distance
    valid: torch.Tensor    # (..., N) passed all gates


def hamming_matrix(desc_a: torch.Tensor, desc_b: torch.Tensor) -> torch.Tensor:
    """(..., N, 256) x (..., M, 256) sign-form int8 -> (..., N, M) float32;
    leading axes broadcast."""
    dots = desc_a.to(torch.float32) @ desc_b.to(torch.float32).transpose(-1, -2)
    return (desc_a.shape[-1] - dots) * 0.5


def best_two(D: torch.Tensor):
    """Row-wise (best, second, idx) of (..., M) distances with
    ``lax.top_k``'s tie order."""
    idx = torch.argmin(D, -1, keepdim=True)
    best = torch.gather(D, -1, idx)
    second = D.scatter(-1, idx, torch.full_like(best, BIG)).amin(-1)
    return best[..., 0], second, idx[..., 0]


def _mutual(D: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """best_for_b[idx] == arange(N) for (..., N, M) distances."""
    best_for_b = torch.argmin(D, -2)
    return (torch.gather(best_for_b, -1, idx)
            == torch.arange(D.shape[-2], device=D.device))


def match_descriptors(desc_a, desc_b, valid_a, valid_b, threshold: float = TH_LOW,
                      ratio: float = 0.9, mutual: bool = True) -> MatchResult:
    """Brute-force matching of (..., N, 256) against (..., M, 256) with the
    distance threshold, the best/second ratio and the mutual check; leading
    axes broadcast (one problem per batch entry)."""
    D = hamming_matrix(desc_a, desc_b)
    D = torch.where(valid_b[..., None, :] & valid_a[..., :, None], D, torch.full_like(D, BIG))
    best, second, idx = best_two(D)
    ok = valid_a & (best <= threshold) & (best < ratio * second)
    if mutual:
        ok = ok & _mutual(D, idx)
    return MatchResult(idx=idx, dist=best, valid=ok)


def projected_distances(desc_a, uv_pred, valid_a, desc_b, uv_b, valid_b, radius: float):
    """The gated (..., N, M) distance matrix K2 reduces without forming it:
    Hamming where both flags hold and ||uv_pred - uv_b||^2 <= r^2, else BIG."""
    D = hamming_matrix(desc_a, desc_b)
    d = uv_pred[..., :, None, :] - uv_b
    d2 = d[..., 0] * d[..., 0] + d[..., 1] * d[..., 1]
    ok = valid_a[..., :, None] & valid_b & (d2 <= radius * radius)
    return torch.where(ok, D, torch.full_like(D, BIG))


def match_projected_plain(desc_a, uv_pred, valid_a, desc_b, uv_b, valid_b,
                          radius: float = 15.0):
    """Plain torch version of K2: (best, second, idx), each (..., N)."""
    return best_two(projected_distances(desc_a, uv_pred, valid_a, desc_b, uv_b, valid_b,
                                        radius))


def _gate(best, second, idx, valid_a, threshold, ratio) -> MatchResult:
    ok = valid_a & (best <= threshold) & (best < ratio * second)
    return MatchResult(idx=idx, dist=best, valid=ok)


def match_projected(desc_a, uv_pred, valid_a, desc_b, uv_b, valid_b, radius: float = 15.0,
                    threshold: float = TH_HIGH, ratio: float = 0.9) -> MatchResult:
    """Projection-guided matching: candidates must lie within ``radius``
    pixels of A's predicted position.  Queries may carry leading batch
    axes (..., N, ·) against one shared reference set (M, ·)."""
    best, second, idx = match_projected_plain(desc_a, uv_pred, valid_a, desc_b, uv_b,
                                              valid_b, radius)
    return _gate(best, second, idx, valid_a, threshold, ratio)


def match_projected_auto(desc_a, uv_pred, valid_a, desc_b, uv_b, valid_b,
                         radius: float = 15.0, threshold: float = TH_HIGH,
                         ratio: float = 0.9, backend: str = "auto") -> MatchResult:
    """Backend dispatch, shaped like ``solvers.flow_ba.solve_flow_ba_auto``.
    ``"auto"``: kernel K2 for CUDA tensors, the plain version for CPU
    tensors.  ``"cuda"`` on a CPU tensor raises; ``"torch"`` forces the
    plain version.  A kernel that fails to build or launch raises.  Both
    routes take inputs of any layout, as the JAX function does: the kernel
    route copies an input it cannot read in place (not contiguous, or a
    view whose start is not aligned) to a contiguous one first."""
    if backend not in ("auto", "cuda", "torch"):
        raise ValueError(f"unknown match backend {backend!r}")
    if backend == "cuda" or (backend == "auto" and desc_a.is_cuda):
        from multimot_track_tpu_torch.ops.match_cuda import match_projected_cuda

        best, second, idx = match_projected_cuda(desc_a, uv_pred, valid_a, desc_b, uv_b,
                                                 valid_b, radius=radius)
        return _gate(best, second, idx, valid_a, threshold, ratio)
    return match_projected(desc_a, uv_pred, valid_a, desc_b, uv_b, valid_b,
                           radius=radius, threshold=threshold, ratio=ratio)


def match_float(desc_a, desc_b, valid_a, valid_b, ratio: float = 0.8,
                mutual: bool = True) -> MatchResult:
    """Float-descriptor matching (unit vectors): distance 2 - 2 a.b and
    Lowe's ratio test."""
    D = 2.0 - 2.0 * (desc_a @ desc_b.transpose(-1, -2))
    D = torch.where(valid_a[..., :, None] & valid_b[..., None, :], D, torch.full_like(D, BIG))
    best, second, idx = best_two(D)
    ok = valid_a & (best < ratio * ratio * second) & (best < 4.0)
    if mutual:
        ok = ok & _mutual(D, idx)
    return MatchResult(idx=idx, dist=best, valid=ok)


def search_by_quad(desc_L0, desc_R0, desc_L1, desc_R1, uv_pred, uv_L1, valid0, valid1,
                   radius: float = 15.0, threshold: float = TH_HIGH) -> MatchResult:
    """Quad-consistent stereo-temporal matching: a temporal match survives
    only if the same pairing is descriptor-consistent in all four views;
    the score is D_L + D_R under the spatial gate, both legs under the
    threshold."""
    DL = hamming_matrix(desc_L0, desc_L1)
    DR = hamming_matrix(desc_R0, desc_R1)
    d = uv_pred[:, None, :] - uv_L1[None, :, :]
    d2 = d[..., 0] * d[..., 0] + d[..., 1] * d[..., 1]
    ok = (valid0[:, None] & valid1[None, :] & (d2 <= radius * radius)
          & (DL <= threshold) & (DR <= threshold))
    D = torch.where(ok, DL + DR, torch.full_like(DL, BIG))
    best, second, idx = best_two(D)
    okm = valid0 & (best < BIG * 0.5) & (best < 0.9 * second)
    return MatchResult(idx=idx, dist=best, valid=okm)


def rotation_consistency(angle_a, angle_b, idx, valid, keep_bins: int = 3) -> torch.Tensor:
    """Keep only matches whose angle difference falls in the ``keep_bins``
    most popular of 30 bins (secondary bins at >= 10 % of the top one)."""
    dega = torch.rad2deg(angle_a - angle_b[idx])
    m = torch.fmod(dega, 360.0)                  # jnp's float % : fmod, then + 360
    dega = torch.where((m != 0) & (m < 0), m + 360.0, m)
    bins = torch.clamp((dega * (HISTO_BINS / 360.0)).to(torch.int32), 0, HISTO_BINS - 1)
    hist = torch.zeros(HISTO_BINS, dtype=torch.int32, device=idx.device)
    hist.index_add_(0, bins.to(torch.int64), valid.to(torch.int32))
    top_counts, top_bins = topk_stable(hist, keep_bins)
    strong = top_counts.to(torch.float32) >= 0.1 * top_counts[0].to(torch.float32)
    in_top = ((bins.to(torch.int64)[:, None] == top_bins[None, :]) & strong[None, :]).any(1)
    return valid & in_top
