"""Batched tiny SPD solves as unrolled elementwise ops.

Port of ``multimot_track_tpu.geometry.smallsolve``: the same unrolled
Cholesky (diagonal clamped at 1e-30) so that the plain flow-BA and the
RANSAC polish factor their 6x6 systems with the arithmetic the JAX package
and the CUDA kernel use, the adjugate 3x3 inverse of the flow+depth BA's
point blocks, and the LM loops' step acceptance with Nielsen's damping
schedule.
"""

from __future__ import annotations

import torch


def cholesky_unrolled(H: torch.Tensor, n: int) -> list:
    """Lower-triangular factor of SPD ``H`` (..., n, n) as an n x n list of
    batched scalars (None above the diagonal)."""
    L = [[None] * n for _ in range(n)]
    for i in range(n):
        for j in range(i + 1):
            s = H[..., i, j]
            for k in range(j):
                s = s - L[i][k] * L[j][k]
            if i == j:
                L[i][j] = torch.sqrt(torch.clamp(s, min=1e-30))
            else:
                L[i][j] = s / L[j][j]
    return L


def solve_spd(H: torch.Tensor, g: torch.Tensor, n: int) -> torch.Tensor:
    """x with H x = g for SPD H: (..., n, n) @ (..., n) -> (..., n)."""
    L = cholesky_unrolled(H, n)
    y = [None] * n
    for i in range(n):
        s = g[..., i]
        for k in range(i):
            s = s - L[i][k] * y[k]
        y[i] = s / L[i][i]
    x = [None] * n
    for i in reversed(range(n)):
        s = y[i]
        for k in range(i + 1, n):
            s = s - L[k][i] * x[k]
        x[i] = s / L[i][i]
    return torch.stack(x, -1)


def solve_spd6(H: torch.Tensor, g: torch.Tensor) -> torch.Tensor:
    """6x6 SPD solve (pose blocks)."""
    return solve_spd(H, g, 6)


def solve_spd3(H: torch.Tensor, g: torch.Tensor) -> torch.Tensor:
    """3x3 SPD solve (point blocks)."""
    return solve_spd(H, g, 3)


def inv_spd3(H: torch.Tensor) -> torch.Tensor:
    """Explicit symmetric 3x3 inverse via the adjugate (..., 3, 3); a
    determinant below 1e-30 in magnitude is taken as 1e-30."""
    a, b, c = H[..., 0, 0], H[..., 0, 1], H[..., 0, 2]
    d, e = H[..., 1, 1], H[..., 1, 2]
    f = H[..., 2, 2]
    A = d * f - e * e
    B = c * e - b * f
    C = b * e - c * d
    det = a * A + b * B + c * C
    inv_det = 1.0 / torch.where(det.abs() < 1e-30, torch.full_like(det, 1e-30), det)
    D = a * f - c * c
    E = b * c - a * e
    F = a * d - b * b
    rows = [torch.stack(r, -1) for r in ((A, B, C), (B, D, E), (C, E, F))]
    return torch.stack(rows, -2) * inv_det[..., None, None]


def nielsen_step(F, F_new, pred, lam, nu):
    """An LM step's acceptance and Nielsen's damping schedule.  The step is
    accepted where it lowers the objective F to a finite F_new; then lambda
    scales by max(1/3, 1 - (2 gain - 1)^3), gain the actual decrease over
    the predicted ``pred``, and nu resets to 2; else lambda scales by nu and
    nu doubles.  Returns (accept, lambda, nu)."""
    accept = (F_new < F) & torch.isfinite(F_new)
    gain = (F - F_new) / torch.clamp(pred, min=1e-20)
    lam_acc = lam * torch.clamp(1.0 - (2.0 * gain - 1.0) ** 3, min=1.0 / 3.0)
    return (accept, torch.where(accept, lam_acc, lam * nu),
            torch.where(accept, torch.full_like(nu, 2.0), nu * 2.0))
