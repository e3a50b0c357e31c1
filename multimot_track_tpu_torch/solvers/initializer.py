"""Two-view geometry of ``multimot_track_tpu.solvers.initializer``.

Ported so far: the DLT triangulation that keyframe point creation uses.
The monocular H/F initializer is not ported yet (ROADMAP item 19).
"""

from __future__ import annotations

import torch


def triangulate(P1: torch.Tensor, P2: torch.Tensor, p1: torch.Tensor, p2: torch.Tensor):
    """DLT triangulation: P (3, 4) projection matrices, p (..., 2) pixels;
    returns (..., 3).  The homogeneous divide keeps the nullspace vector's
    sign out of the result, and a vanishing last coordinate divides by
    1e-12 rather than by zero."""
    rows = torch.stack([
        p1[..., 0, None] * P1[2] - P1[0],
        p1[..., 1, None] * P1[2] - P1[1],
        p2[..., 0, None] * P2[2] - P2[0],
        p2[..., 1, None] * P2[2] - P2[1],
    ], -2)
    Xh = torch.linalg.svd(rows)[2][..., -1, :]
    w = Xh[..., 3:]
    return Xh[..., :3] / torch.where(w.abs() > 1e-12, w, torch.full_like(w, 1e-12))
