"""Closed-form rigid 3D-3D alignment (Horn's quaternion method), batched.

Port of ``multimot_track_tpu.solvers.horn.rigid_align``: the dominant
eigenvector of Horn's symmetric 4x4 comes from 12 renormalised squarings
plus 4 power steps, so every RANSAC hypothesis is a handful of batched 4x4
products and det(R) = +1 by construction.  ``rigid_align_svd`` is the
Arun / Kabsch SVD form, the reference the tests hold it to.
"""

from __future__ import annotations

import torch


def _quat_to_rot(q: torch.Tensor) -> torch.Tensor:
    w, x, y, z = q[..., 0], q[..., 1], q[..., 2], q[..., 3]
    return torch.stack(
        [
            torch.stack([1 - 2 * (y * y + z * z), 2 * (x * y - w * z), 2 * (x * z + w * y)], -1),
            torch.stack([2 * (x * y + w * z), 1 - 2 * (x * x + z * z), 2 * (y * z - w * x)], -1),
            torch.stack([2 * (x * z - w * y), 2 * (y * z + w * x), 1 - 2 * (x * x + y * y)], -1),
        ],
        -2,
    )


def _dominant_quat(N: torch.Tensor, squarings: int = 12, power_iters: int = 4) -> torch.Tensor:
    """Dominant eigenvector of symmetric (..., 4, 4) by shifted
    squared-power iteration."""
    shift = N.abs().sum(-1).amax(-1)
    M = N + shift[..., None, None] * torch.eye(4, dtype=N.dtype, device=N.device)

    def renorm(M):
        return M / torch.clamp(M.abs().amax(dim=(-2, -1), keepdim=True), min=1e-30)

    M = renorm(M)
    for _ in range(squarings):
        M = renorm(M @ M)
    q = torch.tensor([1.0, 0.1, 0.2, 0.3], dtype=N.dtype, device=N.device).expand(N.shape[:-1])
    for _ in range(power_iters):
        q = (M @ q[..., None])[..., 0]
        q = q / torch.clamp(torch.linalg.vector_norm(q, dim=-1, keepdim=True), min=1e-30)
    return q


def _cross_covariance(src, dst, w):
    """Weighted centroids (..., 3) of ``src`` and ``dst`` and the
    cross-covariance (..., 3, 3) of the centred sets."""
    if w is None:
        w = torch.ones(src.shape[:-1], dtype=src.dtype, device=src.device)
    wn = w / torch.clamp(w.sum(-1, keepdim=True), min=1e-12)
    cs = (src * wn[..., None]).sum(-2)
    cd = (dst * wn[..., None]).sum(-2)
    s0 = src - cs[..., None, :]
    d0 = dst - cd[..., None, :]
    return cs, cd, (wn[..., :, None, None] * s0[..., :, None] * d0[..., None, :]).sum(-3)


def _pose(R, cs, cd):
    """(..., 4, 4) of the rotation ``R`` and the translation taking the
    centroid ``cs`` onto ``cd``."""
    t = cd - (R @ cs[..., None])[..., 0]
    T = torch.zeros(R.shape[:-2] + (4, 4), dtype=R.dtype, device=R.device)
    T[..., :3, :3] = R
    T[..., :3, 3] = t
    T[..., 3, 3] = 1.0
    return T


def rigid_align(src: torch.Tensor, dst: torch.Tensor, w: torch.Tensor = None) -> torch.Tensor:
    """Least-squares R, t with dst ~= R @ src + t.  src, dst: (..., N, 3);
    w: optional (..., N) weights.  Returns (..., 4, 4)."""
    cs, cd, H = _cross_covariance(src, dst, w)
    Sxx, Sxy, Sxz = H[..., 0, 0], H[..., 0, 1], H[..., 0, 2]
    Syx, Syy, Syz = H[..., 1, 0], H[..., 1, 1], H[..., 1, 2]
    Szx, Szy, Szz = H[..., 2, 0], H[..., 2, 1], H[..., 2, 2]
    N = torch.stack(
        [
            torch.stack([Sxx + Syy + Szz, Syz - Szy, Szx - Sxz, Sxy - Syx], -1),
            torch.stack([Syz - Szy, Sxx - Syy - Szz, Sxy + Syx, Szx + Sxz], -1),
            torch.stack([Szx - Sxz, Sxy + Syx, Syy - Sxx - Szz, Syz + Szy], -1),
            torch.stack([Sxy - Syx, Szx + Sxz, Syz + Szy, Szz - Sxx - Syy], -1),
        ],
        -2,
    )
    return _pose(_quat_to_rot(_dominant_quat(N)), cs, cd)


def rigid_align_svd(src: torch.Tensor, dst: torch.Tensor, w: torch.Tensor = None) -> torch.Tensor:
    """Arun / Kabsch SVD form of ``rigid_align`` (a reference for tests):
    the rotation from the cross-covariance's SVD, with a reflection folded
    into the last singular direction."""
    cs, cd, H = _cross_covariance(src, dst, w)
    U, _, Vt = torch.linalg.svd(H)
    V, Ut = Vt.transpose(-1, -2), U.transpose(-1, -2)
    D = torch.diag_embed(torch.ones(H.shape[:-1], dtype=H.dtype, device=H.device))
    D[..., 2, 2] = torch.linalg.det(V @ Ut)
    return _pose(V @ D @ Ut, cs, cd)
