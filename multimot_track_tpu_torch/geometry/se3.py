"""SE(3) Lie-group operations on torch tensors with arbitrary leading batch
dimensions.

Port of ``multimot_track_tpu.geometry.se3``: transforms are (..., 4, 4),
the tangent is ``xi = (omega, upsilon)`` with rotation first, and updates
compose on the left, ``T <- exp(xi) @ T``.  The eps regularisation of
``exp_se3`` is kept: the flow-BA kernel (csrc/flow_ba_lm.cu) mirrors it so
that its LM trajectory matches the plain solver step for step.
"""

from __future__ import annotations

import torch

_EPS = 1e-8


def hat(omega: torch.Tensor) -> torch.Tensor:
    """so(3) hat operator: (..., 3) -> (..., 3, 3)."""
    ox, oy, oz = omega[..., 0], omega[..., 1], omega[..., 2]
    zero = torch.zeros_like(ox)
    return torch.stack(
        [
            torch.stack([zero, -oz, oy], -1),
            torch.stack([oz, zero, -ox], -1),
            torch.stack([-oy, ox, zero], -1),
        ],
        -2,
    )


def _eye3(like: torch.Tensor) -> torch.Tensor:
    return torch.eye(3, dtype=like.dtype, device=like.device)


def point_jacobian(y: torch.Tensor) -> torch.Tensor:
    """d(exp(xi) @ y) / d xi at xi = 0 for points y (..., 3): [-[y]x | I],
    (..., 3, 6)."""
    return torch.cat([-hat(y), _eye3(y).expand(y.shape[:-1] + (3, 3))], -1)


def exp_so3(omega: torch.Tensor) -> torch.Tensor:
    """Rodrigues: (..., 3) -> (..., 3, 3).  Safe at ||omega|| -> 0."""
    theta2 = (omega * omega).sum(-1)
    theta = torch.sqrt(theta2 + _EPS * _EPS)
    small = theta2 < 1e-10
    a = torch.where(small, 1.0 - theta2 / 6.0, torch.sin(theta) / theta)
    b = torch.where(small, 0.5 - theta2 / 24.0,
                    (1.0 - torch.cos(theta)) / (theta2 + _EPS * _EPS))
    K = hat(omega)
    return _eye3(omega) + a[..., None, None] * K + b[..., None, None] * (K @ K)


def log_so3(R: torch.Tensor) -> torch.Tensor:
    """Inverse Rodrigues: (..., 3, 3) -> (..., 3)."""
    trace = R[..., 0, 0] + R[..., 1, 1] + R[..., 2, 2]
    cos_t = torch.clamp((trace - 1.0) * 0.5, -1.0, 1.0)
    small = cos_t > 1.0 - 1e-6
    theta = torch.arccos(torch.where(small, torch.zeros_like(cos_t), cos_t))
    w = torch.stack(
        [R[..., 2, 1] - R[..., 1, 2], R[..., 0, 2] - R[..., 2, 0],
         R[..., 1, 0] - R[..., 0, 1]],
        -1,
    )
    sin_safe = torch.where(small, torch.ones_like(theta), torch.sin(theta))
    scale = torch.where(small, torch.full_like(theta, 0.5), theta / (2.0 * sin_safe))
    return scale[..., None] * w


def _so3_left_jacobian(omega: torch.Tensor) -> torch.Tensor:
    """V such that t = V @ upsilon in exp_se3."""
    theta2 = (omega * omega).sum(-1)
    theta = torch.sqrt(theta2 + _EPS * _EPS)
    K = hat(omega)
    small = theta2 < 1e-10
    b = torch.where(small, 0.5 - theta2 / 24.0,
                    (1.0 - torch.cos(theta)) / (theta2 + _EPS * _EPS))
    c = torch.where(small, 1.0 / 6.0 - theta2 / 120.0,
                    (theta - torch.sin(theta)) / (theta2 * theta + _EPS))
    return _eye3(omega) + b[..., None, None] * K + c[..., None, None] * (K @ K)


def exp_se3(xi: torch.Tensor) -> torch.Tensor:
    """se(3) exponential: (..., 6) tangent (omega, upsilon) -> (..., 4, 4)."""
    omega, ups = xi[..., :3], xi[..., 3:]
    R = exp_so3(omega)
    t = (_so3_left_jacobian(omega) @ ups[..., None])[..., 0]
    return make_T(R, t)


def _so3_left_jacobian_inv(omega: torch.Tensor) -> torch.Tensor:
    """Closed-form V^{-1} = I - K/2 + (1/theta^2 - (1+cos)/(2 theta sin)) K^2."""
    theta2 = (omega * omega).sum(-1)
    theta = torch.sqrt(theta2 + _EPS * _EPS)
    K = hat(omega)
    small = theta2 < 1e-10
    denom = torch.where(small, torch.ones_like(theta), 2.0 * theta * torch.sin(theta))
    c = torch.where(
        small,
        1.0 / 12.0 + theta2 / 720.0,
        1.0 / torch.clamp(theta2, min=_EPS * _EPS) - (1.0 + torch.cos(theta)) / denom,
    )
    return _eye3(omega) - 0.5 * K + c[..., None, None] * (K @ K)


def log_se3(T: torch.Tensor) -> torch.Tensor:
    """(..., 4, 4) -> (..., 6) tangent (omega, upsilon)."""
    omega = log_so3(T[..., :3, :3])
    ups = (_so3_left_jacobian_inv(omega) @ T[..., :3, 3:4])[..., 0]
    return torch.cat([omega, ups], -1)


def make_T(R: torch.Tensor, t: torch.Tensor) -> torch.Tensor:
    """Assemble (..., 4, 4) from (..., 3, 3) and (..., 3)."""
    batch = torch.broadcast_shapes(R.shape[:-2], t.shape[:-1])
    top = torch.cat([R.expand(batch + (3, 3)), t.expand(batch + (3,))[..., None]], -1)
    bottom = torch.zeros(batch + (1, 4), dtype=R.dtype, device=R.device)
    bottom[..., 0, 3] = 1.0
    return torch.cat([top, bottom], -2)


def adjoint(T: torch.Tensor) -> torch.Tensor:
    """SE(3) adjoint for the (omega, upsilon) ordering:
    Ad(T) = [[R, 0], [hat(t) R, R]] (..., 6, 6); T exp(xi) T^-1 = exp(Ad(T) xi)."""
    R = T[..., :3, :3]
    top = torch.cat([R, torch.zeros_like(R)], -1)
    bottom = torch.cat([hat(T[..., :3, 3]) @ R, R], -1)
    return torch.cat([top, bottom], -2)


def inverse(T: torch.Tensor) -> torch.Tensor:
    """Rigid inverse."""
    Rt = T[..., :3, :3].transpose(-1, -2)
    return make_T(Rt, -(Rt @ T[..., :3, 3:4])[..., 0])


def transform(T: torch.Tensor, pts: torch.Tensor) -> torch.Tensor:
    """Apply (..., 4, 4) to a point set (..., N, 3) sharing batch dims."""
    R = T[..., None, :3, :3]
    t = T[..., None, :3, 3]
    x0, x1, x2 = pts[..., 0], pts[..., 1], pts[..., 2]
    return torch.stack(
        [R[..., i, 0] * x0 + R[..., i, 1] * x1 + R[..., i, 2] * x2 + t[..., i]
         for i in range(3)],
        -1,
    )


# the JAX package's point-set form; ``transform`` already takes point sets
transform_points = transform


def rotation_angle_deg(R: torch.Tensor) -> torch.Tensor:
    """Rotation magnitude in degrees via the reference's clamped-trace
    formula (diagonal entries > 1 folded as 1 - (d - 1))."""
    d = torch.stack([R[..., 0, 0], R[..., 1, 1], R[..., 2, 2]], -1)
    d = torch.where(d > 1.0, 1.0 - (d - 1.0), d)
    cos_t = (d.sum(-1) - 1.0) * 0.5
    return torch.arccos(torch.clamp(cos_t, -1.0, 1.0)) * (180.0 / 3.1415926)


def euler_y_to_R(yaw: torch.Tensor) -> torch.Tensor:
    """R = Ry(yaw) as composed by the reference's KITTI object-pose parser
    (which adds pi/2 to the raw rotation_y before calling this)."""
    cy, sy = torch.cos(yaw), torch.sin(yaw)
    zero, one = torch.zeros_like(yaw), torch.ones_like(yaw)
    return torch.stack(
        [torch.stack([cy, zero, sy], -1), torch.stack([zero, one, zero], -1),
         torch.stack([-sy, zero, cy], -1)],
        -2,
    )
