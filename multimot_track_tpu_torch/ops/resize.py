"""``jax.image.resize(..., "linear")`` written out with its own weights.

The FAST pyramid (frontend/fast.py) and the half-resolution flow wire
(ops/wire.py) resize with JAX's separable triangle filter, which
antialiases when it downsamples: the kernel widens by 1/scale and every
output column's weights are renormalised to sum to one.
``torch.nn.functional.interpolate(antialias=True)`` comes within ~7e-3 grey
levels of it at pyramid level 1; building the same weight matrices in
float32 and contracting with them comes within float32 rounding, which
keeps the keypoint sets of the upper pyramid levels equal to the JAX
package's far more often.
"""

from __future__ import annotations

from typing import Sequence

import torch


def _weight_mat(in_size: int, out_size: int, device) -> torch.Tensor:
    """(in_size, out_size) float32 weights of ``compute_weight_mat`` for the
    triangle kernel, translation 0, antialias on."""
    f32 = torch.float32
    scale = out_size / in_size
    inv_scale = torch.tensor(1.0 / scale, dtype=f32, device=device)
    kernel_scale = torch.clamp(inv_scale, min=1.0)
    # XLA on the CPU contracts ``(i + 0.5) * inv_scale - 0.5`` into one fused
    # multiply-add; the float64 product of two float32 values is exact, so
    # rounding once after the subtraction gives the same sample positions
    sample_f = (
        (torch.arange(out_size, dtype=f32, device=device) + 0.5).double()
        * inv_scale.double() - 0.5
    ).to(f32)
    x = (sample_f[None, :] - torch.arange(in_size, dtype=f32, device=device)[:, None]).abs()
    x = x / kernel_scale
    w = torch.clamp(1.0 - x.abs(), min=0.0)
    total = w.sum(0, keepdim=True)
    eps = 1000.0 * torch.finfo(torch.float32).eps
    w = torch.where(total.abs() > eps,
                    w / torch.where(total != 0, total, torch.ones_like(total)),
                    torch.zeros_like(w))
    inside = (sample_f >= -0.5) & (sample_f <= in_size - 0.5)
    return torch.where(inside[None, :], w, torch.zeros_like(w))


def resize_linear(x: torch.Tensor, shape: Sequence[int]) -> torch.Tensor:
    """Resize ``x`` to ``shape`` (same rank) with JAX's "linear" method:
    every axis whose size changes is contracted with its weight matrix."""
    assert len(shape) == x.dim()
    out = x.to(torch.float32)
    for d, n in enumerate(shape):
        m = out.shape[d]
        if m == n:
            continue
        w = _weight_mat(m, n, out.device)                    # (m, n)
        out = torch.movedim(torch.movedim(out, d, -1) @ w, -1, d)
    return out
