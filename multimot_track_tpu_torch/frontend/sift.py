"""SIFT: DoG scale-space keypoints and 128-d descriptors on torch tensors.

Port of ``multimot_track_tpu.frontend.sift`` (the functional counterpart of
the reference's cudasift subsystem): every stage is a whole-image tensor
op on the image's device, no kernel of its own.

* ``_blur``: ``orb.gaussian_blur``'s separable ``conv2d``, zero padded (the
  JAX package's ``lax.conv``), at radius 3 sigma.
* ``_local_extrema``: the 26-neighbourhood test and the 2x2 Hessian edge
  ratio with ``torch.roll``, so the image borders wrap around as
  ``jnp.roll`` makes them, and are not padded.
* ``_top_k``: ``lax.top_k``'s order, largest first and ties to the lowest
  flat index (a stable descending sort).
* ``_orientation``: the 36-bin gradient histogram's argmax (bins that tie
  to float32 rounding, as a symmetric blob's do, go whichever way the
  summation order sends them, in either package).
* ``_descriptors``: the rotated 16x16 gradient patch binned 4x4x8, L2
  normalised, clipped at 0.2 and normalised again.

Matching uses ``ops/matching.match_float``.
"""

from __future__ import annotations

import functools
import math
from typing import NamedTuple

import numpy as np
import torch
import torch.nn.functional as Fnn

from multimot_track_tpu_torch.frontend.orb import _gather, gaussian_blur


class SiftKeypoints(NamedTuple):
    uv: torch.Tensor       # (N, 2) level-0 pixel coords
    scale: torch.Tensor    # (N,) sigma in level-0 pixels
    angle: torch.Tensor    # (N,) orientation (radians)
    score: torch.Tensor    # (N,) |DoG| response
    valid: torch.Tensor    # (N,)
    desc: torch.Tensor     # (N, 128) L2-normalised float32


def _blur(img: torch.Tensor, sigma: float) -> torch.Tensor:
    return gaussian_blur(img, sigma, radius=max(1, int(3.0 * sigma + 0.5)))


def _roll(x: torch.Tensor, dy: int, dx: int) -> torch.Tensor:
    return torch.roll(x, (dy, dx), (0, 1))


def _nbr(x: torch.Tensor, op) -> torch.Tensor:
    """``op`` (max or min) of ``x`` and its 8 rolled neighbours."""
    m = x
    for dy in (-1, 0, 1):
        for dx in (-1, 0, 1):
            if dy or dx:
                m = op(m, _roll(x, dy, dx))
    return m


def _local_extrema(dog_prev, dog, dog_next, thresh):
    """26-neighbourhood extremum test via rolled comparisons, then the
    edge rejection (FindPointsMulti's edgeLimit)."""
    mx, mn = torch.maximum, torch.minimum
    up_max = mx(_nbr(dog_prev, mx), mx(torch.roll(dog_prev, 0, 0), dog_prev))
    dn_max = _nbr(dog_next, mx)
    all_max = mx(_nbr(dog, mx), mx(up_max, mx(dn_max, mx(dog_prev, dog_next))))
    up_min = _nbr(dog_prev, mn)
    dn_min = _nbr(dog_next, mn)
    all_min = mn(_nbr(dog, mn), mn(mn(up_min, dn_min), mn(dog_prev, dog_next)))
    is_max = (dog >= all_max) & (dog > thresh)
    is_min = (dog <= all_min) & (dog < -thresh)
    dxx = _roll(dog, 0, -1) + _roll(dog, 0, 1) - 2 * dog
    dyy = _roll(dog, -1, 0) + _roll(dog, 1, 0) - 2 * dog
    dxy = 0.25 * (_roll(dog, -1, -1) + _roll(dog, 1, 1) - _roll(dog, -1, 1) - _roll(dog, 1, -1))
    tr = dxx + dyy
    det = dxx * dyy - dxy * dxy
    r = 10.0
    edge_ok = (det > 0) & (tr * tr * r < (r + 1.0) ** 2 * det)
    return (is_max | is_min) & edge_ok


def _top_k(x: torch.Tensor, k: int):
    """``lax.top_k`` of a 1-D tensor: the k largest, ties to the lowest index."""
    vals, idx = torch.sort(x, descending=True, stable=True)
    return vals[:k], idx[:k]


@functools.lru_cache(maxsize=None)
def _descriptor_weights() -> np.ndarray:
    """(16, 16, 4, 4) bilinear spatial weights of each pixel of a 16x16
    patch into the 4x4 descriptor grid, times the Gaussian window."""
    coords = (np.arange(16) + 0.5) / 4.0 - 0.5   # in bin units, 0..3
    wy = np.zeros((16, 4))
    for i, c in enumerate(coords):
        for b in range(4):
            wy[i, b] = max(0.0, 1.0 - abs(c - b))
    g = np.exp(-((np.arange(16) - 7.5) ** 2) / (2 * (8.0) ** 2))
    W = np.einsum("ia,jb->ijab", wy * g[:, None], wy * g[:, None])
    return W.astype(np.float32)


def _gradients(img: torch.Tensor):
    gx = 0.5 * (_roll(img, 0, -1) - _roll(img, 0, 1))
    gy = 0.5 * (_roll(img, -1, 0) - _roll(img, 1, 0))
    return gx, gy


def _descriptors(img, uv, scale, angle):
    """(N, 128) descriptors: rotated 16x16 gradient patch, 8 orientation
    bins with linear interpolation, bilinear spatial binning, L2 + clip."""
    H, W = img.shape
    gx, gy = _gradients(img)
    ar = torch.arange(16, device=img.device, dtype=torch.float32) - 7.5
    ox, oy = ar[None, None, :], ar[None, :, None]            # offsets (x along columns)
    c = torch.cos(angle)[:, None, None]
    s = torch.sin(angle)[:, None, None]
    step = (scale * 0.5)[:, None, None]
    px = uv[:, 0, None, None] + step * (c * ox + (-s) * oy)  # (N, 16, 16)
    py = uv[:, 1, None, None] + step * (s * ox + c * oy)
    xi = torch.clamp(torch.round(px).to(torch.int64), 0, W - 1)
    yi = torch.clamp(torch.round(py).to(torch.int64), 0, H - 1)
    pgx, pgy = _gather(gx, yi, xi), _gather(gy, yi, xi)
    mag = torch.sqrt(pgx * pgx + pgy * pgy)
    ori = torch.atan2(pgy, pgx) - angle[:, None, None]       # rotation invariant
    ob = torch.remainder(ori / (2 * math.pi) * 8.0, 8.0)     # fractional bin
    fl = torch.floor(ob)
    b0 = torch.remainder(fl.to(torch.int64), 8)
    b1 = torch.remainder(b0 + 1, 8)
    f = ob - fl
    obins = (Fnn.one_hot(b0, 8) * (1 - f)[..., None]
             + Fnn.one_hot(b1, 8) * f[..., None]) * mag[..., None]   # (N, 16, 16, 8)
    Wsp = torch.from_numpy(_descriptor_weights()).to(img.device)
    desc = torch.einsum("nyxo,yxab->nabo", obins, Wsp).reshape(-1, 128)
    desc = desc / torch.clamp(torch.linalg.vector_norm(desc, dim=-1, keepdim=True), min=1e-9)
    desc = torch.clamp(desc, max=0.2)                        # illumination clip
    return desc / torch.clamp(torch.linalg.vector_norm(desc, dim=-1, keepdim=True), min=1e-9)


def _orientation_hist(img, uv):
    """(N, 36) magnitude-weighted gradient-direction histograms over the
    17x17 window of each keypoint (Gaussian weight, sigma 4.5)."""
    H, W = img.shape
    gx, gy = _gradients(img)
    r = torch.arange(-8, 9, device=img.device)
    dy, dx = r[:, None].expand(17, 17), r[None, :].expand(17, 17)
    w_g = torch.exp((-(dx * dx + dy * dy)).to(torch.float32) / (2 * 4.5 ** 2))
    xi = torch.clamp(torch.round(uv[:, 0]).to(torch.int64)[:, None, None] + dx, 0, W - 1)
    yi = torch.clamp(torch.round(uv[:, 1]).to(torch.int64)[:, None, None] + dy, 0, H - 1)
    pgx, pgy = _gather(gx, yi, xi), _gather(gy, yi, xi)
    m = torch.sqrt(pgx ** 2 + pgy ** 2) * w_g
    o = torch.atan2(pgy, pgx)
    bins = torch.remainder(o / (2 * math.pi) * 36.0, 36.0).to(torch.int64)
    return (Fnn.one_hot(bins, 36) * m[..., None]).sum((1, 2))


def _orientation(img, uv, scale):
    """Dominant gradient orientation, the 36-bin histogram's argmax
    (ComputeOrientations).  A symmetric blob ties several bins: which one
    wins then depends on the summation order."""
    best = torch.argmax(_orientation_hist(img, uv), -1)
    return (best.to(torch.float32) + 0.5) / 36.0 * 2 * math.pi - math.pi


def extract_sift(
    img: torch.Tensor,
    n_octaves: int = 4,
    n_scales: int = 3,
    n_max: int = 1024,
    init_sigma: float = 1.6,
    dog_thresh: float = 2.0,
) -> SiftKeypoints:
    """Detect and describe an (H, W) float32 image; keypoints padded to
    ``n_max`` by descending response."""
    dev = img.device
    per_oct = max(16, n_max // n_octaves)
    all_uv, all_s, all_score = [], [], []
    base = img
    for o in range(n_octaves):
        Wo = base.shape[1]
        sigmas = [init_sigma * (2.0 ** (s / n_scales)) for s in range(n_scales + 3)]
        gauss = [_blur(base, s) for s in sigmas]
        dogs = [gauss[i + 1] - gauss[i] for i in range(len(gauss) - 1)]
        for si in range(1, len(dogs) - 1):
            ext = _local_extrema(dogs[si - 1], dogs[si], dogs[si + 1], dog_thresh)
            resp = torch.where(ext, dogs[si].abs(), torch.zeros_like(dogs[si]))
            top, idx = _top_k(resp.reshape(-1), max(per_oct // n_scales, 1))
            ys = (idx // Wo).to(torch.float32)
            xs = (idx % Wo).to(torch.float32)
            sc = 2.0 ** o
            all_uv.append(torch.stack([xs, ys], -1) * sc)
            all_s.append(torch.full(top.shape, sigmas[si] * sc, device=dev))
            all_score.append(top)
        base = base[::2, ::2]
    uv = torch.cat(all_uv)
    sc = torch.cat(all_s)
    score = torch.cat(all_score)
    pad = n_max - uv.shape[0]
    if pad > 0:
        uv = torch.cat([uv, torch.zeros((pad, 2), device=dev)])
        sc = torch.cat([sc, torch.ones(pad, device=dev)])
        score = torch.cat([score, torch.zeros(pad, device=dev)])
    # valid == score > 0, so where(valid, score, 0) is the score itself
    top, ti = _top_k(score, n_max)
    uv, sc = uv[ti], sc[ti]
    valid = top > 0
    ang = _orientation(img, uv, sc)
    desc = _descriptors(img, uv, sc, ang)
    desc = torch.where(valid[:, None], desc, torch.zeros_like(desc))
    return SiftKeypoints(uv=uv, scale=sc, angle=ang, score=top, valid=valid, desc=desc)
