"""Oriented BRIEF (ORB-style) descriptors on torch tensors.

Port of ``multimot_track_tpu.frontend.orb``: a 7x7 sigma-2 Gaussian blur,
the intensity-centroid angle over a radius-15 disc, and steered BRIEF with
256 comparison pairs, returned in {-1, +1} int8 sign form.  All keypoints
are one batch of gathers from the blurred image.

What had to be written out to match the JAX package:

* The pattern.  ``brief_pattern`` reads ``brief_pattern_learned.npy`` from
  the JAX package's ``frontend/`` directory when it exists (a file, not an
  import), else the fixed-seed Gaussian pairs of ``np.random.default_rng``;
  the tests pin it to the JAX package's table.
* Rounding.  ``jnp.round`` and ``torch.round`` both round half to even.
* The blur runs as ``conv2d`` with zero padding; the caller keeps
  ``cudnn.allow_tf32`` off on the card (TF32 would move blurred values by
  ~1e-3 and flip comparison bits).
* The steering rotation is written elementwise (``c*px - s*py``), so no
  matmul path contracts it differently.

``learn_brief_pattern`` is the offline rBRIEF learner: it returns the
selected table and writes nothing; its caller decides where the table
goes (``brief_pattern`` reads only ``LEARNED_PATTERN``).
"""

from __future__ import annotations

import functools
import pathlib
from typing import Tuple

import numpy as np
import torch
import torch.nn.functional as Fnn

PATCH_RADIUS = 15          # orientation disc radius (ORBextractor HALF_PATCH_SIZE)
N_BITS = 256
# the one learned-pattern file both packages read
LEARNED_PATTERN = (pathlib.Path(__file__).resolve().parents[2]
                   / "multimot_track_tpu" / "frontend" / "brief_pattern_learned.npy")


def _gaussian_kernel1d(sigma: float, radius: int) -> np.ndarray:
    x = np.arange(-radius, radius + 1, dtype=np.float64)
    k = np.exp(-0.5 * (x / sigma) ** 2)
    return (k / k.sum()).astype(np.float32)


def gaussian_blur(img: torch.Tensor, sigma: float = 2.0, radius: int = 3) -> torch.Tensor:
    """Separable Gaussian blur of (..., H, W) images, zero padded."""
    k = torch.from_numpy(_gaussian_kernel1d(sigma, radius)).to(img.device)
    lead = img.shape[:-2]
    x = img.reshape((-1, 1) + img.shape[-2:])
    x = Fnn.conv2d(x, k.view(1, 1, -1, 1), padding=(radius, 0))
    x = Fnn.conv2d(x, k.view(1, 1, 1, -1), padding=(0, radius))
    return x.reshape(lead + x.shape[-2:])


@functools.lru_cache(maxsize=None)
def _disc_offsets(radius: int) -> Tuple[np.ndarray, np.ndarray]:
    ys, xs = np.mgrid[-radius: radius + 1, -radius: radius + 1]
    m = ys * ys + xs * xs <= radius * radius
    return xs[m].astype(np.int32), ys[m].astype(np.int32)


@functools.lru_cache(maxsize=None)
def _random_pairs(seed: int, n: int) -> np.ndarray:
    rng = np.random.default_rng(seed)
    sigma = (2 * PATCH_RADIUS + 1) / 5.0
    pts = rng.normal(0.0, sigma, size=(n, 2, 2))
    return np.clip(np.round(pts), -PATCH_RADIUS, PATCH_RADIUS).astype(np.float32)


@functools.lru_cache(maxsize=None)
def brief_pattern(seed: int = 1234, n_bits: int = N_BITS) -> np.ndarray:
    """(n_bits, 2, 2) float32 sampling-pair offsets: the learned table when
    its file exists (default seed and width only), else the fixed-seed
    Gaussian pairs of the BRIEF paper."""
    if seed == 1234 and n_bits == N_BITS and LEARNED_PATTERN.exists():
        pat = np.load(LEARNED_PATTERN)
        if pat.shape == (n_bits, 2, 2):
            return pat.astype(np.float32)
    return _random_pairs(seed, n_bits)


def learn_brief_pattern(
    grays,                       # iterable of (H, W) float images
    n_bits: int = N_BITS,
    n_candidates: int = 3072,
    n_kp_per_image: int = 512,
    corr_thresh: float = 0.2,
    seed: int = 7,
    device="cpu",
) -> np.ndarray:
    """rBRIEF pattern learning (ORB paper sec. 4.3): candidate tests are
    scored over steered training patches; the greedy selection keeps tests
    with a bit mean closest to 0.5 whose |correlation| with every kept test
    stays under a threshold, raised by 0.05 until ``n_bits`` survive.  Port
    of the JAX package's ``learn_brief_pattern``: the patches come from this
    package's FAST pyramid, blur and steered BRIEF on ``device``; the
    selection is the same numpy loop.  Returns the (n_bits, 2, 2) table."""
    from multimot_track_tpu_torch.frontend import fast

    cand = _random_pairs(seed, n_candidates)
    bits = []
    for g in grays:
        img = torch.as_tensor(np.asarray(g, np.float32), device=device)
        kp = fast.detect_pyramid(img[None], n_levels=4, n_total=n_kp_per_image)
        uv, valid = kp.uv[0], kp.valid[0]
        blur = gaussian_blur(img)
        ang = compute_orientations(blur, uv)
        b = brief_descriptors(blur, uv, ang, pattern=cand)      # (N, M) +-1
        bits.append(b[valid].cpu().numpy())
    B = np.concatenate(bits, axis=0).astype(np.float32)        # (T, M)
    T = B.shape[0]
    mean = B.mean(0)                                           # in [-1, 1]
    order = np.argsort(np.abs(mean))                           # closest to 0 first
    Bc = B - mean                                              # centred
    norm = np.sqrt(np.maximum((Bc * Bc).sum(0), 1e-9))

    for thresh in np.arange(corr_thresh, 1.01, 0.05):
        picked = []
        for j in order:
            if not picked:
                picked.append(int(j))
                continue
            c = np.abs(Bc[:, picked].T @ Bc[:, j]) / (norm[picked] * norm[j])
            if c.max() < thresh:
                picked.append(int(j))
            if len(picked) == n_bits:
                break
        if len(picked) == n_bits:
            return cand[np.asarray(picked)]
    raise RuntimeError(
        f"could not select {n_bits} decorrelated tests from "
        f"{n_candidates} candidates over {T} patches"
    )


def _gather(img: torch.Tensor, yi: torch.Tensor, xi: torch.Tensor) -> torch.Tensor:
    """(H, W) image at clipped integer indices of any shape."""
    W = img.shape[-1]
    return img.reshape(-1)[(yi * W + xi).reshape(-1)].reshape(yi.shape)


def compute_orientations(img_blur: torch.Tensor, uv: torch.Tensor) -> torch.Tensor:
    """Intensity-centroid angle (radians) per keypoint: (H, W) image,
    (..., 2) keypoints -> (...,)."""
    H, W = img_blur.shape
    dx, dy = (torch.from_numpy(a).to(uv.device) for a in _disc_offsets(PATCH_RADIUS))
    xi = torch.clamp(torch.round(uv[..., 0]).to(torch.int64)[..., None] + dx, 0, W - 1)
    yi = torch.clamp(torch.round(uv[..., 1]).to(torch.int64)[..., None] + dy, 0, H - 1)
    vals = _gather(img_blur, yi, xi)                       # (..., P)
    m10 = (vals * dx.to(vals.dtype)).sum(-1)
    m01 = (vals * dy.to(vals.dtype)).sum(-1)
    return torch.atan2(m01, m10)


def brief_descriptors(img_blur: torch.Tensor, uv: torch.Tensor, angle: torch.Tensor,
                      seed: int = 1234, pattern: np.ndarray = None) -> torch.Tensor:
    """Steered BRIEF: (N, 2) keypoints -> (N, n_bits) int8 in {-1, +1}."""
    H, W = img_blur.shape
    pat = torch.from_numpy(brief_pattern(seed) if pattern is None else pattern).to(uv.device)
    c, s = torch.cos(angle)[:, None, None], torch.sin(angle)[:, None, None]
    px, py = pat[None, ..., 0], pat[None, ..., 1]          # (1, n_bits, 2)
    x = uv[:, None, None, 0] + (c * px + (-s) * py)        # (N, n_bits, 2)
    y = uv[:, None, None, 1] + (s * px + c * py)
    xi = torch.clamp(torch.round(x).to(torch.int64), 0, W - 1)
    yi = torch.clamp(torch.round(y).to(torch.int64), 0, H - 1)
    vals = _gather(img_blur, yi, xi)
    bit = vals[..., 0] < vals[..., 1]
    one = torch.ones((), dtype=torch.int8, device=uv.device)
    return torch.where(bit, one, -one)


def describe(img: torch.Tensor, uv: torch.Tensor, seed: int = 1234):
    """Blur + orient + describe one (H, W) image at (N, 2) keypoints.
    Returns (descriptors (N, 256) int8 sign form, angles (N,) radians)."""
    blur = gaussian_blur(img)
    ang = compute_orientations(blur, uv)
    return brief_descriptors(blur, uv, ang, seed=seed), ang
