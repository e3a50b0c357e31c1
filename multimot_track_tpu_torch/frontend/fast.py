"""FAST-9 corner detection with grid-uniform top-k selection, batched.

Port of ``multimot_track_tpu.frontend.fast`` on (B, H, W) image stacks.
What had to be written out to match ``jax.lax.top_k`` and XLA:

* Top-k tie order.  ``lax.top_k`` puts the lower index first among equal
  values; ``torch.topk`` promises no order.  Ties are common here: the
  +1e6 strong-corner bias quantises float32 scores to steps of 0.0625.
  Every top-k below is a stable descending sort followed by a slice.
* ``jnp.roll`` wraps, and so does ``torch.roll``; the 3 px border where the
  wrapped taps land is zeroed afterwards in both.
* ``reduce_window(max)`` pads with -inf, and so does ``max_pool2d``.
* The pyramid resize is ``ops.resize.resize_linear`` (JAX's antialiased
  triangle filter), not ``interpolate``.  ``accumulate=torch.float64``
  makes the card and the CPU detect the same corners (their float32
  weights and products part by an ulp on a fifth of the pixels, and
  FAST's NMS and top-k then keep other corners of a near tie); the
  default float32 is the rounding the RGB-D paths' parity tests hold to
  the JAX package.
* The arc sums' prefix sums (``_xla_cumsum``).  XLA:CPU evaluates the
  24-long ``jnp.cumsum`` of the circle as a sequential scan of the first
  16 taps and another of the rest, plus the first block's total; on float
  images (a rendered gray) another order moves scores by an ulp and
  changes which of two neighbours survives the NMS.
"""

from __future__ import annotations

from typing import NamedTuple, Tuple

import torch
import torch.nn.functional as Fnn

from multimot_track_tpu_torch.ops.resize import resize_linear

# Bresenham circle of radius 3 (dx, dy), clockwise from 12 o'clock
_CIRCLE = (
    (0, -3), (1, -3), (2, -2), (3, -1), (3, 0), (3, 1), (2, 2), (1, 3),
    (0, 3), (-1, 3), (-2, 2), (-3, 1), (-3, 0), (-3, -1), (-2, -2), (-1, -3),
)
_ARC = 9  # contiguous run length for FAST-9


class Keypoints(NamedTuple):
    """Padded keypoint sets in level-0 pixel coordinates, (B, N, ...)."""

    uv: torch.Tensor      # (B, N, 2) float32 (x, y)
    score: torch.Tensor   # (B, N) float32 corner response
    level: torch.Tensor   # (B, N) int32 pyramid level
    valid: torch.Tensor   # (B, N) bool


def topk_stable(x: torch.Tensor, k: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """``jax.lax.top_k`` over the last axis: descending, and among equal
    values the lower index first."""
    vals, idx = torch.sort(x, dim=-1, descending=True, stable=True)
    return vals[..., :k], idx[..., :k]


_SCAN_BLOCK = 16   # XLA:CPU's block length of a long cumulative sum


def _xla_cumsum(x: torch.Tensor) -> torch.Tensor:
    """Inclusive prefix sums over axis 0 in XLA:CPU's order: a sequential
    scan within each block of 16, then the previous block's last prefix
    added (checked bit for bit against ``jnp.cumsum`` of 24 rows).  Written
    as single adds, so the card and the CPU give the same bits."""
    out = []
    for b in range(0, x.shape[0], _SCAN_BLOCK):
        acc = x[b]
        blk = [acc]
        for i in range(b + 1, min(b + _SCAN_BLOCK, x.shape[0])):
            acc = acc + x[i]
            blk.append(acc)
        if out:
            blk = [v + out[-1] for v in blk]
        out.extend(blk)
    return torch.stack(out, 0)


def fast_score_map(img: torch.Tensor, threshold: float) -> torch.Tensor:
    """FAST-9 corner response for every pixel of (B, H, W) float images:
    max over (bright, dark) of the summed |tap - centre| - t over the best
    9-long contiguous arc; zero where no arc passes and on the 3 px border."""
    taps = torch.stack(
        [torch.roll(img, shifts=(-dy, -dx), dims=(-2, -1)) for dx, dy in _CIRCLE], 0
    )
    diff = taps - img[None]
    mag = torch.clamp(diff.abs() - threshold, min=0.0)

    def arc_score(flags, mag):
        flags2 = torch.cat([flags, flags[: _ARC - 1]], 0).to(torch.float32)
        mag2 = torch.cat([mag, mag[: _ARC - 1]], 0)
        cs = torch.cat([torch.zeros_like(flags2[:1]), _xla_cumsum(flags2)], 0)
        ok = (cs[_ARC:] - cs[:-_ARC]) >= _ARC - 0.5
        csm = torch.cat([torch.zeros_like(mag2[:1]), _xla_cumsum(mag2)], 0)
        wmag = csm[_ARC:] - csm[:-_ARC]
        return torch.where(ok, wmag, torch.zeros_like(wmag)).amax(0)

    score = torch.maximum(arc_score(diff > threshold, mag),
                          arc_score(diff < -threshold, mag))
    H, W = img.shape[-2], img.shape[-1]
    ys = torch.arange(H, device=img.device)[:, None]
    xs = torch.arange(W, device=img.device)[None, :]
    inner = (ys >= 3) & (ys < H - 3) & (xs >= 3) & (xs < W - 3)
    return torch.where(inner, score, torch.zeros_like(score))


def nms3x3(score: torch.Tensor) -> torch.Tensor:
    """3x3 non-maximum suppression of (B, H, W) scores."""
    m = Fnn.max_pool2d(score[:, None], 3, stride=1, padding=1)[:, 0]
    return torch.where(score >= m, score, torch.zeros_like(score))


def _grid_topk(score: torch.Tensor, cell: int, per_cell: int):
    """Per-cell top-k over (B, H, W) scores -> (scores, flat indices into
    the unpadded image), each (B, n_cells * per_cell)."""
    B, H, W = score.shape
    ph, pw = (-H) % cell, (-W) % cell
    s = Fnn.pad(score, (0, pw, 0, ph))
    nr, nc = (H + ph) // cell, (W + pw) // cell
    blocks = s.reshape(B, nr, cell, nc, cell).permute(0, 1, 3, 2, 4).reshape(
        B, nr * nc, cell * cell)
    top_s, top_i = topk_stable(blocks, per_cell)
    bi = torch.arange(nr * nc, device=score.device)
    by, bx = bi // nc, bi % nc
    iy = top_i // cell + (by * cell)[:, None]
    ix = top_i % cell + (bx * cell)[:, None]
    flat = iy * W + ix
    return top_s.reshape(B, -1), flat.reshape(B, -1)


def _level_quotas(n_levels: int, scale_factor: float, n_total: int):
    """Distribute n_total across levels by inverse scale (ORBextractor's
    mnFeaturesPerLevel)."""
    inv = 1.0 / scale_factor
    raw = [inv ** i for i in range(n_levels)]
    s = sum(raw)
    return [max(16, int(round(n_total * r / s))) for r in raw]


def detect_pyramid(
    img: torch.Tensor,
    threshold: float = 20.0,
    min_threshold: float = 7.0,
    n_levels: int = 8,
    scale_factor: float = 1.2,
    n_total: int = 4000,
    cell: int = 16,
    per_cell: int = 2,
    accumulate: torch.dtype = torch.float32,
) -> Keypoints:
    """Multi-scale FAST with uniform spatial distribution on (B, H, W)
    images; strong corners (>= threshold) are biased by +1e6 so they win
    the global top-k over weak (>= min_threshold) ones.  ``accumulate``:
    the pyramid resize's accumulation type."""
    B, H, W = img.shape
    quota = _level_quotas(n_levels, scale_factor, n_total)
    all_uv, all_s, all_l, all_v = [], [], [], []
    for lvl in range(n_levels):
        scale = scale_factor ** lvl
        Hl, Wl = max(int(round(H / scale)), 16), max(int(round(W / scale)), 16)
        im_l = img if lvl == 0 else resize_linear(img, (B, Hl, Wl), accumulate=accumulate)
        score = nms3x3(fast_score_map(im_l, min_threshold))
        strong = fast_score_map(im_l, threshold) > 0
        biased = torch.where(strong & (score > 0), score + 1e6, score)
        s, flat = _grid_topk(biased, cell, per_cell)
        top_s, ti = topk_stable(s, min(quota[lvl], s.shape[-1]))
        flat_k = torch.gather(flat, 1, ti)
        ys = torch.div(flat_k, Wl, rounding_mode="floor").to(torch.float32)
        xs = (flat_k % Wl).to(torch.float32)
        all_uv.append(torch.stack([xs, ys], -1) * scale)
        all_s.append(torch.where(top_s > 1e5, top_s - 1e6, top_s))
        all_l.append(torch.full_like(ti, lvl, dtype=torch.int32))
        all_v.append(top_s > 0)
    uv = torch.cat(all_uv, 1)
    sc = torch.cat(all_s, 1)
    lv = torch.cat(all_l, 1)
    va = torch.cat(all_v, 1)
    pad = n_total - uv.shape[1]
    if pad > 0:
        def zpad(a):
            return torch.cat([a, a.new_zeros((B, pad) + a.shape[2:])], 1)

        uv, sc, lv, va = zpad(uv), zpad(sc), zpad(lv), zpad(va)
    return Keypoints(uv=uv[:, :n_total], score=sc[:, :n_total],
                     level=lv[:, :n_total], valid=va[:, :n_total])
