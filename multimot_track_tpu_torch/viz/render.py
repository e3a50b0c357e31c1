"""Offline visualization without PIL: the Viewer / FrameDrawer / MapDrawer
replacement.

Port of ``multimot_track_tpu.viz.render``, which draws with PIL; the card's
machine has no PIL, so this module rasterises in numpy: lines
(Bresenham, on the integer pixel of each end point, as PIL's C drawing
takes it), width-2 lines (the two pixels that straddle the exact line)
and rectangles, ellipse outlines and filled
ellipses inside their inclusive bounding box, points, and text in a
5x7 bitmap font carried here (the characters ``draw_objects`` writes).
Each ``draw_*`` returns the (H, W, 3) uint8 image and writes it through
``io/png.write_png`` when given a path: feature and flow overlays, object
boxes with speed labels (``speed.png``), the top-down trajectory canvas
(``traj.png``) and the birds-eye scene-flow view (DrawSparseFlowBirdeye).
tests/test_torch_render.py holds every drawing to PIL's within one pixel,
outside the text.
"""

from __future__ import annotations

import math
from typing import Iterable, Optional, Sequence

import numpy as np

_COLORS = [
    (255, 0, 0), (0, 200, 0), (60, 60, 255), (255, 200, 0),
    (200, 0, 200), (0, 200, 200), (255, 128, 64), (128, 255, 128),
]

# 5x7 glyphs, one string of 5 bits per row, top row first
_FONT = {
    " ": ["00000"] * 7,
    "#": ["01010", "01010", "11111", "01010", "11111", "01010", "01010"],
    "-": ["00000", "00000", "00000", "11111", "00000", "00000", "00000"],
    ".": ["00000", "00000", "00000", "00000", "00000", "01100", "01100"],
    "/": ["00001", "00010", "00010", "00100", "01000", "01000", "10000"],
    "0": ["01110", "10001", "10011", "10101", "11001", "10001", "01110"],
    "1": ["00100", "01100", "00100", "00100", "00100", "00100", "01110"],
    "2": ["01110", "10001", "00001", "00010", "00100", "01000", "11111"],
    "3": ["11111", "00010", "00100", "00010", "00001", "10001", "01110"],
    "4": ["00010", "00110", "01010", "10010", "11111", "00010", "00010"],
    "5": ["11111", "10000", "11110", "00001", "00001", "10001", "01110"],
    "6": ["00110", "01000", "10000", "11110", "10001", "10001", "01110"],
    "7": ["11111", "00001", "00010", "00100", "01000", "01000", "01000"],
    "8": ["01110", "10001", "10001", "01110", "10001", "10001", "01110"],
    "9": ["01110", "10001", "10001", "01111", "00001", "00010", "01100"],
    "h": ["10000", "10000", "10110", "11001", "10001", "10001", "10001"],
    "k": ["10000", "10000", "10010", "10100", "11000", "10100", "10010"],
    "m": ["00000", "00000", "11010", "10101", "10101", "10001", "10001"],
}
GLYPH_H, ADVANCE = 7, 6          # glyphs are 5 wide, 1 column apart


def _to_rgb(gray: np.ndarray) -> np.ndarray:
    g = np.clip(gray, 0, 255).astype(np.uint8)
    return np.stack([g, g, g], axis=-1)


def _put(img: np.ndarray, xs, ys, color) -> None:
    """Set the pixels (xs, ys) that lie inside the image."""
    xs = np.asarray(xs, np.int64).ravel()
    ys = np.asarray(ys, np.int64).ravel()
    H, W = img.shape[:2]
    m = (xs >= 0) & (xs < W) & (ys >= 0) & (ys < H)
    img[ys[m], xs[m]] = color


def _line_pixels(x0: int, y0: int, x1: int, y1: int, W: int, H: int):
    """Bresenham's pixels from (x0, y0) to (x1, y1), both ends included,
    restricted to the steps that can fall inside a W x H image."""
    n = max(abs(x1 - x0), abs(y1 - y0))
    if n == 0:
        return np.asarray([x0]), np.asarray([y0])
    lo, hi = 0.0, 1.0
    for p0, d, size in ((x0, x1 - x0, W), (y0, y1 - y0, H)):
        if d:
            ta, tb = (-1 - p0) / d, (size - p0) / d
            lo, hi = max(lo, min(ta, tb)), min(hi, max(ta, tb))
        elif not -1 <= p0 <= size:
            return np.zeros(0, np.int64), np.zeros(0, np.int64)
    if lo > hi:
        return np.zeros(0, np.int64), np.zeros(0, np.int64)
    t = np.arange(int(math.floor(lo * n)), int(math.ceil(hi * n)) + 1) / n
    xs = np.floor(x0 + (x1 - x0) * t + 0.5).astype(np.int64)
    ys = np.floor(y0 + (y1 - y0) * t + 0.5).astype(np.int64)
    return xs, ys


def _line(img, x0, y0, x1, y1, color, width: int = 1) -> None:
    """A line between the integer pixels of its end points (PIL takes the
    C cast of float coordinates).  ``width`` 2: along the main direction,
    the two pixels across it that straddle the exact line (floor and floor
    + 1), as PIL's filled line polygon covers them."""
    x0, y0, x1, y1 = int(x0), int(y0), int(x1), int(y1)
    H, W = img.shape[:2]
    if width == 1:
        _put(img, *_line_pixels(x0, y0, x1, y1, W, H), color)
        return
    if abs(x1 - x0) >= abs(y1 - y0):
        if x1 == x0:
            _put(img, [x0, x0], [y0, y0 + 1], color)
            return
        xs = np.arange(max(min(x0, x1), -1), min(max(x0, x1), W) + 1)
        yf = np.floor(y0 + (y1 - y0) * (xs - x0) / (x1 - x0)).astype(np.int64)
        _put(img, np.concatenate([xs, xs]), np.concatenate([yf, yf + 1]), color)
    else:
        ys = np.arange(max(min(y0, y1), -1), min(max(y0, y1), H) + 1)
        xf = np.floor(x0 + (x1 - x0) * (ys - y0) / (y1 - y0)).astype(np.int64)
        _put(img, np.concatenate([xf, xf + 1]), np.concatenate([ys, ys]), color)


def _rectangle(img, x0, y0, x1, y1, color, width: int = 1) -> None:
    """Outline of the inclusive box, ``width`` pixels thick inward."""
    x0, y0, x1, y1 = int(x0), int(y0), int(x1), int(y1)
    for k in range(width):
        xs = np.arange(x0 + k, x1 - k + 1)
        ys = np.arange(y0 + k, y1 - k + 1)
        _put(img, xs, np.full_like(xs, y0 + k), color)
        _put(img, xs, np.full_like(xs, y1 - k), color)
        _put(img, np.full_like(ys, x0 + k), ys, color)
        _put(img, np.full_like(ys, x1 - k), ys, color)


def _ellipse(img, x0, y0, x1, y1, color, fill: bool) -> None:
    """Ellipse inside the inclusive box [x0, x1] x [y0, y1] (integer
    pixels of the corners): the filled disc, or its one-pixel outline."""
    x0, y0, x1, y1 = int(x0), int(y0), int(x1), int(y1)
    cx, cy = 0.5 * (x0 + x1), 0.5 * (y0 + y1)
    a, b = 0.5 * (x1 - x0 + 1), 0.5 * (y1 - y0 + 1)
    ys, xs = np.mgrid[y0:y1 + 1, x0:x1 + 1]
    inside = ((xs - cx) / a) ** 2 + ((ys - cy) / b) ** 2 <= 1.0
    if not fill:
        # pixels of the disc with a 4-neighbour outside it
        pad = np.pad(inside, 1)
        interior = pad[:-2, 1:-1] & pad[2:, 1:-1] & pad[1:-1, :-2] & pad[1:-1, 2:]
        inside &= ~interior
    _put(img, xs[inside], ys[inside], color)


def text_box(x, y, txt: str):
    """(x0, y0, x1, y1), inclusive, of ``_text`` at (x, y)."""
    x, y = int(x), int(y)
    return x, y, x + ADVANCE * len(txt) - 2, y + GLYPH_H - 1


def _text(img, x, y, txt: str, color) -> None:
    """``txt`` in the 5x7 bitmap font, its top-left corner at (x, y)."""
    x, y = int(x), int(y)
    for i, ch in enumerate(txt):
        rows = _FONT.get(ch, _FONT[" "])
        gy, gx = np.nonzero(np.asarray([[c == "1" for c in r] for r in rows]))
        _put(img, x + ADVANCE * i + gx, y + gy, color)


def _finish(img: np.ndarray, path) -> np.ndarray:
    if path:
        from multimot_track_tpu_torch.io.png import write_png

        write_png(path, img)
    return img


def draw_features(
    gray: np.ndarray,
    uv: np.ndarray,
    valid: np.ndarray,
    flow: Optional[np.ndarray] = None,
    path=None,
    color=(0, 255, 0),
) -> np.ndarray:
    """Keypoint (+ flow vector) overlay: FrameDrawer::Update and the flow
    illustration block (src/Tracking.cc:322-398)."""
    img = _to_rgb(gray)
    for i in np.flatnonzero(valid):
        x, y = float(uv[i, 0]), float(uv[i, 1])
        _ellipse(img, x - 1.5, y - 1.5, x + 1.5, y + 1.5, color, fill=False)
        if flow is not None:
            _line(img, x, y, x + float(flow[i, 0]), y + float(flow[i, 1]), (255, 0, 0))
    return _finish(img, path)


def draw_objects(
    gray: np.ndarray,
    bboxes: Sequence[np.ndarray],
    labels: Sequence[int],
    speeds: Optional[Sequence[float]] = None,
    path=None,
) -> np.ndarray:
    """Bounding boxes and per-object speed labels (the ``speed.png``
    analog, src/Tracking.cc:786-878)."""
    img = _to_rgb(gray)
    for k, (bb, lab) in enumerate(zip(bboxes, labels)):
        c = _COLORS[int(lab) % len(_COLORS)]
        _rectangle(img, float(bb[0]), float(bb[1]), float(bb[2]), float(bb[3]), c, width=2)
        txt = f"#{int(lab)}"
        if speeds is not None:
            txt += f" {speeds[k]:.1f} km/h"
        _text(img, float(bb[0]), max(float(bb[1]) - 12, 0), txt, c)
    return _finish(img, path)


def draw_trajectory(
    poses_Twc: Iterable[np.ndarray],
    object_centres: Optional[Sequence[tuple]] = None,
    size: int = 800,
    scale: float = 6.0,
    path=None,
) -> np.ndarray:
    """Top-down x-z trajectory canvas (``traj.png`` / imTraj analog)."""
    img = np.full((size, size, 3), 255, np.uint8)
    cx, cz = size // 2, int(size * 0.8)
    prev = None
    for T in poses_Twc:
        x = cx + int(T[0, 3] * scale)
        z = cz - int(T[2, 3] * scale)
        if prev is not None:
            _line(img, prev[0], prev[1], x, z, (0, 0, 255), width=2)
        prev = (x, z)
    for (pt, lab) in object_centres or ():
        c = _COLORS[int(lab) % len(_COLORS)]
        x = cx + int(pt[0] * scale)
        z = cz - int(pt[2] * scale)
        _ellipse(img, x - 3, z - 3, x + 3, z + 3, c, fill=True)
    return _finish(img, path)


def draw_birdeye_flow(
    pts: np.ndarray,        # (N, 3) last-frame world points
    vel: np.ndarray,        # (N, 3) 3-D scene flow
    valid: np.ndarray,
    x_range=(-15.0, 15.0),
    z_range=(0.0, 30.0),
    size: int = 600,
    path=None,
) -> np.ndarray:
    """Birds-eye sparse scene flow (Tracking::DrawSparseFlowBirdeye)."""
    img = np.zeros((size, size, 3), np.uint8)
    sx = size / (x_range[1] - x_range[0])
    sz = size / (z_range[1] - z_range[0])
    for i in np.flatnonzero(valid):
        x = (pts[i, 0] - x_range[0]) * sx
        z = size - (pts[i, 2] - z_range[0]) * sz
        if math.isfinite(x) and math.isfinite(z):      # no pixel for a point at infinity
            _put(img, [int(x)], [int(z)], (0, 255, 0))
            _line(img, x, z, x + vel[i, 0] * sx, z - vel[i, 2] * sz, (255, 0, 0))
    return _finish(img, path)
