"""Middlebury .flo optical-flow file I/O.

Format: 4-byte magic float 202021.25 ("PIEH"), int32 width, int32 height,
then H*W*2 float32 (u, v) interleaved, row-major — matching the reference's
ReadFlowFile/WriteFlowFile (src/flow/flowIO.cpp:47-120) and OpenCV's
``readOpticalFlow`` used by the driver (Examples/RGB-D/rgbd_tum.cc:129).
Pure NumPy; device transfer happens downstream.  A copy of the JAX
package's ``io/flowio.py``.
"""

from __future__ import annotations

import struct

import numpy as np

_MAGIC = 202021.25
_UNKNOWN = 1e9  # values above this mark unknown flow in the format spec


def read_flo(path) -> np.ndarray:
    """Read a .flo file -> (H, W, 2) float32 array."""
    with open(path, "rb") as f:
        magic = struct.unpack("<f", f.read(4))[0]
        if abs(magic - _MAGIC) > 1e-3:
            raise ValueError(f"{path}: bad .flo magic {magic!r}")
        w = struct.unpack("<i", f.read(4))[0]
        h = struct.unpack("<i", f.read(4))[0]
        if not (0 < w < 99999 and 0 < h < 99999):
            raise ValueError(f"{path}: implausible size {w}x{h}")
        data = np.frombuffer(f.read(h * w * 2 * 4), dtype="<f4")
        if data.size != h * w * 2:
            raise ValueError(f"{path}: truncated flow payload")
    return data.reshape(h, w, 2).astype(np.float32)


def write_flo(path, flow: np.ndarray) -> None:
    """Write (H, W, 2) float32 array as .flo."""
    flow = np.ascontiguousarray(flow, dtype="<f4")
    if flow.ndim != 3 or flow.shape[2] != 2:
        raise ValueError("flow must be (H, W, 2)")
    h, w = flow.shape[:2]
    with open(path, "wb") as f:
        f.write(struct.pack("<f", _MAGIC))
        f.write(struct.pack("<i", w))
        f.write(struct.pack("<i", h))
        f.write(flow.tobytes())


def flow_to_color(flow: np.ndarray, max_rad: float | None = None) -> np.ndarray:
    """Flow -> RGB uint8 visualisation via the standard Middlebury color
    wheel (functional equivalent of MotionToColor/computeColor,
    src/flow/motiontocolor.cpp:7, src/flow/colorcode.cpp)."""
    u, v = flow[..., 0].copy(), flow[..., 1].copy()
    bad = (np.abs(u) > _UNKNOWN) | (np.abs(v) > _UNKNOWN)
    u[bad] = 0
    v[bad] = 0
    rad = np.sqrt(u * u + v * v)
    if max_rad is None:
        max_rad = max(float(rad.max()), 1e-9)
    u, v = u / max_rad, v / max_rad

    # build the 55-entry color wheel
    RY, YG, GC, CB, BM, MR = 15, 6, 4, 11, 13, 6
    ncols = RY + YG + GC + CB + BM + MR
    wheel = np.zeros((ncols, 3))
    col = 0
    wheel[:RY] = [(255, 0, 0)] * RY
    wheel[:RY, 1] = np.floor(255 * np.arange(RY) / RY)
    col += RY
    wheel[col : col + YG, 0] = 255 - np.floor(255 * np.arange(YG) / YG)
    wheel[col : col + YG, 1] = 255
    col += YG
    wheel[col : col + GC, 1] = 255
    wheel[col : col + GC, 2] = np.floor(255 * np.arange(GC) / GC)
    col += GC
    wheel[col : col + CB, 1] = 255 - np.floor(255 * np.arange(CB) / CB)
    wheel[col : col + CB, 2] = 255
    col += CB
    wheel[col : col + BM, 2] = 255
    wheel[col : col + BM, 0] = np.floor(255 * np.arange(BM) / BM)
    col += BM
    wheel[col : col + MR, 2] = 255 - np.floor(255 * np.arange(MR) / MR)
    wheel[col : col + MR, 0] = 255

    rad = np.sqrt(u * u + v * v)
    a = np.arctan2(-v, -u) / np.pi
    fk = (a + 1.0) / 2.0 * (ncols - 1)
    k0 = np.floor(fk).astype(int) % ncols
    k1 = (k0 + 1) % ncols
    f = fk - np.floor(fk)
    img = np.zeros(flow.shape[:2] + (3,), np.uint8)
    for c in range(3):
        col0 = wheel[k0, c] / 255.0
        col1 = wheel[k1, c] / 255.0
        colv = (1 - f) * col0 + f * col1
        idx = rad <= 1
        colv[idx] = 1 - rad[idx] * (1 - colv[idx])
        colv[~idx] *= 0.75
        img[..., c] = np.floor(255 * colv * (~bad)).astype(np.uint8)
    return img
