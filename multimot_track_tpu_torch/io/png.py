"""PNG reading and writing without PIL, so the port runs where PIL is not
installed.

``read_png`` decodes the files the sequence readers meet: 8- and 16-bit
grayscale, RGB and RGBA, non-interlaced, and returns what
``np.asarray(PIL.Image.open(path))`` returns for them: uint8 (H, W) or
(H, W, C), and native-order uint16 (H, W) for 16-bit gray (PNG stores it
big-endian).  Palette, gray + alpha, interlaced, sub-byte and 16-bit
colour files raise ``ValueError``.

The IDAT stream is inflated with the standard library's ``zlib``.  Each
scanline is led by its filter type (PNG specification, section 9):
Average (3) and Paeth (4) predict from the reconstructed byte to the
left, which a Python loop over a 1242x375 RGB frame takes seconds to
follow, so every image is reversed by ``native/png_unfilter.cc`` (built at
first use by ``kernels.build_native``; a failed build raises).
``unfilter_plain`` is the numpy version of all five filters, kept for the
tests.

``write_png`` writes 8-bit gray and RGB and 16-bit gray, every row with
filter 0.
"""

from __future__ import annotations

import ctypes
import functools
import pathlib
import struct
import zlib

import numpy as np

from multimot_track_tpu_torch import kernels

SIGNATURE = b"\x89PNG\r\n\x1a\n"
# colour type -> channels: gray, RGB, RGBA (3 = palette, 4 = gray + alpha)
_CHANNELS = {0: 1, 2: 3, 6: 4}


def _chunks(data: bytes, path):
    """Yield (type, payload) of each chunk, checking lengths and CRCs."""
    if data[:8] != SIGNATURE:
        raise ValueError(f"{path}: not a PNG file")
    pos = 8
    while pos + 12 <= len(data):
        (n,) = struct.unpack(">I", data[pos:pos + 4])
        kind = data[pos + 4:pos + 8]
        body = data[pos + 8:pos + 8 + n]
        if len(body) != n or pos + 12 + n > len(data):
            raise ValueError(f"{path}: truncated {kind!r} chunk")
        (crc,) = struct.unpack(">I", data[pos + 8 + n:pos + 12 + n])
        if zlib.crc32(kind + body) != crc:
            raise ValueError(f"{path}: CRC mismatch in {kind!r} chunk")
        yield kind, body
        if kind == b"IEND":
            return
        pos += 12 + n
    raise ValueError(f"{path}: no IEND chunk")


def _ihdr(body: bytes, path):
    if len(body) != 13:
        raise ValueError(f"{path}: bad IHDR")
    w, h, depth, ctype, comp, filt, interlace = struct.unpack(">IIBBBBB", body)
    if ctype not in _CHANNELS:
        raise ValueError(f"{path}: colour type {ctype} (palette, gray + alpha or unknown) "
                         "is not supported")
    if interlace:
        raise ValueError(f"{path}: interlaced PNG is not supported")
    if comp or filt:
        raise ValueError(f"{path}: unknown compression or filter method")
    if depth not in (8, 16) or (depth == 16 and ctype != 0):
        raise ValueError(f"{path}: {depth}-bit colour type {ctype} is not supported")
    return w, h, depth, ctype


def read_header(path):
    """(width, height, bit depth, colour type) from the IHDR chunk alone."""
    with open(path, "rb") as f:
        head = f.read(33)
    if head[:8] != SIGNATURE or head[12:16] != b"IHDR":
        raise ValueError(f"{path}: not a PNG file")
    return _ihdr(head[16:29], path)


def unfilter_plain(rows: np.ndarray, bpp: int) -> np.ndarray:
    """Reverse the five PNG filters row by row in numpy, with a loop over
    the pixels of Average and Paeth rows.  ``rows``: (H, 1 + row_bytes)
    uint8, the filter type first; returns (H, row_bytes) uint8."""
    H, rb = rows.shape[0], rows.shape[1] - 1
    out = np.zeros((H, rb), np.uint8)
    prev = np.zeros(rb, np.int32)
    for y in range(H):
        f, r = int(rows[y, 0]), rows[y, 1:].astype(np.int32)
        if f == 0:
            cur = r
        elif f == 1:
            cur = np.cumsum(r.reshape(-1, bpp), axis=0).reshape(-1) & 255
        elif f == 2:
            cur = (r + prev) & 255
        elif f in (3, 4):
            cur = np.zeros(rb, np.int32)
            for x in range(0, rb, bpp):
                b = prev[x:x + bpp]
                a = cur[x - bpp:x] if x else np.zeros(bpp, np.int32)
                if f == 3:
                    pred = (a + b) >> 1
                else:
                    c = prev[x - bpp:x] if x else np.zeros(bpp, np.int32)
                    p = a + b - c
                    pa, pb, pc = np.abs(p - a), np.abs(p - b), np.abs(p - c)
                    pred = np.where((pa <= pb) & (pa <= pc), a, np.where(pb <= pc, b, c))
                cur[x:x + bpp] = (r[x:x + bpp] + pred) & 255
        else:
            raise ValueError(f"unknown PNG filter type {f} in row {y}")
        out[y] = cur
        prev = cur
    return out


@functools.cache
def _unfilter_lib() -> ctypes.CDLL:
    dll = ctypes.CDLL(str(kernels.build_native("png_unfilter")))
    dll.mmt_png_unfilter.restype = ctypes.c_int
    dll.mmt_png_unfilter.argtypes = [ctypes.c_void_p, ctypes.c_void_p] + [ctypes.c_int] * 3
    return dll


def unfilter_native(rows: np.ndarray, bpp: int) -> np.ndarray:
    """``unfilter_plain`` in native/png_unfilter.cc."""
    rows = np.ascontiguousarray(rows, np.uint8)
    H, rb = rows.shape[0], rows.shape[1] - 1
    out = np.empty((H, rb), np.uint8)
    rc = _unfilter_lib().mmt_png_unfilter(rows.ctypes.data, out.ctypes.data, H, rb, bpp)
    if rc:
        raise ValueError(f"unknown PNG filter type {rows[-rc - 1, 0]} in row {-rc - 1}")
    return out


def read_png(path) -> np.ndarray:
    """Decode a PNG file (see the module docstring for what it takes)."""
    data = pathlib.Path(path).read_bytes()
    hdr, idat = None, []
    for kind, body in _chunks(data, path):
        if kind == b"IHDR":
            hdr = _ihdr(body, path)
        elif kind == b"IDAT":
            idat.append(body)
    if hdr is None or not idat:
        raise ValueError(f"{path}: no IHDR or no IDAT chunk")
    w, h, depth, ctype = hdr
    ch = _CHANNELS[ctype]
    bpp = ch * depth // 8
    rb = w * bpp
    raw = np.frombuffer(zlib.decompress(b"".join(idat)), np.uint8)
    if raw.size < h * (rb + 1):
        raise ValueError(f"{path}: image data too short")
    px = unfilter_native(raw[:h * (rb + 1)].reshape(h, rb + 1), bpp)
    if depth == 16:
        px = px.view(">u2").astype(np.uint16)
    return px.reshape((h, w) if ch == 1 else (h, w, ch))


def _chunk(kind: bytes, body: bytes) -> bytes:
    return struct.pack(">I", len(body)) + kind + body + struct.pack(">I", zlib.crc32(kind + body))


def write_png(path, arr: np.ndarray) -> None:
    """Write uint8 (H, W) or (H, W, 3), or uint16 (H, W), as a PNG with
    filter 0 on every row."""
    arr = np.asarray(arr)
    if arr.dtype == np.uint8 and arr.ndim == 2:
        depth, ctype = 8, 0
    elif arr.dtype == np.uint8 and arr.ndim == 3 and arr.shape[2] == 3:
        depth, ctype = 8, 2
    elif arr.dtype == np.uint16 and arr.ndim == 2:
        depth, ctype = 16, 0
        arr = arr.astype(">u2")
    else:
        raise ValueError(f"write_png takes uint8 gray / RGB or uint16 gray, "
                         f"not {arr.dtype} {arr.shape}")
    h, w = arr.shape[:2]
    rows = np.ascontiguousarray(arr).view(np.uint8).reshape(h, -1)
    raw = np.concatenate([np.zeros((h, 1), np.uint8), rows], axis=1)
    ihdr = struct.pack(">IIBBBBB", w, h, depth, ctype, 0, 0, 0)
    with open(path, "wb") as f:
        f.write(SIGNATURE + _chunk(b"IHDR", ihdr)
                + _chunk(b"IDAT", zlib.compress(raw.tobytes())) + _chunk(b"IEND", b""))
