"""Wire codec: compact host->device frame formats.

Port of ``multimot_track_tpu.ops.wire``.  The host-side ``pack_*`` functions
are numpy and identical to the JAX package's; the ``unpack_*``/``_decode_*``
functions expand the wire arrays into the float32/int tensors the frontend
consumes, on whatever device the wire tensors live.
"""

from __future__ import annotations

import numpy as np
import torch

from multimot_track_tpu_torch.ops.resize import resize_linear


def pack_flow12(flow: np.ndarray) -> np.ndarray:
    """(H, W, 2) float flow -> (H, W, 3) uint8 (two 12-bit values)."""
    q = np.clip(np.round(np.nan_to_num(flow) * 8.0), -2048, 2047).astype(np.int32) + 2048
    u, v = q[..., 0], q[..., 1]
    return np.stack(
        [(u >> 4), ((u & 15) << 4) | (v >> 8), v & 255], -1
    ).astype(np.uint8)


def unpack_flow12(p: torch.Tensor) -> torch.Tensor:
    """(..., H, W, 3) uint8 -> (..., H, W, 2) float32 flow."""
    b = p.to(torch.int32)
    u = (b[..., 0] << 4) | (b[..., 1] >> 4)
    v = ((b[..., 1] & 15) << 8) | b[..., 2]
    return (torch.stack([u, v], -1) - 2048).to(torch.float32) * 0.125


def pack_flow12_half(flow: np.ndarray) -> np.ndarray:
    """Half-resolution flow wire format: 2x2-mean downsample, 12-bit pack."""
    H, W = flow.shape[:2]
    h, w = H - (H % 2), W - (W % 2)
    f = np.nan_to_num(flow[:h, :w]).reshape(h // 2, 2, w // 2, 2, 2).mean((1, 3))
    return pack_flow12(f)


def unpack_flow12_half(p: torch.Tensor, height: int, width: int) -> torch.Tensor:
    """Inverse of pack_flow12_half: unpack 12-bit, resize to
    (height, width, 2) with JAX's linear filter.  Leading axes batch."""
    f = unpack_flow12(p)
    return resize_linear(f, tuple(f.shape[:-3]) + (height, width, 2))


def pack_depth12(raw: np.ndarray) -> np.ndarray:
    """uint16 disparity*256 -> 12-bit pairs, (H, W) -> (H, 3*W/2) uint8."""
    d = (np.asarray(raw).astype(np.uint16) >> 4).astype(np.uint16)
    if d.shape[-1] % 2:
        d = np.concatenate([d, np.zeros_like(d[..., :1])], -1)
    a, b = d[..., 0::2].astype(np.uint32), d[..., 1::2].astype(np.uint32)
    packed = np.stack([a >> 4, ((a & 15) << 4) | (b >> 8), b & 255], -1)
    return packed.reshape(packed.shape[:-2] + (-1,)).astype(np.uint8)


def unpack_depth12(p: torch.Tensor, width: int) -> torch.Tensor:
    """(..., 3*ceil(W/2)) uint8 -> (..., W) float32 disparity*256 values."""
    b = p.reshape(p.shape[:-1] + (-1, 3)).to(torch.int32)
    a = (b[..., 0] << 4) | (b[..., 1] >> 4)
    c = ((b[..., 1] & 15) << 8) | b[..., 2]
    full = torch.stack([a, c], -1).reshape(p.shape[:-1] + (-1,))
    return (full[..., :width] << 4).to(torch.float32)


def pack_sem4(sem: np.ndarray) -> np.ndarray:
    """(H, W) labels 0..15 -> (H, ceil(W/2)) uint8 nibble pairs."""
    s = np.clip(sem, 0, 15).astype(np.uint8)
    if s.shape[-1] % 2:
        s = np.concatenate([s, np.zeros_like(s[..., :1])], -1)
    return (s[..., 0::2] << 4) | s[..., 1::2]


def unpack_sem4(p: torch.Tensor, width: int) -> torch.Tensor:
    """(..., H, ceil(W/2)) uint8 -> (..., H, W) int32 labels."""
    b = p.to(torch.int32)
    full = torch.stack([b >> 4, b & 15], -1).reshape(p.shape[:-1] + (2 * p.shape[-1],))
    return full[..., :width]


def _decode_flow(flow: torch.Tensor, height: int = 0, width: int = 0) -> torch.Tensor:
    """Accept int16 (x128 fixed point) or the packed 12-bit wire format
    (full- or half-resolution, told apart by the spatial dims)."""
    if flow.dtype == torch.uint8 and flow.shape[-1] == 3:
        if height and flow.shape[-3] < height:
            return unpack_flow12_half(flow, height, width)
        return unpack_flow12(flow)
    return flow.to(torch.float32) * (1.0 / 128.0)


def _decode_depth(depth: torch.Tensor, width: int) -> torch.Tensor:
    """Accept uint16 raw disparity*256 or the packed 12-bit wire format."""
    if depth.dtype == torch.uint8:
        return unpack_depth12(depth, width)
    return depth.to(torch.float32)


def _decode_sem(sem: torch.Tensor, width: int) -> torch.Tensor:
    """Accept uint8 labels or the packed 4-bit wire format."""
    if sem.shape[-1] != width:
        return unpack_sem4(sem, width)
    return sem.to(torch.int32)
