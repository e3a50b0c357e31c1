"""Stereo depth: dense block-matching disparity + keypoint refinement.

Port of ``multimot_track_tpu.frontend.stereo``.  The reference's stereo
path (``ComputeStereoMatches``, src/Frame.cc:854-1035) gives per-keypoint
depth; the pipeline's frontend consumes a dense depth image, so
``dense_disparity`` computes a dense disparity map: SAD block matching over
shifted absolute differences, box-filtered with separable running sums,
winner-takes-all with a uniqueness ratio, 3-point parabola sub-pixel
refinement and a left-right consistency check.

The JAX package scans the disparities one at a time (``lax.scan``); here a
block of ``chunk`` disparities is one batched tensor, reduced to the same
best, second best and first index of the best as the scan.  For 8-bit
input every cost is an integer sum below 2**24 (the column sums stay under
375 * 255, the row sums of those under 1242 * 2295), so float32 holds them
exactly in any order of summation and the integer disparities equal the
JAX package's; the cost slices still round through bfloat16 before the
sub-pixel parabola reads them, as there.

``disparity_to_depth_raw`` emits the uint16-style disparity*256 encoding
the KITTI RGB-D loader consumes, so the RGB-D pipeline runs unchanged on
stereo input.  ``quad_temporal_matches`` is the quad gate of the stereo
reader (``ORBmatcher::SearchByQuad``).
"""

from __future__ import annotations

import torch

from multimot_track_tpu_torch.frontend import fast, orb
from multimot_track_tpu_torch.geometry import camera as cam_g
from multimot_track_tpu_torch.ops import matching

INF = float("inf")
# disparities evaluated as one batched block: ~6 * CHUNK * H * W * 4 bytes
# of temporaries (~180 MB at 1242 x 375)
CHUNK = 16


def _box_filter(img: torch.Tensor, radius: int) -> torch.Tensor:
    """Separable box sum over the last two axes with edge clamping via
    cumulative sums (any leading axes are a batch)."""
    for axis in (-2, -1):
        cs = torch.cumsum(img, dim=axis)
        n = img.shape[axis]
        ar = torch.arange(n, device=img.device)
        hi = torch.index_select(cs, axis, torch.clamp(ar + radius, 0, n - 1))
        lo = torch.index_select(cs, axis, torch.clamp(ar - radius - 1, 0, n - 1))
        keep = (ar - radius - 1 >= 0).view((n, 1) if axis == -2 else (n,))
        img = hi - torch.where(keep, lo, torch.zeros((), dtype=lo.dtype, device=lo.device))
    return img


def _costs(fixed: torch.Tensor, moving: torch.Tensor, ds: torch.Tensor, sign: int,
           radius: int) -> torch.Tensor:
    """(len(ds), H, W) box-filtered |fixed - roll(moving, sign * d, axis=1)|,
    inf where the roll wrapped (``sign`` +1: x < d, -1: x >= W - d)."""
    H, W = fixed.shape
    cols = torch.arange(W, device=fixed.device)
    src = torch.remainder(cols[None, :] - sign * ds[:, None], W)          # (D, W)
    shifted = moving[:, src].permute(1, 0, 2)                              # (D, H, W)
    c = _box_filter(torch.abs(fixed[None] - shifted), radius)
    valid = (cols[None, :] >= ds[:, None]) if sign > 0 else (cols[None, :] < W - ds[:, None])
    return torch.where(valid[:, None, :], c, torch.full((), INF, device=c.device))


def _first_min(c: torch.Tensor, ds: torch.Tensor):
    """Over axis 0: (min, second smallest with repeats, first index of the
    min), the state a running scan with a strict ``<`` ends in."""
    best = c.amin(0)
    is_min = c == best[None]
    big = torch.iinfo(torch.int32).max
    bestd = torch.where(is_min, ds[:, None, None], big).amin(0)
    first = is_min & (ds[:, None, None] == bestd[None])
    second = torch.where(first, torch.full((), INF, device=c.device), c).amin(0)
    return best, second, bestd


def _merge(a, b):
    """Combine two scans' states, ``a`` over the earlier disparities."""
    best_a, second_a, d_a = a
    best_b, second_b, d_b = b
    take_b = best_b < best_a
    best = torch.minimum(best_a, best_b)
    second = torch.minimum(torch.maximum(best_a, best_b), torch.minimum(second_a, second_b))
    return best, second, torch.where(take_b, d_b, d_a)


def dense_disparity(left: torch.Tensor, right: torch.Tensor, max_disp: int = 128,
                    radius: int = 4, uniqueness: float = 0.95) -> torch.Tensor:
    """(H, W) float32 disparity of a rectified pair; invalid pixels get 0.

    SAD block matching with winner-takes-all + parabola subpixel + a
    uniqueness check (best must beat runner-up by the given ratio) + a
    left-right check, ``CHUNK`` disparities at a time."""
    left = left.to(torch.float32)
    right = right.to(torch.float32)
    H, W = left.shape
    dev = left.device
    cols = torch.arange(W, device=dev)
    rows = torch.arange(H, device=dev)[:, None]
    costs = torch.empty((max_disp, H, W), dtype=torch.bfloat16, device=dev)
    state = state_r = None
    for d0 in range(0, max_disp, CHUNK):
        ds = torch.arange(d0, min(d0 + CHUNK, max_disp), dtype=torch.int32, device=dev)
        c = _costs(left, right, ds, 1, radius)
        costs[d0:d0 + len(ds)] = c.to(torch.bfloat16)
        blk = _first_min(c, ds)
        state = blk if state is None else _merge(state, blk)
        # right-to-left matching, for the consistency check
        blk_r = _first_min(_costs(right, left, ds, -1, radius), ds)
        state_r = blk_r if state_r is None else _merge(state_r, blk_r)
    best, second, bestd = state
    bestd_r = state_r[2]

    # subpixel: the bf16-rounded costs at d-1, d, d+1
    dm = torch.clamp(bestd - 1, 0, max_disp - 1).long()
    dp = torch.clamp(bestd + 1, 0, max_disp - 1).long()
    c0 = costs[bestd.long(), rows, cols].to(torch.float32)
    cm = costs[dm, rows, cols].to(torch.float32)
    cp = costs[dp, rows, cols].to(torch.float32)
    denom = cm + cp - 2.0 * c0
    delta = torch.where(torch.abs(denom) > 1e-6, 0.5 * (cm - cp) / denom,
                        torch.zeros((), device=dev))
    disp = bestd.to(torch.float32) + torch.clamp(delta, -1.0, 1.0)

    ok = (torch.isfinite(best) & (best <= uniqueness * second)
          & (bestd > 0) & (bestd < max_disp - 1))
    disp = torch.where(ok, disp, torch.zeros((), device=dev))

    # left-right consistency: for left pixel x with disparity d, the
    # right-image match at x-d must carry (about) the same disparity
    xr = torch.clamp(cols[None, :] - torch.round(disp).to(torch.int64), 0, W - 1)
    d_back = torch.gather(bestd_r.long(), 1, xr).to(torch.float32)
    consistent = torch.abs(d_back - disp) <= 1.0
    return torch.where(consistent, disp, torch.zeros((), device=dev))


def disparity_to_depth_raw(disp: torch.Tensor) -> torch.Tensor:
    """Dense disparity -> the loader's raw png encoding (value = disp*256,
    src/Tracking.cc:447-456 consumes depth = bf/(raw/256))."""
    return torch.where(disp > 0, disp * 256.0, torch.zeros((), device=disp.device))


def keypoint_disparity(left: torch.Tensor, right: torch.Tensor, uv: torch.Tensor,
                       max_disp: int = 128, radius: int = 5):
    """Per-keypoint scanline SAD search + parabola subpixel — the direct
    analog of ComputeStereoMatches for sparse use.  Returns (disp, valid)."""
    H, W = left.shape
    dev = left.device
    xi = torch.clamp(torch.round(uv[:, 0]).to(torch.int64), 0, W - 1)
    yi = torch.clamp(torch.round(uv[:, 1]).to(torch.int64), 0, H - 1)
    off = torch.arange(-radius, radius + 1, device=dev)
    N, P = uv.shape[0], off.numel()
    py = torch.clamp(yi[:, None, None] + off[None, :, None], 0, H - 1).expand(N, P, P)
    px_l = torch.clamp(xi[:, None, None] + off[None, None, :], 0, W - 1).expand(N, P, P)
    patch_l = left[py, px_l]
    ds = torch.arange(max_disp, device=dev)
    px_r = torch.clamp(px_l[None] - ds[:, None, None, None], 0, W - 1)  # (D, N, P, P)
    patch_r = right[py[None].expand_as(px_r), px_r]
    costs = torch.abs(patch_l[None] - patch_r).sum((2, 3))               # (D, N)
    best = _first_min(costs[:, :, None], ds.to(torch.int32))[2][:, 0].long()
    n = torch.arange(costs.shape[1], device=dev)
    c0 = costs[best, n]
    cm = costs[torch.clamp(best - 1, 0, max_disp - 1), n]
    cp = costs[torch.clamp(best + 1, 0, max_disp - 1), n]
    denom = cm + cp - 2.0 * c0
    delta = torch.where(torch.abs(denom) > 1e-6, 0.5 * (cm - cp) / denom,
                        torch.zeros((), device=dev))
    disp = best.to(torch.float32) + torch.clamp(delta, -1.0, 1.0)
    valid = (best > 0) & (best < max_disp - 1) & (xi - best >= 0)
    return disp, valid


def quad_temporal_matches(gray_L0: torch.Tensor, gray_R0: torch.Tensor,
                          gray_L1: torch.Tensor, gray_R1: torch.Tensor,
                          disp0: torch.Tensor, disp1: torch.Tensor, flow0: torch.Tensor,
                          n_kp: int = 512, radius: float = 15.0):
    """Quad-consistent stereo-temporal matching (``ORBmatcher::SearchByQuad``,
    src/ORBmatcher.cc:1704-1842, with the vDescIndex L/R association,
    src/Frame.cc:854-1035): FAST on each left view; ORB descriptors on the
    left keypoints and on their disparity-shifted right positions; flow
    predicts the temporal search centre; ``matching.search_by_quad`` fuses
    the four-view criterion.

    Returns (uv0, uv1, valid): matched current positions per last-frame
    keypoint slot."""
    kp0 = fast.detect_pyramid(gray_L0[None], n_levels=4, n_total=n_kp)
    kp1 = fast.detect_pyramid(gray_L1[None], n_levels=4, n_total=n_kp)
    d0, in0 = cam_g.nearest_sample(disp0[None], kp0.uv)
    d1, in1 = cam_g.nearest_sample(disp1[None], kp1.uv)
    fx, _ = cam_g.nearest_sample(flow0[None, ..., 0], kp0.uv)
    fy, _ = cam_g.nearest_sample(flow0[None, ..., 1], kp0.uv)
    (uv0, v0, d0, in0, uv1, v1, d1, in1, fx, fy) = (
        t[0] for t in (kp0.uv, kp0.valid, d0, in0, kp1.uv, kp1.valid, d1, in1, fx, fy))
    uvR0 = uv0 - torch.stack([d0, torch.zeros_like(d0)], -1)
    uvR1 = uv1 - torch.stack([d1, torch.zeros_like(d1)], -1)
    descL0, _ = orb.describe(gray_L0, uv0)
    descR0, _ = orb.describe(gray_R0, uvR0)
    descL1, _ = orb.describe(gray_L1, uv1)
    descR1, _ = orb.describe(gray_R1, uvR1)
    uv_pred = uv0 + torch.stack([fx, fy], -1)
    valid0 = v0 & in0 & (d0 > 0) & (uvR0[:, 0] >= 0)
    valid1 = v1 & in1 & (d1 > 0) & (uvR1[:, 0] >= 0)
    res = matching.search_by_quad(descL0, descR0, descL1, descR1, uv_pred, uv1,
                                  valid0, valid1, radius=radius)
    return uv0, uv1[res.idx], res.valid
