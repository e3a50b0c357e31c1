"""Multi-frame point tracks over a window, for the windowed BA.

Port of ``multimot_track_tpu.frontend.tracks``: tracks chained through the
dense flow fields (``chain_tracks``, and ``chain_tracks_zncc`` with a
per-link ZNCC re-centering), and tracks of re-detected keypoints linked by
projected descriptor matches (``build_window_tracks`` / ``link_detections``;
the per-link matching is kernel K2 on CUDA tensors).  Each of the JAX
package's ``lax.scan`` over the F-1 links is a loop here.  Images are single
(H, W) frames, as in the JAX package.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from multimot_track_tpu_torch.geometry import camera


class Tracks(NamedTuple):
    uv: torch.Tensor      # (F, N, 2) per-frame positions (frame 0 = keypoints)
    alive: torch.Tensor   # (F, N) observation validity (monotone decreasing)


def _nearest(img: torch.Tensor, uv: torch.Tensor) -> torch.Tensor:
    """Round-to-nearest sample of one (H, W) image at (N, 2) positions."""
    return camera.nearest_sample(img[None], uv[None])[0][0]


def _in_image(uv: torch.Tensor, W: int, H: int, margin: float) -> torch.Tensor:
    return ((uv[:, 0] >= margin) & (uv[:, 0] < W - margin)
            & (uv[:, 1] >= margin) & (uv[:, 1] < H - margin))


def _stack(first_uv, first_alive, uvs, alives) -> Tracks:
    return Tracks(uv=torch.stack([first_uv] + uvs), alive=torch.stack([first_alive] + alives))


def chain_tracks(start_uv: torch.Tensor, start_valid: torch.Tensor, flows: torch.Tensor,
                 sem_masks: torch.Tensor, margin: float = 2.0) -> Tracks:
    """Propagate keypoints (N, 2) through the flow chain (F-1, H, W, 2); a
    track dies when it leaves the image or lands on an instance mask
    (sem_masks (F, H, W), 0 = static)."""
    H, W = flows.shape[1], flows.shape[2]
    pos, alive = start_uv, start_valid
    uvs, alives = [], []
    for f in range(flows.shape[0]):
        pos = pos + camera.bilinear_sample(flows[f], pos)
        alive = alive & _in_image(pos, W, H, margin) & (_nearest(sem_masks[f + 1], pos) == 0)
        uvs.append(pos)
        alives.append(alive)
    return _stack(start_uv, start_valid, uvs, alives)


def build_window_tracks(grays, flows, depth0, sem_masks, n_kp: int = 3072,
                        radius: float = 15.0, max_depth: float = 40.0,
                        backend: str = "auto"):
    """Detection-linked static tracks over a window: FAST (4 levels,
    ``n_kp``) and ORB on every frame, off-mask keypoints, frame-0 depth in
    (0, max_depth); each link matched by projected descriptor matching with
    the flow as the prediction (radius 15, no ratio gate).  ``backend``: the
    matcher's route (``"auto" | "cuda" | "torch"``).
    Returns (Tracks, frame-0 depth per track (N,))."""
    from multimot_track_tpu_torch.frontend import fast, orb
    from multimot_track_tpu_torch.ops import matching

    uvs, valids, descs = [], [], []
    for f in range(len(grays)):
        g = grays[f].to(torch.float32)
        kp = fast.detect_pyramid(g[None], n_levels=4, n_total=n_kp)
        uv = kp.uv[0]
        d, _ = orb.describe(g, uv)
        uvs.append(uv)
        valids.append(kp.valid[0] & (_nearest(sem_masks[f], uv) == 0))
        descs.append(d)
    z0 = _nearest(depth0, uvs[0])
    valids[0] = valids[0] & (z0 > 0) & (z0 < max_depth)
    midx, mok = [], []
    for f in range(len(grays) - 1):
        fl = camera.bilinear_sample(flows[f], uvs[f])
        r = matching.match_projected_auto(
            descs[f], uvs[f] + fl, valids[f], descs[f + 1], uvs[f + 1], valids[f + 1],
            radius=radius, ratio=1.0, backend=backend,
        )
        midx.append(r.idx)
        mok.append(r.valid)
    tr = link_detections(torch.stack(uvs), torch.stack(valids), torch.stack(midx),
                         torch.stack(mok))
    return tr, z0


def link_detections(kp_uv: torch.Tensor, kp_valid: torch.Tensor, match_idx: torch.Tensor,
                    match_ok: torch.Tensor) -> Tracks:
    """Chain per-frame detected keypoints (F, N, ...) through descriptor
    matches (F-1, N): track i follows frame-0 keypoint i, and its frame-f
    position is the matched detection."""
    cur = torch.arange(kp_uv.shape[1], device=kp_uv.device)
    alive = kp_valid[0]
    uvs, alives = [], []
    for f in range(match_idx.shape[0]):
        nxt = match_idx[f][cur].long()
        alive = alive & match_ok[f][cur] & kp_valid[f + 1][nxt]
        cur = nxt
        uvs.append(kp_uv[f + 1][nxt])
        alives.append(alive)
    return _stack(kp_uv[0], kp_valid[0], uvs, alives)


def chain_tracks_zncc(start_uv: torch.Tensor, start_valid: torch.Tensor, flows: torch.Tensor,
                      grays: torch.Tensor, sem_masks: torch.Tensor, patch_radius: int = 2,
                      zncc_min: float = 0.7, search_radius: int = 2,
                      margin: float = 3.0) -> Tracks:
    """Flow-chained tracks with a per-link re-centering: each hop predicts
    through the flow, then locks onto the local ZNCC optimum of the previous
    frame's patch at the track's last position (template-update KLT)."""
    from multimot_track_tpu_torch.ops import photometric

    H, W = grays.shape[1], grays.shape[2]

    def patches(gray, uv):
        return photometric.extract_patches(gray[None], uv[None], patch_radius)[0]

    pos, alive = start_uv, start_valid
    patch_prev = patches(grays[0], start_uv)
    uvs, alives = [], []
    for f in range(flows.shape[0]):
        pred = pos + camera.bilinear_sample(flows[f], pos)
        pos, sc = photometric.refine_position(grays[f + 1], pred, patch_prev, patch_radius,
                                              search_radius)
        alive = (alive & _in_image(pos, W, H, margin)
                 & (_nearest(sem_masks[f + 1], pos) == 0) & (sc > zncc_min))
        patch_prev = patches(grays[f + 1], pos)
        uvs.append(pos)
        alives.append(alive)
    return _stack(start_uv, start_valid, uvs, alives)
