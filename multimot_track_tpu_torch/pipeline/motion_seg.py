"""Mask-free object discovery: motion segmentation from geometry alone.

Port of ``multimot_track_tpu.pipeline.motion_seg``:

  1. sample a coarse grid with valid depth in both frames,
  2. flag dynamic candidates by their 3-D scene-flow residual against the
     ego motion (0.12 m plus a depth-squared allowance),
  3. fit rigid-motion hypotheses from candidate neighbourhoods, with the
     ego motion as the static label 0,
  4. solve the multi-label MRF (``ops/graphcut``) for per-point labels,
  5. rasterise the labels into an instance mask the pipeline consumes in
     place of given masks.

Everything runs on the device of the depth images; the hypothesis seeds
come from a ``ransac.HypothesisSampler`` at the caller's ``site``.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from multimot_track_tpu_torch.geometry import camera, se3
from multimot_track_tpu_torch.ops import graphcut
from multimot_track_tpu_torch.solvers.ransac import Sites


class DiscoveredObjects(NamedTuple):
    uv: torch.Tensor        # (N, 2) grid points (last frame)
    uv_cur: torch.Tensor    # (N, 2) flow-shifted positions (current frame)
    labels: torch.Tensor    # (N,) 0 = static/ego, k >= 1 motion cluster
    valid: torch.Tensor     # (N,)
    energy: torch.Tensor


def _discovery_problem(sampler, site, depth0, depth1, flow, T_rel, fx, fy, cx, cy,
                       step: int = 8, n_max: int = 1024, n_hyp: int = 24,
                       sf_thres: float = 0.12, max_depth: float = 40.0,
                       sf_depth_coeff: float = 0.002):
    """Everything up to the MRF labelling: candidate extraction, hypothesis
    sampling, data costs, smoothness graph.  depth0, depth1 (H, W) metric
    depth of frames k-1 and k, flow (H, W, 2) from k-1 to k, T_rel (4, 4)
    the ego motion cam_{k-1} -> cam_k.  Returns (c_uv0, c_uv1, D, graph, mask)."""
    dev = depth0.device
    H, W = depth0.shape
    yy, xx = torch.meshgrid(torch.arange(0, H, step, device=dev),
                            torch.arange(0, W, step, device=dev), indexing="ij")
    uv0 = torch.stack([xx, yy], -1).reshape(-1, 2).to(torch.float32)
    d0 = depth0[yy, xx].reshape(-1)
    uv1 = uv0 + flow[yy, xx].reshape(-1, 2)
    d1, inb = camera.nearest_sample(depth1[None], uv1[None])
    d1, inb = d1[0], inb[0]
    ok = (d0 > 0) & (d0 < max_depth) & inb & (d1 > 0) & (d1 < max_depth)

    X0 = camera.backproject(uv0, d0, fx, fy, cx, cy)     # last-camera frame
    X1 = camera.backproject(uv1, d1, fx, fy, cx, cy)     # current-camera frame
    resid = torch.linalg.vector_norm(X1 - se3.transform(T_rel, X0), dim=-1)
    # depth-adaptive gate: disparity noise alone moves far points by about
    # z^2 / bf * delta_d, which would flood the n_max slots with background
    dynamic = ok & (resid > sf_thres + sf_depth_coeff * d0 * d0)

    # compact the dynamic candidates into n_max slots, in grid order; the
    # rest (and any overflow) land in a dump slot past the end
    slots = torch.cumsum(dynamic.to(torch.int64), 0) - 1
    tgt = torch.where(dynamic, slots, n_max).clamp(max=n_max)
    mask = torch.arange(n_max, device=dev) < dynamic.sum()

    def take(arr):
        out = torch.zeros((n_max + 1,) + arr.shape[1:], dtype=arr.dtype, device=dev)
        out[tgt] = arr
        return out[:n_max]

    c_uv0, c_uv1, c_X0, c_X1 = take(uv0), take(uv1), take(X0), take(X1)
    graph = graphcut.build_knn_graph(c_uv1, mask, k=6)
    # hypothesis seeds: with replacement, uniform over the candidates
    p = mask.to(torch.float32) / torch.clamp(mask.sum(), min=1).to(torch.float32)
    seeds = sampler(p[None], n_hyp, Sites([site]), k=1)[0, :, 0].to(dev)
    hyp = graphcut.sample_motion_hypotheses(seeds, graph, c_X0, c_X1)
    # label 0 is the ego (static) motion; duplicate hypotheses are masked
    hyps = torch.cat([T_rel[None].to(hyp.dtype), hyp], 0)
    keep = graphcut.dedupe_hypotheses(hyps)
    D = graphcut.data_costs(hyps, c_X0, c_uv1, fx, fy, cx, cy)
    D = torch.where(keep[None, :], D, 1e9)
    return c_uv0, c_uv1, D, graph, mask


def discover_objects(sampler, site, depth0, depth1, flow, T_rel, fx, fy, cx, cy,
                     **kw) -> DiscoveredObjects:
    """Discovery with the relaxed MRF labeler (``graphcut.segment``), the
    live path.  ``kw``: step, n_max, n_hyp and the gates of
    ``_discovery_problem``."""
    c_uv0, c_uv1, D, graph, mask = _discovery_problem(
        sampler, site, depth0, depth1, flow, T_rel, fx, fy, cx, cy, **kw)
    labels, energy = graphcut.segment(D, graph)
    return DiscoveredObjects(uv=c_uv0, uv_cur=c_uv1, labels=labels, valid=mask, energy=energy)


def discover_objects_exact(sampler, site, depth0, depth1, flow, T_rel, fx, fy, cx, cy,
                           **kw) -> DiscoveredObjects:
    """Discovery with the exact alpha-expansion labeler on the host
    (``graphcut.segment_exact``); the problem is built on the device as in
    ``discover_objects``.  The offline-quality option."""
    c_uv0, c_uv1, D, graph, mask = _discovery_problem(
        sampler, site, depth0, depth1, flow, T_rel, fx, fy, cx, cy, **kw)
    labels, energy = graphcut.segment_exact(D, graph)
    dev = D.device
    return DiscoveredObjects(uv=c_uv0, uv_cur=c_uv1,
                             labels=torch.from_numpy(labels).to(torch.int64).to(dev),
                             valid=mask, energy=torch.tensor(energy, device=dev))


def rasterize_labels(disc: DiscoveredObjects, height: int, width: int,
                     step: int = 8) -> torch.Tensor:
    """Paint discovered labels into an instance-mask image (each grid point
    fills its step x step cell); label 0 (ego) stays background."""
    return rasterize_labels_at(disc.uv, disc.labels, disc.valid, height, width, step)


def rasterize_labels_at(uv: torch.Tensor, labels: torch.Tensor, valid: torch.Tensor,
                        height: int, width: int, step: int = 8) -> torch.Tensor:
    """Rasterise labels at any positions, e.g. the flow-shifted points that
    give the current frame's mask from a discovery on the previous frame.

    A cell index in [-n, 0) wraps to n + index and any other index outside
    [0, n) is dropped, as the JAX package's ``.at[].max(mode="drop")``
    scatter does.  Overlapping points keep the largest label."""
    dev = uv.device
    h, w = height // step + 1, width // step + 1
    xi = torch.round(uv[:, 0] / step).to(torch.int64)
    yi = torch.round(uv[:, 1] / step).to(torch.int64)
    xi = torch.where(xi < 0, xi + w, xi)
    yi = torch.where(yi < 0, yi + h, yi)
    keep = (xi >= 0) & (xi < w) & (yi >= 0) & (yi < h)
    lab = torch.where(valid & (labels > 0) & keep, labels, 0).to(torch.int32)
    flat = torch.where(keep, yi * w + xi, 0)
    img = torch.zeros(h * w, dtype=torch.int32, device=dev).scatter_reduce(
        0, flat, lab, "amax").view(h, w)
    big = img.repeat_interleave(step, 0).repeat_interleave(step, 1)
    return big[:height, :width]
