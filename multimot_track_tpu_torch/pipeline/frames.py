"""Per-frame observation tensors and frame-pair construction, batched.

Port of ``multimot_track_tpu.pipeline.frames``: every tensor carries a
leading batch axis B (frames, or pairs).  The current frame inherits the
last frame's flow-shifted positions, so index i of a pair refers to the
same physical point in both frames (src/Tracking.cc:487-610 of the
reference system).
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import numpy as np
import torch

from multimot_track_tpu_torch.config import PipelineConfig
from multimot_track_tpu_torch.frontend import fast, sampling
from multimot_track_tpu_torch.geometry import camera
from multimot_track_tpu_torch.ops import photometric


def tree_map(fn, *trees):
    """Apply ``fn`` leafwise over nested NamedTuples, tuples, lists and dicts
    of identical structure; every other value is a leaf (the pytree map the
    port's (B, ...) state and its pair batches need)."""
    t0 = trees[0]
    if isinstance(t0, tuple) and hasattr(t0, "_fields"):
        return type(t0)(*(tree_map(fn, *xs) for xs in zip(*trees)))
    if isinstance(t0, (tuple, list)):
        return type(t0)(tree_map(fn, *xs) for xs in zip(*trees))
    if isinstance(t0, dict):
        return {k: tree_map(fn, *(t[k] for t in trees)) for k in t0}
    return fn(*trees)


def tree_leaves(tree) -> list:
    """The leaves of a nest of NamedTuples, tuples, lists and dicts, in
    ``tree_map`` order."""
    out = []
    tree_map(out.append, tree)
    return out


class GTTable(NamedTuple):
    """Ground-truth per-frame data, padded to k_obj_max entries."""

    Tcw: torch.Tensor        # (B, 4, 4) GT world->camera pose (normalised)
    obj_ids: torch.Tensor    # (B, K) int32 GT object ids (== mask labels)
    obj_L: torch.Tensor      # (B, K, 4, 4) camera-frame object poses
    obj_valid: torch.Tensor  # (B, K) bool


class FrameObservation(NamedTuple):
    """A frame's own samples."""

    static: sampling.StaticSamples
    objects: sampling.ObjSamples
    gt: GTTable


class PairInputs(NamedTuple):
    """Everything the pair tracker consumes, (B, ...).  Index i of every
    st_* tensor is one background point seen in the last frame at st_uv and
    in the current frame at st_cur_uv; likewise ob_* for object points."""

    st_uv: torch.Tensor         # (B, Ns, 2)
    st_flow: torch.Tensor       # (B, Ns, 2)
    st_depth: torch.Tensor      # (B, Ns)
    st_cur_uv: torch.Tensor     # (B, Ns, 2)
    st_cur_depth: torch.Tensor  # (B, Ns)
    st_valid: torch.Tensor      # (B, Ns) bool
    st_zncc: torch.Tensor       # (B, Ns) flow-verification score

    ob_uv: torch.Tensor         # (B, No, 2)
    ob_flow: torch.Tensor       # (B, No, 2)
    ob_depth: torch.Tensor      # (B, No)
    ob_label_last: torch.Tensor  # (B, No)
    ob_cur_uv: torch.Tensor     # (B, No, 2)
    ob_cur_depth: torch.Tensor  # (B, No)
    ob_cur_label: torch.Tensor  # (B, No)
    ob_valid: torch.Tensor      # (B, No) bool
    ob_patch: torch.Tensor      # (B, No, P)
    cur_gray: torch.Tensor      # (B, H, W)

    gt_last: GTTable
    gt_cur: GTTable


def build_frame_observation(
    gray: torch.Tensor,
    depth_raw: torch.Tensor,
    flow: torch.Tensor,
    sem_mask: torch.Tensor,
    gt: GTTable,
    cfg: PipelineConfig,
    generator: Optional[torch.Generator] = None,
) -> FrameObservation:
    """Run the frontend on a stack of B frames.

    With ``cfg.solver.depth_noise`` (or ``flow_outliers``) set and a
    generator given, the reference's synthetic depth noise (or outlier flow)
    is injected, drawn from that generator."""
    fe = cfg.frontend
    pad = cfg.padding
    depth = camera.disparity_png_to_depth(depth_raw, cfg.camera.bf)
    if cfg.solver.depth_noise and generator is not None:
        sigma = depth * depth / (725.0 * 0.5) * cfg.solver.depth_noise_scale
        noise = sigma * torch.randn(depth.shape, generator=generator,
                                    device=depth.device)
        depth = torch.where(depth > 0, torch.clamp(depth + noise, min=1e-3), depth)
    if cfg.solver.flow_outliers and generator is not None:
        hit = torch.rand(flow.shape[:-1] + (1,), generator=generator,
                         device=flow.device) < cfg.solver.flow_outlier_frac
        mag = torch.randn(flow.shape, generator=generator,
                          device=flow.device) * cfg.solver.flow_outlier_mag
        flow = torch.where(hit, flow + mag, flow)
    kp = fast.detect_pyramid(
        gray,
        threshold=float(fe.fast_threshold),
        min_threshold=float(fe.fast_min_threshold),
        n_levels=fe.n_levels,
        scale_factor=fe.scale_factor,
        n_total=fe.n_features,
    )
    static = sampling.sample_static(
        kp.uv, kp.valid, depth, sem_mask, flow, gray,
        max_depth=fe.static_max_depth, n_max=pad.n_static_max,
        patch_radius=cfg.solver.zncc_patch_radius,
    )
    objects = sampling.sample_dense_objects(
        depth, sem_mask, flow, gray,
        step=fe.obj_sample_step, max_depth=fe.obj_max_depth,
        n_max=pad.n_obj_pts_max, patch_radius=cfg.solver.zncc_patch_radius,
    )
    return FrameObservation(static=static, objects=objects, gt=gt)


def build_pair(
    last: FrameObservation,
    cur_depth_raw: torch.Tensor,
    cur_sem_mask: torch.Tensor,
    gt_cur: GTTable,
    cfg: PipelineConfig,
    cur_gray: torch.Tensor = None,
) -> PairInputs:
    """Correspondence handoff.  Static current depth is read at round(pos)
    when strictly inside the image, else -1; object points out of bounds get
    depth 0.1 and label 0.  With ``cur_gray`` each static correspondence
    gets a ZNCC verification score, otherwise 1."""
    cur_depth = camera.disparity_png_to_depth(cur_depth_raw, cfg.camera.bf)

    st_cur_uv = last.static.corres
    st_d, st_inb = camera.nearest_sample(cur_depth, st_cur_uv)
    st_cur_depth = torch.where(st_inb & (st_d > 0), st_d, torch.full_like(st_d, -1.0))

    if cur_gray is None:
        st_zncc = torch.ones(st_cur_uv.shape[:-1], dtype=torch.float32,
                             device=st_cur_uv.device)
    else:
        cur_gray = cur_gray.to(torch.float32)
        cur_patch = photometric.extract_patches(
            cur_gray, st_cur_uv, cfg.solver.zncc_patch_radius)
        st_zncc = photometric.zncc(last.static.patch, cur_patch)

    ob_cur_uv = last.objects.corres
    ob_d, ob_inb = camera.nearest_sample(cur_depth, ob_cur_uv)
    ob_l, _ = camera.nearest_sample(cur_sem_mask, ob_cur_uv)
    ob_cur_depth = torch.where(ob_inb, ob_d, torch.full_like(ob_d, 0.1))
    ob_cur_label = torch.where(ob_inb, ob_l, torch.zeros_like(ob_l))

    return PairInputs(
        st_uv=last.static.uv,
        st_flow=last.static.flow,
        st_depth=last.static.depth,
        st_cur_uv=st_cur_uv,
        st_cur_depth=st_cur_depth,
        st_valid=last.static.valid & (last.static.depth > 0),
        st_zncc=st_zncc,
        ob_uv=last.objects.uv,
        ob_flow=last.objects.flow,
        ob_depth=last.objects.depth,
        ob_label_last=last.objects.label,
        ob_cur_uv=ob_cur_uv,
        ob_cur_depth=ob_cur_depth,
        ob_cur_label=ob_cur_label,
        ob_valid=last.objects.valid,
        ob_patch=last.objects.patch,
        cur_gray=cur_gray if cur_gray is not None else torch.zeros_like(cur_depth),
        gt_last=last.gt,
        gt_cur=gt_cur,
    )


def make_gt_table(pose_gt_raw, obj_ids, obj_poses, k_max: int, origin_inv=None):
    """Host-side: normalise the GT pose (Tcw = inv(Twc_disk)) and pad the
    object table.  Returns a numpy GTTable without the batch axis; stack
    tables with ``stack_gt`` to make the (B, ...) device form."""
    Twc = np.asarray(pose_gt_raw, np.float32)
    R = Twc[:3, :3]
    t = Twc[:3, 3]
    Tcw = np.eye(4, dtype=np.float32)
    Tcw[:3, :3] = R.T
    Tcw[:3, 3] = -R.T @ t
    if origin_inv is not None:
        Tcw = Tcw @ np.asarray(origin_inv, np.float32)
    ids = np.zeros(k_max, np.int32)
    Ls = np.tile(np.eye(4, dtype=np.float32), (k_max, 1, 1))
    val = np.zeros(k_max, bool)
    m = min(len(obj_ids), k_max)
    if m:
        ids[:m] = np.asarray(obj_ids[:m], np.int32)
        Ls[:m] = np.asarray(obj_poses[:m], np.float32)
        val[:m] = True
    return GTTable(Tcw=Tcw, obj_ids=ids, obj_L=Ls, obj_valid=val)


def stack_gt(tables, device) -> GTTable:
    """Stack numpy GTTables into one (B, ...) tensor GTTable on ``device``."""
    return GTTable(*(
        torch.from_numpy(np.stack([getattr(t, f) for t in tables])).to(device)
        for f in GTTable._fields
    ))
