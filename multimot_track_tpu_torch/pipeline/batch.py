"""Batched and streaming sequence tracking on a torch device.

Port of ``multimot_track_tpu.pipeline.batch``.  Expressed in the last
camera's frame every pair's solves are independent, so a sequence tracks
as (1) the frontend over all frames, (2) all pairs of a chunk solved at
once as one (B, ...) batch, (3) a host post-pass that composes the
trajectory, world-frame object motions and track IDs.

The drivers take an explicit ``device``.  They never move to the CPU when
the device is missing: a CUDA device that is not there raises.
"""

from __future__ import annotations

from typing import List, Optional

import numpy as np
import torch

from multimot_track_tpu_torch import state
from multimot_track_tpu_torch.config import DEFAULT_CONFIG, PipelineConfig
from multimot_track_tpu_torch.geometry import se3
from multimot_track_tpu_torch.io.frame import check_frame
from multimot_track_tpu_torch.ops.wire import (
    _decode_depth, _decode_flow, _decode_sem, pack_depth12, pack_flow12, pack_flow12_half,
    pack_sem4,
)
from multimot_track_tpu_torch.pipeline import frames as F
from multimot_track_tpu_torch.pipeline import tracker
from multimot_track_tpu_torch.solvers.ransac import HypothesisSampler, MultinomialSampler

# frames per frontend pass: bounds the FAST pyramid's (16, frames, H, W)
# intermediates without changing any result
FRONTEND_CHUNK = 8


def _slice(tree, sl):
    return F.tree_map(lambda x: x[sl], tree)


def _cat(trees):
    return F.tree_map(lambda *xs: torch.cat(xs, 0), *trees)


def frontend_batch(gray_u8, depth_w, flow_w, sem_w, gts: F.GTTable,
                   cfg: PipelineConfig) -> F.FrameObservation:
    """Stacked wire images (F, H, W[, C]) -> stacked FrameObservations."""
    H, W = cfg.camera.height, cfg.camera.width
    obs = []
    for c0 in range(0, gray_u8.shape[0], FRONTEND_CHUNK):
        sl = slice(c0, c0 + FRONTEND_CHUNK)
        obs.append(F.build_frame_observation(
            gray_u8[sl].to(torch.float32), _decode_depth(depth_w[sl], W),
            _decode_flow(flow_w[sl], H, W), _decode_sem(sem_w[sl], W),
            _slice(gts, sl), cfg,
        ))
    return _cat(obs)


def track_pairs(prev_obs: F.FrameObservation, cur_gray_u8, cur_depth_w, cur_sem_w,
                gt_cur: F.GTTable, cfg: PipelineConfig, sampler: HypothesisSampler,
                pair_ids) -> tracker.PairResult:
    """Solve B pre-paired frames in last-camera coordinates.  Returns the
    (B, ...) PairResult whose Tcw_cur is each pair's relative motion."""
    B = cur_gray_u8.shape[0]
    dev = cur_gray_u8.device
    eye = torch.eye(4, device=dev).expand(B, 4, 4)
    # anchor GT to each pair's own last-camera frame so the device-side
    # object metrics compare motions in commensurate worlds
    G = se3.inverse(prev_obs.gt.Tcw)
    gt_cur_rel = gt_cur._replace(Tcw=gt_cur.Tcw @ G)
    prev_rel = prev_obs._replace(gt=prev_obs.gt._replace(Tcw=eye))
    pair = F.build_pair(
        prev_rel,
        _decode_depth(cur_depth_w, cfg.camera.width),
        _decode_sem(cur_sem_w, cfg.camera.width),
        gt_cur_rel, cfg, cur_gray=cur_gray_u8.to(torch.float32),
    )
    ctx = tracker.initial_context(cfg.padding.k_obj_max, B, dev)
    res = tracker.track_pairs(pair, ctx, cfg, sampler, pair_ids)
    return res._replace(obj_label_map=torch.zeros((B, 0), dtype=torch.int32, device=dev))


def track_batch(obs_stack, gray_u8, depth_w, sem_w, gts, cfg, sampler, pair_ids):
    """Solve all F-1 pairs of a stacked chunk at once (thin pairing wrapper
    over ``track_pairs``)."""
    return track_pairs(_slice(obs_stack, slice(None, -1)), gray_u8[1:], depth_w[1:],
                       sem_w[1:], _slice(gts, slice(1, None)), cfg, sampler, pair_ids)


def stream_chunk(carry_obs: F.FrameObservation, gray_u8, depth_w, flow_w, sem_w,
                 gts: F.GTTable, cfg: PipelineConfig, sampler: HypothesisSampler, pair_ids):
    """One serving stage: C new frames in, C solved pairs out.
    ``carry_obs`` is the previous chunk's last observation (batch 1, on the
    device: the boundary frame is never uploaded or described again).
    Returns (the (C, ...) PairResult, this chunk's last observation)."""
    obs = frontend_batch(gray_u8, depth_w, flow_w, sem_w, gts, cfg)
    prev = _cat([carry_obs, _slice(obs, slice(None, -1))])
    res = track_pairs(prev, gray_u8, depth_w, sem_w, gts, cfg, sampler, pair_ids)
    return res, _slice(obs, slice(-1, None))


def pack_frame_wire(fd, cfg: PipelineConfig = DEFAULT_CONFIG):
    """Host-side wire packing of one FrameData: gray8 + depth12 +
    half-resolution flow12 + sem4."""
    return dict(
        gray=np.clip(np.round(fd.gray), 0, 255).astype(np.uint8),
        depth=pack_depth12(np.clip(fd.depth_raw, 0, 65535).astype(np.uint16)),
        flow=pack_flow12_half(fd.flow),
        sem=pack_sem4(fd.sem_mask),
    )


def upload_frames(frame_list: List, cfg: PipelineConfig, device):
    """The batched driver's wire: stacked (F, ...) gray8, raw disparity,
    full-resolution flow12 and sem4 on ``device``, and the GT tables.
    Raises ``ValueError`` for a frame whose size is not the camera config's."""
    for fd in frame_list:
        check_frame(fd, cfg.camera)
    up = lambda a: torch.from_numpy(np.ascontiguousarray(np.stack(a))).to(device)
    gray_u8 = up([np.clip(np.round(fd.gray), 0, 255).astype(np.uint8) for fd in frame_list])
    # uint16 disparity travels as int32: same values, wider torch support
    depth_w = up([np.clip(fd.depth_raw, 0, 65535).astype(np.uint16).astype(np.int32)
                  for fd in frame_list])
    flow_w = up([pack_flow12(fd.flow) for fd in frame_list])
    sem_w = up([pack_sem4(fd.sem_mask) for fd in frame_list])
    K = cfg.padding.k_obj_max
    gts = F.stack_gt([F.make_gt_table(fd.pose_gt, fd.obj_ids_gt, fd.obj_poses_gt, K)
                      for fd in frame_list], device)
    return gray_u8, depth_w, flow_w, sem_w, gts


def _setup(device, seed, sampler):
    """Driver entry: exact float32 matmuls and convolutions on the card, and
    the default hypothesis sampler."""
    device = torch.device(device)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    if sampler is None:
        sampler = MultinomialSampler(torch.Generator(device=device).manual_seed(seed))
    return device, sampler


def run_sequence_batched(
    frame_list: List,
    cfg: PipelineConfig = DEFAULT_CONFIG,
    seed: int = 0,
    max_pairs_per_call: int = 16,
    device="cuda",
    sampler: Optional[HypothesisSampler] = None,
):
    """End-to-end batched tracking of FrameData records on ``device``.

    Returns (Tcw trajectory (F, 4, 4), stacked PairResult as numpy, object
    records)."""
    device, sampler = _setup(device, seed, sampler)
    Fn = len(frame_list)
    gray_u8, depth_w, flow_w, sem_w, gt_stack = upload_frames(frame_list, cfg, device)
    obs = frontend_batch(gray_u8, depth_w, flow_w, sem_w, gt_stack, cfg)
    n_pairs = Fn - 1
    chunks = []
    for c0 in range(0, n_pairs, max_pairs_per_call):
        c1 = min(c0 + max_pairs_per_call, n_pairs)
        sl = slice(c0, c1 + 1)
        res = track_batch(_slice(obs, sl), gray_u8[sl], depth_w[sl], sem_w[sl],
                          _slice(gt_stack, sl), cfg, sampler, list(range(c0, c1)))
        chunks.append(state.result_to_numpy(res))
    res = F.tree_map(lambda *xs: np.concatenate(xs), *chunks)
    return _compose_batch_outputs(res, Fn)


class ChunkUploader:
    """Host arrays onto ``device`` for the streaming driver.

    On a CUDA device each call stages its arrays in pinned host memory and
    copies them with ``non_blocking=True`` on a stream of its own; the
    current (compute) stream waits on that copy's event and nothing else,
    so the host never waits for the card and a chunk's upload overlaps the
    solves queued before it.  The pinned buffers and their events live as
    long as the uploader, which the driver drops only after its drain, so
    no buffer is reused before its copy has finished.  On any other device
    the arrays are wrapped as they are (``torch.from_numpy``)."""

    def __init__(self, device: torch.device):
        self.device = device
        self.cuda = device.type == "cuda"
        self.stream = torch.cuda.Stream(device) if self.cuda else None
        self.staged = []

    def __call__(self, arrays: dict) -> dict:
        if not self.cuda:
            return {k: torch.from_numpy(a).to(self.device) for k, a in arrays.items()}
        pinned = {k: torch.from_numpy(a).pin_memory() for k, a in arrays.items()}
        compute = torch.cuda.current_stream(self.device)
        with torch.cuda.stream(self.stream):
            out = {k: t.to(self.device, non_blocking=True) for k, t in pinned.items()}
            done = torch.cuda.Event()
            done.record(self.stream)
        compute.wait_event(done)
        for t in out.values():
            t.record_stream(compute)       # allocated on the copy stream, used on compute
        self.staged.append((pinned, done))
        return out


def stream_chunks(frame_list: List, cfg: PipelineConfig, chunk: int, prepacked: List = None):
    """The streaming driver's host side: frame 0's arrays, then each chunk's
    (pair ids, arrays) in order.  The arrays are the stacked wire images
    (``gray``, ``depth``, ``flow``, ``sem``) and the GT table's fields
    (``gt.<field>``); a short last chunk is padded with the last frame, and
    its pair ids with the last pair.  Raises ``ValueError`` for a frame whose
    size is not the camera config's."""
    for fd in frame_list:
        check_frame(fd, cfg.camera)
    K = cfg.padding.k_obj_max
    Fn = len(frame_list)
    n_pairs = Fn - 1
    if n_pairs < 1:
        raise ValueError("need at least 2 frames")
    wires = prepacked or [pack_frame_wire(fd, cfg) for fd in frame_list]
    gts = [F.make_gt_table(fd.pose_gt, fd.obj_ids_gt, fd.obj_poses_gt, K) for fd in frame_list]

    def arrays(idx):
        out = {k: np.stack([wires[i][k] for i in idx]) for k in ("gray", "depth", "flow", "sem")}
        out.update({f"gt.{f}": np.stack([getattr(gts[i], f) for i in idx])
                    for f in F.GTTable._fields})
        return out

    chunks = [([min(c0 + i, n_pairs - 1) for i in range(chunk)],
               arrays([min(c0 + 1 + i, Fn - 1) for i in range(chunk)]))
              for c0 in range(0, n_pairs, chunk)]
    return arrays([0]), chunks


def chunk_inputs(t: dict):
    """Uploaded chunk arrays -> (gray, depth, flow, sem, GTTable)."""
    gt = F.GTTable(*(t[f"gt.{f}"] for f in F.GTTable._fields))
    return t["gray"], t["depth"], t["flow"], t["sem"], gt


def run_sequence_streaming(
    frame_list: List,
    cfg: PipelineConfig = DEFAULT_CONFIG,
    seed: int = 0,
    chunk: int = 8,
    prepacked: List = None,
    device="cuda",
    sampler: Optional[HypothesisSampler] = None,
):
    """Serving mode: chunks of ``chunk`` new frames in v2 wire form, each
    chunk's frontend and pair solves run together (``stream_chunk``) with
    the previous chunk's last observation carried on the device.

    As the JAX package's driver does, every chunk's upload and dispatch is
    enqueued and the results stay on the device until one drain after the
    last dispatch: between the first dispatch and the drain nothing waits
    for the card.  On a CUDA device the uploads go through pinned memory
    on a second stream (``ChunkUploader``), so chunk k+1's upload overlaps
    chunk k's solve; on the CPU the same steps run in order.
    Returns the same outputs as ``run_sequence_batched``."""
    device, sampler = _setup(device, seed, sampler)
    n_pairs = len(frame_list) - 1
    first, chunks = stream_chunks(frame_list, cfg, chunk, prepacked)
    upload = ChunkUploader(device)
    carry = frontend_batch(*chunk_inputs(upload(first)), cfg)
    results = []
    for pair_ids, arrays in chunks:
        res, carry = stream_chunk(carry, *chunk_inputs(upload(arrays)), cfg, sampler,
                                  pair_ids)
        results.append(res)
    res = state.result_to_numpy(_cat(results))       # the one drain
    res = F.tree_map(lambda x: x[:n_pairs], res)
    return _compose_batch_outputs(res, len(frame_list))


def _compose_batch_outputs(res, Fn: int):
    """Host post-pass on the numpy PairResult: compose the trajectory,
    world-frame object motions and track IDs."""
    T_rel = np.asarray(res.Tcw_cur)                     # (F-1, 4, 4)
    Tcw = [np.eye(4, dtype=np.float32)]
    for k in range(Fn - 1):
        Tcw.append((T_rel[k] @ Tcw[-1]).astype(np.float32))
    Tcw = np.stack(Tcw)

    records = []
    sem_to_track = {}
    next_id = 1
    ob = res.objects
    for k in range(Fn - 1):
        new_map = {}
        active = np.asarray(ob.active[k])
        for slot in np.flatnonzero(active):
            sem_label = int(slot) + 1
            prev_sem = int(ob.mode_last_label[k][slot])
            if prev_sem in sem_to_track and k > 0:
                tid = sem_to_track[prev_sem]
            else:
                tid = next_id
                next_id += 1
            new_map[sem_label] = tid
            # the device's H is the motion in pair k's last-camera world;
            # conjugate into the composed world frame
            H_w = np.linalg.inv(Tcw[k]) @ np.asarray(ob.H[k][slot]) @ Tcw[k]
            records.append(
                dict(
                    frame=k + 1,
                    track_id=tid,
                    sem_label=sem_label,
                    H=H_w.astype(np.float32),
                    speed_est=float(ob.speed_est[k][slot]),
                    speed_gt=float(ob.speed_gt[k][slot]),
                    t_rpe_rel=float(ob.t_rpe_rel[k][slot]),
                    r_rpe_rel=float(ob.r_rpe_rel[k][slot]),
                    has_gt=bool(ob.has_gt[k][slot]),
                )
            )
        sem_to_track = new_map
    return Tcw, res, records
