"""Stereo sequence adapter: KITTI image_2/image_3 layout -> FrameData.

The reference needs a separate driver for stereo
(Examples/Stereo/stereo_kitti.cc: dual ORB extraction +
ComputeStereoMatches); here the dense block-matching disparity
(frontend/stereo) converts stereo input into the RGB-D pipeline's depth
encoding on device, so the entire multi-motion pipeline — and the CLI —
runs unchanged on stereo sequences.

Port of ``multimot_track_tpu.io.stereo_seq``: PNG decode by
``io/png.read_png``; disparity, flow and the quad gate on the sequence's
``device`` (the card by default).
"""

from __future__ import annotations

import pathlib

import numpy as np
import torch

from multimot_track_tpu_torch.frontend import stereo
from multimot_track_tpu_torch.io import kitti
from multimot_track_tpu_torch.io.png import read_png


class StereoKittiSequence(kitti.KittiSequence):
    """Sequence with image_2/ (left) + image_3/ (right) instead of depth/.

    Other inputs (flow/, semantic/, pose_gt.txt, object_pose.txt,
    times.txt) follow the standard layout; depth_raw is synthesised from
    block-matching disparity in the loader.
    """

    def __init__(self, root, max_label: int = 4, max_disp: int = 128,
                 quad_gate: bool = False, quad_kp: int = 512, device="cuda"):
        self.max_disp = max_disp
        # quad-consistent stereo-temporal gate (ORBmatcher::SearchByQuad,
        # src/ORBmatcher.cc:1704-1842 + the vDescIndex L/R association,
        # src/Frame.cc:854-1035): matches verified in all FOUR views
        # (last-L/R, cur-L/R) overwrite the estimated flow at their
        # keypoints, so the ego solve consumes descriptor-verified
        # correspondences where they exist.  Dormant in the reference;
        # live here behind --quad-stereo.
        self.quad_gate = quad_gate
        self.quad_kp = quad_kp
        self.n_quad_matched = 0
        self._stereo_cache: dict = {}
        root = pathlib.Path(root)
        # reuse the base init but count frames from image_2
        super().__init__(root, max_label=max_label, device=device)
        n_img = len(list((root / "image_2").glob("*.png")))
        self.n_frames = min(len(self.timestamps), n_img) if self.timestamps else n_img

    def _stereo_views(self, i: int):
        """(left, right, disparity) of frame i, cached one step deep (the
        quad gate touches i and i+1 per load); the disparity stays on the
        device."""
        hit = self._stereo_cache.get(i)
        if hit is not None:
            return hit
        p = self.frame_paths(i)
        left = kitti._rgb_to_gray(read_png(p["image"]))
        right = kitti._rgb_to_gray(read_png(p["right"]))
        disp = stereo.dense_disparity(
            self._dev(left), self._dev(right), max_disp=self.max_disp
        )
        self._stereo_cache = {i: (left, right, disp)}   # keep newest only
        return left, right, disp

    def _apply_quad_gate(self, i, left, right, disp, flow):
        """Splat quad-verified correspondences over the estimated flow
        (3x3 neighbourhoods, so the frontend's FAST samples land on
        them)."""
        if i + 1 >= self.n_frames:
            return flow
        left1, right1, disp1 = self._stereo_views(i + 1)
        uv0, uv1, ok = stereo.quad_temporal_matches(
            self._dev(left), self._dev(right),
            self._dev(left1), self._dev(right1),
            disp, disp1, self._dev(flow), n_kp=self.quad_kp,
        )
        ok = ok.cpu().numpy()
        if not ok.any():
            return flow
        uv0 = uv0.cpu().numpy()[ok]
        delta = (uv1.cpu().numpy()[ok] - uv0).astype(np.float32)
        self.n_quad_matched += int(ok.sum())
        H, W = flow.shape[:2]
        ui = np.round(uv0[:, 0]).astype(int)
        vi = np.round(uv0[:, 1]).astype(int)
        flow = flow.copy()
        for dy in (-1, 0, 1):
            for dx in (-1, 0, 1):
                uu = np.clip(ui + dx, 0, W - 1)
                vv = np.clip(vi + dy, 0, H - 1)
                flow[vv, uu] = delta
        return flow

    def _dev(self, a: np.ndarray) -> torch.Tensor:
        return torch.from_numpy(np.ascontiguousarray(a, np.float32)).to(self.device)

    def frame_paths(self, i: int):
        p = super().frame_paths(i)
        stem = f"{i:06d}"
        p["image"] = self.root / "image_2" / f"{stem}.png"
        p["right"] = self.root / "image_3" / f"{stem}.png"
        return p

    def load_frame(self, i: int) -> kitti.FrameData:
        p = self.frame_paths(i)
        left, right, disp = self._stereo_views(i)
        depth_raw = stereo.disparity_to_depth_raw(disp).cpu().numpy()
        H, W = left.shape
        flow = self._flow_or_estimate(i, left)
        if self.quad_gate:
            flow = self._apply_quad_gate(i, left, right, disp, flow)
        sem = (
            kitti.load_mask_txt(p["semantic"], H, W, self.max_label)
            if p["semantic"].exists()
            else np.zeros((H, W), np.int32)
        )
        rows = self.obj_rows.get(i, [])
        obj_ids = np.asarray([int(r[1]) for r in rows], np.int32)
        obj_poses = (
            np.stack([kitti.obj_pose_row_to_T(r) for r in rows])
            if rows
            else np.zeros((0, 4, 4), np.float32)
        )
        obj_boxes = (
            np.stack([r[2:6] for r in rows]).astype(np.float32)
            if rows
            else np.zeros((0, 4), np.float32)
        )
        return kitti.FrameData(
            index=i,
            timestamp=self.timestamps[i] if i < len(self.timestamps) else float(i),
            gray=left,
            depth_raw=depth_raw,
            flow=flow,
            sem_mask=sem,
            pose_gt=self.poses_gt.get(i, np.eye(4, dtype=np.float32)),
            obj_ids_gt=obj_ids,
            obj_poses_gt=obj_poses,
            obj_bboxes_gt=obj_boxes,
        )
