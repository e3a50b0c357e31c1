"""TUM RGB-D sequence loader (rgb.txt / depth.txt / groundtruth.txt).

The reference names its driver ``rgbd_tum`` but actually consumes a custom
KITTI-ish layout and hard-requires precomputed .flo flow and per-pixel
instance masks (Examples/RGB-D/rgbd_tum.cc:129,316) — it cannot run on an
actual TUM RGB-D download.  This loader can, because the framework is
self-contained: flow is estimated on device (frontend/optical_flow) and
objects are discovered mask-free (pipeline/motion_seg) when requested.

Format (vision.in.tum.de/data/datasets/rgbd-dataset/file_formats):

* ``rgb.txt`` / ``depth.txt``: ``timestamp  relative/path.png`` rows
  (comments start with #); rgb and depth run on separate clocks and are
  associated by nearest timestamp within ``max_dt``.
* depth png: uint16, metric depth * depth_map_factor (5000 for TUM).
* ``groundtruth.txt``: ``timestamp tx ty tz qx qy qz qw`` (camera-to-world),
  associated by nearest timestamp.

Bridging to the pipeline: the device frontend converts depth pngs with the
KITTI disparity formula depth = bf / (png / 256)
(geometry/camera.disparity_png_to_depth, Tracking.cc:447-456), so this
loader emits the *equivalent disparity png* ``256 * bf / z`` — an exact
inverse, no pipeline changes, invalid (z == 0) pixels map to png 0 which
the formula sends to +inf depth and the samplers gate out.

Port of ``multimot_track_tpu.io.tum``: PNG decode by ``io/png.read_png``,
the image size from the PNG header, flow estimated on the sequence's
``device`` (the card by default).
"""

from __future__ import annotations

import pathlib
from typing import List, Tuple

import numpy as np

from multimot_track_tpu_torch.config import CameraConfig
from multimot_track_tpu_torch.io.frame import FrameData
from multimot_track_tpu_torch.io.kitti import _rgb_to_gray, lk_flow, reader_device
from multimot_track_tpu_torch.io.png import read_header, read_png

# default intrinsics of the TUM "freiburg" Kinects (fr1/fr2/fr3)
TUM_INTRINSICS = {
    "fr1": dict(fx=517.3, fy=516.5, cx=318.6, cy=255.3),
    "fr2": dict(fx=520.9, fy=521.0, cx=325.1, cy=249.7),
    "fr3": dict(fx=535.4, fy=539.2, cx=320.1, cy=247.6),
    "default": dict(fx=525.0, fy=525.0, cx=319.5, cy=239.5),
}


def _read_list(path: pathlib.Path) -> List[Tuple[float, str]]:
    out = []
    for line in path.read_text().splitlines():
        line = line.strip()
        if not line or line.startswith("#"):
            continue
        parts = line.split()
        out.append((float(parts[0]), parts[1]))
    return out


def _read_groundtruth(path: pathlib.Path):
    ts, poses = [], []
    for line in path.read_text().splitlines():
        line = line.strip()
        if not line or line.startswith("#"):
            continue
        v = [float(x) for x in line.split()]
        if len(v) < 8:
            continue
        tx, ty, tz, qx, qy, qz, qw = v[1:8]
        n = max((qx * qx + qy * qy + qz * qz + qw * qw) ** 0.5, 1e-12)
        qx, qy, qz, qw = qx / n, qy / n, qz / n, qw / n
        R = np.asarray(
            [
                [1 - 2 * (qy * qy + qz * qz), 2 * (qx * qy - qz * qw), 2 * (qx * qz + qy * qw)],
                [2 * (qx * qy + qz * qw), 1 - 2 * (qx * qx + qz * qz), 2 * (qy * qz - qx * qw)],
                [2 * (qx * qz - qy * qw), 2 * (qy * qz + qx * qw), 1 - 2 * (qx * qx + qy * qy)],
            ],
            np.float32,
        )
        T = np.eye(4, dtype=np.float32)
        T[:3, :3] = R
        T[:3, 3] = (tx, ty, tz)
        ts.append(v[0])
        poses.append(T)
    return np.asarray(ts), poses


def _nearest(ts_sorted: np.ndarray, t: float) -> int:
    i = int(np.searchsorted(ts_sorted, t))
    cands = [j for j in (i - 1, i) if 0 <= j < len(ts_sorted)]
    return min(cands, key=lambda j: abs(ts_sorted[j] - t))


class TumRGBDSequence:
    """Drop-in sequence (same protocol as KittiSequence) over a TUM RGB-D
    directory.  No flow files and no masks exist in this format — pair
    with ``MultiMotSystem(discover_objects=True)`` for dynamic objects, or
    run ego-only.  ``device``: where flow is estimated."""

    def __init__(self, root, max_dt: float = 0.02, bf: float = 40.0,
                 depth_map_factor: float = 5000.0, estimate_flow: bool = True,
                 device="cuda"):
        self.root = pathlib.Path(root)
        self.device = reader_device(device)
        self.bf = float(bf)
        self.depth_map_factor = float(depth_map_factor)
        self.estimate_flow = estimate_flow
        self.n_flow_estimated = 0

        rgb = _read_list(self.root / "rgb.txt")
        dep = _read_list(self.root / "depth.txt")
        dts = np.asarray([t for t, _ in dep])
        self.pairs = []           # (t_rgb, rgb_path, depth_path)
        for t, rp in rgb:
            j = _nearest(dts, t)
            if abs(dts[j] - t) <= max_dt:
                self.pairs.append((t, rp, dep[j][1]))

        gt_file = self.root / "groundtruth.txt"
        self.gt_ts, self.gt_poses = (
            _read_groundtruth(gt_file) if gt_file.exists() else (np.zeros(0), [])
        )
        self.timestamps = [t for t, _, _ in self.pairs]

    def __len__(self) -> int:
        return len(self.pairs)

    def camera_config(self, variant: str = None) -> CameraConfig:
        """Intrinsics for the sequence (fr1/fr2/fr3 guessed from the
        directory name unless given), with this loader's virtual bf."""
        if variant is None:
            name = self.root.name.lower()
            variant = next(
                (k for k in ("fr1", "fr2", "fr3") if f"freiburg{k[-1]}" in name or k in name),
                "default",
            )
        intr = TUM_INTRINSICS[variant]
        W, H = read_header(self.root / self.pairs[0][1])[:2] if self.pairs else (640, 480)
        return CameraConfig(
            fx=intr["fx"], fy=intr["fy"], cx=intr["cx"], cy=intr["cy"],
            bf=self.bf, width=W, height=H, fps=30.0,
            depth_map_factor=self.depth_map_factor,
        )

    def _gray(self, i: int) -> np.ndarray:
        return _rgb_to_gray(read_png(self.root / self.pairs[i][1]))

    def load_frame(self, i: int) -> FrameData:
        t, _, dpath = self.pairs[i]
        gray = self._gray(i)
        dpng = read_png(self.root / dpath).astype(np.float32)
        z = dpng / self.depth_map_factor                     # metric depth, 0 invalid
        disp_png = np.where(z > 0, 256.0 * self.bf / np.maximum(z, 1e-6), 0.0)

        if self.estimate_flow and i + 1 < len(self.pairs):
            self.n_flow_estimated += 1
            flow = lk_flow(gray, self._gray(i + 1), self.device)
        else:
            flow = np.zeros(gray.shape + (2,), np.float32)

        if len(self.gt_ts):
            j = _nearest(self.gt_ts, t)
            pose = self.gt_poses[j]
        else:
            pose = np.eye(4, dtype=np.float32)

        return FrameData(
            index=i,
            timestamp=t,
            gray=gray,
            depth_raw=disp_png.astype(np.float32),
            flow=flow,
            sem_mask=np.zeros(gray.shape, np.int32),
            pose_gt=pose,
            obj_ids_gt=np.zeros(0, np.int32),
            obj_poses_gt=np.zeros((0, 4, 4), np.float32),
            obj_bboxes_gt=np.zeros((0, 4), np.float32),
        )
