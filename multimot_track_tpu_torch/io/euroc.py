"""EuRoC MAV sequence loader (mav0/cam0 layout) for the monocular driver.

A numpy host copy of ``multimot_track_tpu.io.euroc`` (the reference ships
``Examples/Monocular/mono_euroc.cc`` with a static ``EuRoC.yaml``; this
loader reads the dataset's own ASL metadata, so any EuRoC download works):

* ``mav0/cam0/data.csv``: ``timestamp_ns, filename`` rows (header with #);
* ``mav0/cam0/data/*.png``: 752x480 8-bit grayscale frames;
* ``mav0/cam0/sensor.yaml``: intrinsics (fu fv cu cv), radial-tangential
  distortion (k1 k2 p1 p2) and the body<-camera extrinsic ``T_BS``;
* ``mav0/state_groundtruth_estimate0/data.csv``: body poses T_WB (p_RS_R +
  q_RS), associated to each frame by nearest timestamp within
  ``max_gt_dt`` and combined with T_BS into camera-to-world poses.

Images are decoded by ``io/png.read_png`` (no PIL).  Lens distortion is
handled keypoint-side (``geometry/camera.undistort_points``), as the
reference does (src/Frame.cc:787-811).
tests/test_torch_entry_mono.py holds it to the original: identical frames
and camera configs on the same tree.
"""

from __future__ import annotations

import csv
import pathlib
import re
from typing import List, Optional

import numpy as np

from multimot_track_tpu_torch.config import CameraConfig
from multimot_track_tpu_torch.io.frame import FrameData
from multimot_track_tpu_torch.io.kitti import _rgb_to_gray
from multimot_track_tpu_torch.io.png import read_header, read_png


def _quat_to_R(qw, qx, qy, qz) -> np.ndarray:
    n = max((qw * qw + qx * qx + qy * qy + qz * qz) ** 0.5, 1e-12)
    qw, qx, qy, qz = qw / n, qx / n, qy / n, qz / n
    return np.asarray(
        [
            [1 - 2 * (qy * qy + qz * qz), 2 * (qx * qy - qz * qw), 2 * (qx * qz + qy * qw)],
            [2 * (qx * qy + qz * qw), 1 - 2 * (qx * qx + qz * qz), 2 * (qy * qz - qx * qw)],
            [2 * (qx * qz - qy * qw), 2 * (qy * qz + qx * qw), 1 - 2 * (qx * qx + qy * qy)],
        ],
        np.float32,
    )


def _parse_sensor_yaml(path: pathlib.Path) -> dict:
    """Minimal ASL sensor.yaml parse (flow-style lists; no YAML library for
    the OpenCV-flavoured '!!opencv-matrix' tags some copies carry)."""
    text = path.read_text()
    out = {}
    m = re.search(r"intrinsics:\s*\[([^\]]+)\]", text)
    if m:
        out["intrinsics"] = [float(x) for x in m.group(1).split(",")]
    m = re.search(r"distortion_coefficients:\s*\[([^\]]+)\]", text)
    if m:
        out["distortion"] = [float(x) for x in m.group(1).split(",")]
    m = re.search(r"T_BS:.*?data:\s*\[([^\]]+)\]", text, re.S)
    if m:
        vals = [float(x) for x in m.group(1).replace("\n", " ").split(",")]
        out["T_BS"] = np.asarray(vals, np.float32).reshape(4, 4)
    m = re.search(r"rate_hz:\s*([\d.]+)", text)
    if m:
        out["rate_hz"] = float(m.group(1))
    return out


def _read_rows(path: pathlib.Path):
    with open(path) as f:
        for row in csv.reader(f):
            if row and not row[0].lstrip().startswith("#"):
                yield row


class EurocSequence:
    """Monocular frame source over an EuRoC ASL directory.

    ``root`` may be the dataset root (containing ``mav0/``) or ``mav0``
    itself.  Yields FrameData with gray + pose_gt (camera-to-world) only;
    depth, flow and masks are zero (the mono driver reads none of them).
    ``timestamp`` is seconds from the first frame (the int64 nanosecond
    stamps are kept exactly; float64 epoch seconds would resolve only
    ~2.4e-7 s)."""

    def __init__(self, root, max_gt_dt: float = 0.02):
        root = pathlib.Path(root)
        if (root / "mav0").is_dir():
            root = root / "mav0"
        self.root = root
        cam_dir = root / "cam0"
        if not cam_dir.is_dir():
            raise FileNotFoundError(f"no cam0/ under {root}")

        self._stamps_ns: List[int] = []
        self._files: List[pathlib.Path] = []
        for row in _read_rows(cam_dir / "data.csv"):
            self._stamps_ns.append(int(row[0]))
            self._files.append(cam_dir / "data" / row[1].strip())
        t0_ns = self._stamps_ns[0] if self._stamps_ns else 0
        self._stamps: List[float] = [(ns - t0_ns) * 1e-9 for ns in self._stamps_ns]

        sensor = {}
        if (cam_dir / "sensor.yaml").exists():
            sensor = _parse_sensor_yaml(cam_dir / "sensor.yaml")
        self._sensor = sensor
        self.T_BS = sensor.get("T_BS", np.eye(4, dtype=np.float32))

        # ground truth: body poses T_WB, nearest-stamp associated
        self._gt: List[Optional[np.ndarray]] = [None] * len(self._files)
        gt_csv = root / "state_groundtruth_estimate0" / "data.csv"
        if gt_csv.exists():
            ts, poses = [], []
            for row in _read_rows(gt_csv):
                v = [float(x) for x in row]
                T = np.eye(4, dtype=np.float32)
                T[:3, 3] = v[1:4]
                T[:3, :3] = _quat_to_R(v[4], v[5], v[6], v[7])
                ts.append(int(row[0]))
                poses.append(T)
            ts = np.asarray(ts, np.int64)
            for i, s in enumerate(self._stamps_ns):
                j = int(np.argmin(np.abs(ts - s)))
                if abs(ts[j] - s) * 1e-9 <= max_gt_dt:
                    # camera-to-world = T_WB @ T_BS (T_BS maps cam -> body)
                    self._gt[i] = poses[j] @ self.T_BS

    def __len__(self) -> int:
        return len(self._files)

    def camera_config(self) -> CameraConfig:
        """Intrinsics and radial-tangential distortion from sensor.yaml (the
        reference's static EuRoC.yaml:8-16 values when it has none), the
        image size from the first PNG's header."""
        intr = self._sensor.get("intrinsics")
        dist = self._sensor.get("distortion", [0.0, 0.0, 0.0, 0.0])
        if intr is None:
            intr = [458.654, 457.296, 367.215, 248.375]
            dist = [-0.28340811, 0.07395907, 0.00019359, 1.76187114e-05]
        w, h = read_header(self._files[0])[:2]
        return CameraConfig(
            fx=intr[0], fy=intr[1], cx=intr[2], cy=intr[3],
            bf=intr[0] * 0.11,  # cam0-cam1 baseline ~0.11 m (unused in mono)
            width=w, height=h,
            fps=self._sensor.get("rate_hz", 20.0),
            k1=dist[0], k2=dist[1], p1=dist[2], p2=dist[3],
        )

    def load_frame(self, i: int) -> FrameData:
        gray = _rgb_to_gray(read_png(self._files[i]))
        h, w = gray.shape
        return FrameData(
            index=i,
            timestamp=self._stamps[i],
            gray=gray,
            depth_raw=np.zeros((h, w), np.float32),
            flow=np.zeros((h, w, 2), np.float32),
            sem_mask=np.zeros((h, w), np.int32),
            pose_gt=self._gt[i],
            obj_ids_gt=np.zeros(0, np.int32),
            obj_poses_gt=np.zeros((0, 4, 4), np.float32),
            obj_bboxes_gt=np.zeros((0, 4), np.float32),
        )
