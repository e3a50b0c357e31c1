"""Online-stream ingestion: a socket serving endpoint for the live system.

The reference's only online entry points are ROS nodes
(Examples/ROS/ORB_SLAM2/src/ros_rgbd.cc: subscribe to image topics ->
TrackRGBD -> publish).  The TPU-native counterpart is transport-agnostic:
a length-prefixed binary frame protocol over any stream socket, feeding
``MultiMotSystem`` frame by frame and answering each frame with a JSON
result record (pose, state, objects) — subscribe -> track -> publish
without a ROS dependency.

Wire protocol (little-endian):
  request  = MAGIC(4s=b"MMT1") | header_len(u32) | header(JSON utf-8)
             | payload bytes...
  header   = {"frame": int, "timestamp": float, "h": int, "w": int,
              "arrays": [{"name": gray|depth|flow|sem, "dtype": ...,
                          "shape": [...]}, ...]}
  payloads follow in header order, C-contiguous raw bytes.
  response = MAGIC | body_len(u32) | body(JSON utf-8)

gray is required; depth is required (RGB-D); flow and sem are optional —
absent flow falls back to the previous frame's estimate-on-device path
(frontend/optical_flow), absent sem to background-only masks (pair with
discover_objects for mask-free multi-motion, pipeline/motion_seg).

Port of ``multimot_track_tpu.io.stream``: the same wire protocol; the
server tracks with the port's ``MultiMotSystem`` and estimates missing flow
with the port's ``dense_flow``, on ``device`` (the card by default) when
no ``system`` is passed, else on the system's device.
"""

from __future__ import annotations

import json
import socket
import struct
from typing import Optional

import numpy as np

from multimot_track_tpu_torch.io.frame import FrameData, check_frame_size

MAGIC = b"MMT1"


def _recv_exact(sock: socket.socket, n: int) -> bytes:
    buf = bytearray()
    while len(buf) < n:
        chunk = sock.recv(n - len(buf))
        if not chunk:
            raise ConnectionError("stream closed mid-message")
        buf.extend(chunk)
    return bytes(buf)


def send_frame(sock: socket.socket, gray: np.ndarray, depth_raw: np.ndarray,
               flow: Optional[np.ndarray] = None,
               sem: Optional[np.ndarray] = None,
               frame: int = 0, timestamp: float = 0.0):
    """Client side: publish one frame."""
    arrays = [("gray", np.asarray(gray, np.uint8)),
              ("depth", np.asarray(depth_raw, np.uint16))]
    if flow is not None:
        arrays.append(("flow", np.asarray(flow, np.float16)))
    if sem is not None:
        arrays.append(("sem", np.asarray(sem, np.uint8)))
    header = {
        "frame": int(frame), "timestamp": float(timestamp),
        "h": int(gray.shape[0]), "w": int(gray.shape[1]),
        "arrays": [
            {"name": n, "dtype": str(a.dtype), "shape": list(a.shape)}
            for n, a in arrays
        ],
    }
    hb = json.dumps(header).encode()
    sock.sendall(MAGIC + struct.pack("<I", len(hb)) + hb)
    for _, a in arrays:
        sock.sendall(np.ascontiguousarray(a).tobytes())


def recv_result(sock: socket.socket) -> dict:
    """Client side: read the tracker's answer for the last frame."""
    if _recv_exact(sock, 4) != MAGIC:
        raise ConnectionError("bad magic in response")
    (n,) = struct.unpack("<I", _recv_exact(sock, 4))
    return json.loads(_recv_exact(sock, n).decode())


def _recv_frame(sock: socket.socket):
    if _recv_exact(sock, 4) != MAGIC:
        raise ConnectionError("bad magic in request")
    (n,) = struct.unpack("<I", _recv_exact(sock, 4))
    header = json.loads(_recv_exact(sock, n).decode())
    out = {}
    for spec in header["arrays"]:
        a = np.frombuffer(
            _recv_exact(
                sock,
                int(np.dtype(spec["dtype"]).itemsize * np.prod(spec["shape"]))
            ),
            dtype=spec["dtype"],
        ).reshape(spec["shape"])
        out[spec["name"]] = a
    return header, out


def serve_connection(sock: socket.socket, cfg=None, system=None,
                     discover_objects: bool = False, max_frames: int = 0,
                     device="cuda"):
    """Server side: track frames from ``sock`` until EOF; per frame,
    publish {"frame", "state", "Tcw", "n_inliers", "objects": [...]}.

    Returns the ``MultiMotSystem`` (trajectory savers, summary, checkpoint
    all available afterwards — the ROS node offers none of that).  Raises
    ``ValueError`` for a frame whose size is not the camera config's."""
    from multimot_track_tpu_torch.config import DEFAULT_CONFIG
    from multimot_track_tpu_torch.io.kitti import lk_flow
    from multimot_track_tpu_torch.pipeline.system import MultiMotSystem

    sys_ = system or MultiMotSystem(
        cfg or DEFAULT_CONFIG, discover_objects=discover_objects, device=device
    )

    def _mk_fd(header, arrays, flow):
        gray = arrays["gray"].astype(np.float32)
        H, W = gray.shape
        sem = arrays.get("sem")
        return FrameData(
            index=int(header["frame"]),
            timestamp=float(header["timestamp"]),
            gray=gray,
            depth_raw=arrays["depth"].astype(np.float32),
            flow=np.asarray(flow, np.float32),
            sem_mask=(np.zeros((H, W), np.int32) if sem is None
                      else sem.astype(np.int32)),
            pose_gt=np.eye(4, dtype=np.float32),
            obj_ids_gt=np.zeros(0, np.int32),
            obj_poses_gt=np.zeros((0, 4, 4), np.float32),
            obj_bboxes_gt=np.zeros((0, 4), np.float32),
        )

    def _track_and_reply(fd):
        r = sys_.track_rgbd(fd)
        body = {"frame": int(fd.index), "state": sys_.state}
        if r is None:
            body["Tcw"] = np.eye(4).reshape(-1).tolist()
            body["n_inliers"] = 0
            body["objects"] = []
        else:
            body["Tcw"] = np.asarray(r.Tcw_cur, np.float64).reshape(-1).tolist()
            body["n_inliers"] = int(r.n_static_inliers)
            ob = r.objects
            body["objects"] = [
                {
                    "slot": int(s),
                    "H": np.asarray(ob.H[s], np.float64).reshape(-1).tolist(),
                    "speed": float(ob.speed_est[s]),
                }
                for s in np.flatnonzero(np.asarray(ob.active))
            ]
        bb = json.dumps(body).encode()
        sock.sendall(MAGIC + struct.pack("<I", len(bb)) + bb)

    # pending = the buffered frame awaiting its forward flow (flow k->k+1
    # can only be estimated once frame k+1 arrives, so the no-flow mode
    # runs ONE frame of latency — the same latency a flow-publishing
    # upstream node would impose anyway)
    pending = None
    n_seen = 0
    while not (max_frames and n_seen >= max_frames):
        try:
            header, arrays = _recv_frame(sock)
        except ConnectionError:
            break
        n_seen += 1
        check_frame_size(sys_.cfg.camera, header["frame"], gray=arrays["gray"],
                         depth=arrays["depth"], flow=arrays.get("flow"),
                         mask=arrays.get("sem"))
        if "flow" in arrays:
            _track_and_reply(_mk_fd(header, arrays, arrays["flow"]))
            continue
        if pending is not None:
            ph, pa = pending
            est = lk_flow(pa["gray"].astype(np.float32), arrays["gray"].astype(np.float32),
                          sys_.device)
            _track_and_reply(_mk_fd(ph, pa, est))
        pending = (header, arrays)
    if pending is not None:
        H, W = pending[1]["gray"].shape
        _track_and_reply(
            _mk_fd(pending[0], pending[1], np.zeros((H, W, 2), np.float32))
        )
    return sys_
