"""The socket server (``io/stream``) of the port against in-process
tracking (CPU).

``serve_connection`` runs in a thread over a ``socketpair`` on
``make_multimover_frames(4)`` at ``test_torch_tracker.small_config`` (window
BA off), once with flow arrays on the wire and once without (the server
estimates the flow k -> k+1 when frame k+1 arrives, one frame of latency).
Every reply must equal an in-process ``track_rgbd`` of the frames as the
server rebuilds them from the wire: ``Tcw`` and the object motions to 1e-6
(the same code on the same CPU), inlier counts and active slots exactly.
"""

import dataclasses
import socket
import threading

import numpy as np
import pytest
import torch

from multimot_track_tpu_torch import config as tconfig
from multimot_track_tpu_torch.io import stream
from multimot_track_tpu_torch.io.frame import FrameData
from multimot_track_tpu_torch.io.kitti import lk_flow
from multimot_track_tpu_torch.io.synth import make_multimover_frames, synth_camera_config
from multimot_track_tpu_torch.pipeline.system import MultiMotSystem
from test_torch_tracker import small_config

torch.set_num_threads(1)


@pytest.fixture(scope="module")
def frames():
    return make_multimover_frames(n_frames=4)


def serve_config():
    c = small_config(tconfig, synth_camera_config())
    return dataclasses.replace(c, backend=dataclasses.replace(
        c.backend, window_refine=False, joint_window_refine=False))


def wire_frame(fd, with_flow: bool):
    """The frame as the server rebuilds it from the wire."""
    gray = np.clip(fd.gray, 0, 255).astype(np.uint8)
    depth = np.clip(fd.depth_raw, 0, 65535).astype(np.uint16)
    flow = fd.flow.astype(np.float16) if with_flow else None
    return gray, depth, flow, fd.sem_mask.astype(np.uint8)


def serve(frames, with_flow: bool):
    a, b = socket.socketpair()
    box = {}

    def server():
        box["sys"] = stream.serve_connection(b, cfg=serve_config(), device="cpu")
        b.close()

    th = threading.Thread(target=server)
    th.start()
    replies = []
    for fd in frames:
        gray, depth, flow, sem = wire_frame(fd, with_flow)
        stream.send_frame(a, gray, depth, flow=flow, sem=sem, frame=fd.index,
                          timestamp=fd.timestamp)
        if with_flow:
            replies.append(stream.recv_result(a))
    a.shutdown(socket.SHUT_WR)
    if not with_flow:           # one frame of latency: replies follow the stream
        replies = [stream.recv_result(a) for _ in frames]
    th.join(timeout=600)
    assert not th.is_alive()
    a.close()
    return replies, box["sys"]


@pytest.mark.parametrize("with_flow", [True, False])
def test_server_replies_equal_in_process_tracking(frames, with_flow):
    replies, served = serve(frames, with_flow)
    s = MultiMotSystem(serve_config(), device="cpu")
    wire = [wire_frame(fd, with_flow) for fd in frames]
    for i, (fd, (gray, depth, flow, sem)) in enumerate(zip(frames, wire)):
        if flow is None:
            flow = (lk_flow(gray.astype(np.float32), wire[i + 1][0].astype(np.float32), "cpu")
                    if i + 1 < len(frames) else np.zeros(gray.shape + (2,), np.float32))
        r = s.track_rgbd(FrameData(
            index=fd.index, timestamp=fd.timestamp, gray=gray.astype(np.float32),
            depth_raw=depth.astype(np.float32), flow=flow.astype(np.float32),
            sem_mask=sem.astype(np.int32), pose_gt=np.eye(4, dtype=np.float32),
            obj_ids_gt=np.zeros(0, np.int32), obj_poses_gt=np.zeros((0, 4, 4), np.float32),
            obj_bboxes_gt=np.zeros((0, 4), np.float32)))
        rep = replies[i]
        assert rep["frame"] == fd.index and rep["state"] == s.state
        if r is None:
            assert rep["Tcw"] == np.eye(4).reshape(-1).tolist() and rep["objects"] == []
            continue
        np.testing.assert_allclose(np.reshape(rep["Tcw"], (4, 4)), r.Tcw_cur, atol=1e-6)
        assert rep["n_inliers"] == int(r.n_static_inliers) > 20
        active = np.flatnonzero(np.asarray(r.objects.active))
        assert [o["slot"] for o in rep["objects"]] == active.tolist() and len(active) > 0
        for o in rep["objects"]:
            np.testing.assert_allclose(np.reshape(o["H"], (4, 4)), r.objects.H[o["slot"]],
                                       atol=1e-6)
            assert abs(o["speed"] - float(r.objects.speed_est[o["slot"]])) <= 1e-4
    assert served.summary()["n_frames"] == len(frames)
    T3 = np.reshape(replies[3]["Tcw"], (4, 4))
    np.testing.assert_allclose(np.linalg.inv(T3), frames[3].pose_gt, atol=0.05)


def test_protocol_roundtrip():
    """Codec level, as tests/test_stream.py checks the JAX package's: the
    port's sender against the JAX package's receiver and back."""
    from multimot_track_tpu.io import stream as jstream

    gray = np.arange(12, dtype=np.uint8).reshape(3, 4)
    depth = np.arange(12, dtype=np.uint16).reshape(3, 4) * 100
    flow = np.random.default_rng(0).normal(size=(3, 4, 2)).astype(np.float16)
    for send, recv in ((stream.send_frame, jstream._recv_frame),
                       (jstream.send_frame, stream._recv_frame)):
        a, b = socket.socketpair()
        send(a, gray, depth, flow=flow, frame=7, timestamp=1.25)
        header, arrays = recv(b)
        assert header["frame"] == 7 and header["timestamp"] == 1.25
        np.testing.assert_array_equal(arrays["gray"], gray)
        np.testing.assert_array_equal(arrays["depth"], depth)
        np.testing.assert_array_equal(arrays["flow"], flow)
        assert "sem" not in arrays
        a.close()
        b.close()
    assert stream.MAGIC == jstream.MAGIC
