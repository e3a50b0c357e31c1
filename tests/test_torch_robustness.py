"""Degenerate frames through the live system: the PyTorch port against the
JAX package's own gates (``tests/test_robustness.py``), CPU.

The five cases of ``test_robustness.py`` (zero depth, a fully masked frame,
NaN flow, saturated depth, single-pixel objects) on the same 64x96 frames,
drawn from the same seeds, at that file's ``CFG`` with the camera sized to
the frames (the port refuses a frame whose size is not the camera's; the
JAX package gathers a resized flow at clamped indices there).  Both
packages run every case; each must keep every pose finite, and no object
below the 100-point gate may become active.  The port draws the JAX
package's hypotheses (``JaxKeySampler`` over the live step keys), so where
both return a result for a frame, its ``Tcw_cur`` agrees within 1e-4
(float32 solves in another summation order).

Then the refusal itself: a 64x96 frame under the 1242x375 camera raises
``ValueError`` naming both sizes from every frame entry point of the port,
before anything of the frame is made into a tensor.
"""

import dataclasses
import socket

import numpy as np
import pytest
import torch

from multimot_track_tpu.io.kitti import FrameData as JFrameData
from multimot_track_tpu.pipeline.system import MultiMotSystem as JSystem
from multimot_track_tpu_torch import config as tconfig
from multimot_track_tpu_torch.io import stream
from multimot_track_tpu_torch.pipeline import batch as tbatch
from multimot_track_tpu_torch.pipeline.mono import MonoTracker
from multimot_track_tpu_torch.pipeline.system import MultiMotSystem as TSystem
from test_robustness import CFG as JROB_CFG
from test_torch_ransac import FoldInKeys, JaxKeySampler
from torch_behaviour import br

torch.set_num_threads(1)

T_TOL = 1e-4
H, W = 64, 96


def _at_frame_size(cfg):
    return dataclasses.replace(cfg, camera=dataclasses.replace(cfg.camera, width=W, height=H))


def port_rob_config():
    """``test_robustness.CFG`` built on the port's config classes."""
    D = tconfig.DEFAULT_CONFIG
    return dataclasses.replace(
        D,
        padding=dataclasses.replace(D.padding, n_static_max=256, n_obj_pts_max=512, k_obj_max=2),
        solver=dataclasses.replace(D.solver, ransac_iters=50, obj_ransac_iters=50,
                                   cam_lm_iters=15, obj_lm_iters=15),
    )


JCFG = _at_frame_size(JROB_CFG)
TCFG = _at_frame_size(port_rob_config())


def case_frames(name, n=3):
    """The case's frames (``tools/behaviour_ref.degenerate_frames``, the
    builder ``chip_smoke.py`` phase 16(a) uses at 1242x375)."""
    return br.degenerate_frames(name, H, W, n)


def to_jax(fd):
    return JFrameData(**dataclasses.asdict(fd))


# each case's test in test_robustness.py
JAX_TESTS = {"zero_depth": "test_zero_depth_everywhere", "fully_masked": "test_fully_masked_frame",
             "nan_flow": "test_nan_flow_does_not_poison", "saturated_depth": "test_saturated_depth",
             "single_pixel_objects": "test_single_pixel_objects"}


def test_the_cases_are_test_robustness_frames():
    """``case_frames`` builds what ``test_robustness.py``'s tests build."""
    import test_robustness as jrob

    seen = []

    def recording(frames):
        seen.append(frames)
        raise StopIteration

    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jrob, "run_frames", recording)
        for name, test in JAX_TESTS.items():
            with pytest.raises(StopIteration):
                getattr(jrob, test)()
            for a, b in zip(seen.pop(), case_frames(name), strict=True):
                assert (a.index, a.timestamp) == (b.index, b.timestamp)
                for f in ("gray", "depth_raw", "flow", "sem_mask"):
                    np.testing.assert_array_equal(getattr(a, f), getattr(b, f), err_msg=name)


def _run(system, frames):
    results = [system.track_rgbd(fd) for fd in frames]
    for r in results[1:]:
        assert r is not None
        assert np.all(np.isfinite(np.asarray(r.Tcw_cur))), "pose poisoned"
    assert all(np.isfinite(T).all() for T in system.map.camera_poses)
    return results


@pytest.mark.parametrize("name", br.DEGENERATE)
def test_degenerate_frames_stay_finite_in_both_packages(name):
    frames = case_frames(name)
    rj = _run(JSystem(JCFG), [to_jax(f) for f in frames])
    sampler = JaxKeySampler(FoldInKeys(0), TCFG.padding.k_obj_max,
                            TCFG.solver.obj_ensemble_seeds)
    rt = _run(TSystem(TCFG, sampler=sampler, device="cpu"), frames)
    if name == "single_pixel_objects":
        # objects below the 100-point gate never become active
        for r in rj[1:] + rt[1:]:
            assert not np.asarray(r.objects.active).any()
    assert [r is None for r in rt] == [r is None for r in rj]
    for a, b in zip(rt, rj):
        if a is not None:
            np.testing.assert_allclose(a.Tcw_cur, np.asarray(b.Tcw_cur), atol=T_TOL)


# --- the refusal of a frame whose size is not the camera's -------------------

KITTI = tconfig.DEFAULT_CONFIG.camera          # 1242x375
SMALL = case_frames("zero_depth", n=1)[0]
MSG = f"{W}x{H} but the camera config is {KITTI.width}x{KITTI.height}"


def _no_tensors_from_here(mp):
    """From here on, any tensor made from host data fails the test."""
    def no(*a, **k):
        raise AssertionError("a tensor was made from the refused frame")
    for f in ("from_numpy", "as_tensor", "tensor"):
        mp.setattr(torch, f, no)


def _system(method):
    def prepare(mp):
        s = TSystem(tconfig.DEFAULT_CONFIG, device="cpu")
        _no_tensors_from_here(mp)
        return getattr(s, method), lambda: s.map.camera_poses == [] and s._frame_idx == 0
    return prepare


def _mono(mp):
    tr = MonoTracker(tconfig.DEFAULT_CONFIG, device="cpu")
    _no_tensors_from_here(mp)
    return lambda fd: tr.track(fd.gray), lambda: tr.poses == [] and tr.state is None


def _batched(run):
    def prepare(mp):
        _no_tensors_from_here(mp)
        return lambda fd: run([fd, fd], tconfig.DEFAULT_CONFIG, device="cpu"), lambda: True
    return prepare


def _server(mp):
    """The frame goes over a socket pair; the server refuses it on receipt."""
    s = TSystem(tconfig.DEFAULT_CONFIG, device="cpu")
    a, b = socket.socketpair()

    def serve(fd):
        try:
            stream.send_frame(a, fd.gray, fd.depth_raw, flow=fd.flow, sem=fd.sem_mask)
            a.shutdown(socket.SHUT_WR)
            _no_tensors_from_here(mp)
            stream.serve_connection(b, system=s)
        finally:
            a.close()
            b.close()
    return serve, lambda: s.map.camera_poses == [] and s._frame_idx == 0


ENTRY_POINTS = {
    "MultiMotSystem.track_rgbd": _system("track_rgbd"),
    "MultiMotSystem.upload": _system("upload"),
    "MonoTracker.track": _mono,
    "batch.upload_frames": _batched(tbatch.upload_frames),
    "batch.run_sequence_streaming": _batched(tbatch.run_sequence_streaming),
    "stream.serve_connection": _server,
}


@pytest.mark.parametrize("entry", list(ENTRY_POINTS))
def test_frame_size_not_the_cameras_is_refused(entry):
    """A 64x96 frame under the 1242x375 camera: ``ValueError`` naming both
    sizes, raised before any tensor is made from the frame, and the
    entry point's state untouched."""
    with pytest.MonkeyPatch.context() as mp:
        call, untouched = ENTRY_POINTS[entry](mp)
        with pytest.raises(ValueError, match=MSG):
            call(SMALL)
    assert untouched()


def test_a_mismatched_flow_alone_is_named():
    fd = case_frames("zero_depth", n=1)[0]
    cfg = dataclasses.replace(tconfig.DEFAULT_CONFIG,
                              camera=dataclasses.replace(KITTI, width=W, height=H))
    fd.flow = np.zeros((H // 2, W // 2, 2), np.float32)
    with pytest.raises(ValueError, match=f"frame 0's flow is {W // 2}x{H // 2}"):
        TSystem(cfg, device="cpu").track_rgbd(fd)
