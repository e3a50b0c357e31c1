"""Entry ``live``: the live RGB-D system as the CLI runs it,
``MultiMotSystem.track_rgbd`` frame by frame in a closed loop, the next
frame packed and uploaded by ``MultiMotSystem.upload`` on one prefetch
thread (as ``system.run_sequence`` does).

The set-up's warm-up tracks the first ``warmup_frames`` frames of drive 0,
and the window carries on with that same system from the next frame, so
no frame of the window is a drive's start.  A drive that ends inside the
window is followed by a fresh system on the same noisy frames.  Every
drive's hypothesis sampler is seeded from ``--seed`` and the drive's
index.  The window ends once its seconds have passed and the frame in
flight has finished.  The traced run profiles the window's last
``trace_tail_s`` seconds (the frames begun after that point), and reads
the program's stage times on every frame before them: once the profiler
has run, the process's launches stay slower, so no frame after it is read.
"""

from __future__ import annotations

import dataclasses
import time
from concurrent.futures import ThreadPoolExecutor

import numpy as np

from portbench import devtrace, harness


def pipeline_config(cfg_file: dict):
    """The program's PipelineConfig from the configuration file's
    ``pipeline`` block (every field, as it is run)."""
    from multimot_track_tpu_torch import config as C

    groups = {f.name: f.type for f in dataclasses.fields(C.PipelineConfig)}
    parts = {}
    for name, values in cfg_file["pipeline"].items():
        cls = getattr(C, groups[name]) if isinstance(groups[name], str) else groups[name]
        parts[name] = cls(**values)
    return C.PipelineConfig(**parts)


def to_frame_data(frames):
    from multimot_track_tpu_torch.io.frame import FrameData

    names = [f.name for f in dataclasses.fields(FrameData)]
    return [FrameData(**{n: getattr(f, n) for n in names}) for f in frames]


class Live:
    def __init__(self, cell, frames, seed: int, trace: bool, device: str = "cuda"):
        import torch

        from multimot_track_tpu_torch.pipeline.system import MultiMotSystem

        self.torch = torch
        self.System = MultiMotSystem
        self.cell, self.seed, self.trace, self.device = cell, seed, trace, device
        self.cfg = pipeline_config(cell.config)
        self.system_kw = dict(cell.config["system"])
        self.fds = to_frame_data(frames)
        self.tf32 = False                 # the control: TF32 products on

    def system(self, drive):
        s = self.System(self.cfg, seed=harness.derive_seed(self.seed, "drive", drive),
                        device=self.device, **self.system_kw)
        # the program turns TF32 off when it builds a system; the control
        # turns it on after that, and a sound run leaves the program's choice
        if self.tf32:
            self.torch.backends.cuda.matmul.allow_tf32 = True
            self.torch.backends.cudnn.allow_tf32 = True
        return s

    def warm_up(self):
        """The cell's own shapes: the first ``warmup_frames`` frames of
        drive 0 (keyframes, TrackLocalMap over 1-3 keyframes, the trailing
        window, the joint BA at a keyframe), on the system the window
        carries on with."""
        self.first = int(self.cell.config["warmup_frames"])
        self.s0 = self.system(0)
        for fd in self.fds[:self.first]:
            self.s0.track_rgbd(fd, uploaded=self.s0.upload(fd))
        self.sync()

    def sync(self):
        if self.device == "cuda":
            self.torch.cuda.synchronize()

    def window(self, seconds: float, max_frames: int = None):
        """Drives until ``seconds`` have passed and, where it is given,
        ``max_frames`` frames have been taken; returns the run record.
        ``window(0, max_frames=len(frames) - warmup_frames)`` ends drive 0,
        the run's own path over one whole drive."""
        trace_at = seconds - float(self.cell.config["trace_tail_s"])
        patches = devtrace.Patches()
        probe = None
        sl = devtrace.Slice() if self.trace else None
        frames, drives, held = [], [], []
        n = len(self.fds)
        t_start = time.perf_counter()
        last = t_start
        done = False
        drive = 0
        while not done:
            s, first = (self.s0, self.first) if drive == 0 else (self.system(drive), 0)
            self.s0 = None
            stage_len = {k: len(v) for k, v in s.stage_times.items()}

            def prep(i, s=s):
                t0 = time.perf_counter()
                h = s.upload(self.fds[i])
                return h, time.perf_counter() - t0

            with ThreadPoolExecutor(1) as pool:
                fut = pool.submit(prep, first)
                for i in range(first, n):
                    if self.trace and probe is None and last - t_start >= trace_at:
                        probe = devtrace.KernelProbe(patches)
                        patches.set(self.System, "_stage", _spanned_stage(self.System._stage))
                        sl.start()
                    profiled = probe is not None
                    handles, up_s = fut.result()
                    if i + 1 < n:
                        fut = pool.submit(prep, i + 1)
                    s.track_rgbd(self.fds[i], uploaded=handles)
                    now = time.perf_counter()
                    stages = {}
                    for k, v in s.stage_times.items():
                        a = stage_len.get(k, 0)
                        if len(v) > a:
                            stages[k] = (float(sum(v[a:])), len(v) - a)
                            stage_len[k] = len(v)
                    frames.append(dict(dt=now - last, upload_s=up_s, stages=stages,
                                       profiled=profiled, drive=drive, index=i))
                    last = now
                    if now - t_start >= seconds and (max_frames is None
                                                     or len(frames) >= max_frames):
                        done = True
                        break
            if done and probe is not None:
                sl.stop()
                patches.restore()
            s.flush()
            drives.append(_answers(s, i + 1))
            held.append(len(s.keyframes.frames) if s.keyframes else 0)
            del s
            drive += 1
        self.sync()
        wall = last - t_start
        stage_s = {}
        for f in frames:
            for k, (t, _) in f["stages"].items():
                stage_s[k] = stage_s.get(k, 0.0) + t
        rec = dict(kind="live", wall_s=wall, frames=frames, attempted=len(frames),
                   n_drives=drive, answers=drives, keyframes_held=held,
                   stage_ms_per_frame={k: 1e3 * t / len(frames) for k, t in sorted(stage_s.items())})
        if probe is not None:
            rec["profile"] = sl.summary()
            rec["k1_bounds_us"] = probe.k1_bounds_us()
            rec["k2_bounds_us"] = probe.k2_bounds_us()
            rec["profiled_frames"] = sum(f["profiled"] for f in frames)
        return rec


def _spanned_stage(stage):
    """``MultiMotSystem._stage`` that also opens a ``pb:<stage>`` range."""
    import contextlib

    import torch

    def both(self, name):
        stack = contextlib.ExitStack()
        stack.enter_context(torch.profiler.record_function(devtrace.SPAN + name))
        stack.enter_context(stage(self, name))
        return stack
    return both


def _answers(s, n: int) -> dict:
    """What the reference judges of one drive of ``n`` frames."""
    m = s.map
    return dict(
        n=n,
        Twc=np.stack(m.camera_poses) if m.camera_poses else np.zeros((0, 4, 4)),
        Twc_raw=np.stack(m.camera_poses_raw) if m.camera_poses_raw else np.zeros((0, 4, 4)),
        records=[(r.frame, r.sem_label, r.track_id, r.P_lc) for r in m.obj_records],
    )


def make(cell, frames, seed, trace, device="cuda"):
    return Live(cell, frames, seed, trace, device)
