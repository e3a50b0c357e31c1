"""Hypothesis draws of the monocular fixture, for ``chip_smoke.py`` phase 12.

The fixture: the distinct-texture junction at the KITTI camera, every 6th
frame of 43 (``make_junction_frames(43, ..., times=range(0, 43, 6))``),
tracked by ``MonoTracker`` with the backend off, and as the 15-frame
shuttle (the 8 frames, then back to the start) with ``keyframe_gap=2``.

  JAX_PLATFORMS=cpu python tools/mono_draws.py record
      the port's tracker on the CPU drawing what the JAX package's
      ``MonoTracker(seed=0)`` draws (tests/test_torch_mono.MonoKeySampler);
      writes tools/mono_draws/{off,shuttle}.npz, the files phase 12
      replays on the card, and prints each run's events
  JAX_PLATFORMS=cpu python tools/mono_draws.py seeds {jax,port} SEED [SEED ...]
      either package's tracker with its own draws at each seed (backend
      off, 8 frames): the initialisation frame, the LOST frames and each
      step's direction cosine against the ground truth
"""

from __future__ import annotations

import dataclasses
import json
import pathlib
import sys

import numpy as np

REPO = pathlib.Path(__file__).resolve().parent.parent
sys.path.insert(0, str(REPO))
DRAWS = REPO / "tools" / "mono_draws"
TIMES = range(0, 43, 6)


def fixture():
    from multimot_track_tpu_torch.io.synth import KITTI_SYNTH_CAM, make_junction_frames

    return make_junction_frames(43, cam=dict(KITTI_SYNTH_CAM), texture="distinct", times=TIMES)


def runs(frames):
    """(name, grays, tracker keyword arguments) of the two recorded runs."""
    grays = [f.gray for f in frames]
    return (("off", grays, dict(enable_backend=False)),
            ("shuttle", grays + grays[-2::-1], dict(keyframe_gap=2)))


def step_cosines(poses, frames) -> list:
    c = [np.linalg.inv(T)[:3, 3] for T in poses]
    g = [f.pose_gt[:3, 3] for f in frames]
    out = []
    for i in range(1, len(frames)):
        de, dg = c[i] - c[i - 1], g[i] - g[i - 1]
        out.append(round(float(de @ dg / (np.linalg.norm(de) * np.linalg.norm(dg) + 1e-12)), 4))
    return out


def record():
    import torch

    sys.path.insert(0, str(REPO / "tests"))
    sys.path.insert(0, str(REPO / "tools"))
    from test_torch_mono import MonoKeySampler
    from torch_quad_trace import RecordingSampler

    from multimot_track_tpu_torch.config import DEFAULT_CONFIG, CameraConfig
    from multimot_track_tpu_torch.io.synth import KITTI_SYNTH_CAM
    from multimot_track_tpu_torch.pipeline.mono import MonoTracker

    torch.set_num_threads(1)     # as the tests run: CPU reductions split by threads round otherwise
    cfg = dataclasses.replace(DEFAULT_CONFIG, camera=CameraConfig(**KITTI_SYNTH_CAM))
    for name, grays, kw in runs(fixture()):
        sampler = RecordingSampler(MonoKeySampler(0))
        tr = MonoTracker(cfg, device="cpu", sampler=sampler, **kw)
        for g in grays:
            tr.track(g)
        sampler.save(DRAWS / f"{name}.npz")
        print(json.dumps(dict(run=name, draws="jax seed 0 (recorded)", n_draws=len(sampler.rows),
                              init=tr.init_frame, lost=tr.lost_frames,
                              reloc=tr.relocalized_frames,
                              loops=[l[:3] for l in tr.loop_events])), flush=True)


def seeds(package, seed_list):
    frames = fixture()
    if package == "jax":
        from multimot_track_tpu.config import DEFAULT_CONFIG, CameraConfig
        from multimot_track_tpu.pipeline.mono import MonoTracker
        dev_kw = {}
    else:
        from multimot_track_tpu_torch.config import DEFAULT_CONFIG, CameraConfig
        from multimot_track_tpu_torch.pipeline.mono import MonoTracker
        dev_kw = dict(device="cpu")
    from multimot_track_tpu_torch.io.synth import KITTI_SYNTH_CAM

    cfg = dataclasses.replace(DEFAULT_CONFIG, camera=CameraConfig(**KITTI_SYNTH_CAM))
    for seed in seed_list:
        tr = MonoTracker(cfg, seed=seed, enable_backend=False, **dev_kw)
        n_lost = []
        for i, f in enumerate(frames):
            before = tr.n_lost_frames
            tr.track(f.gray)
            if tr.n_lost_frames > before:
                n_lost.append(i)
        print(json.dumps(dict(package=package, seed=seed, lost=n_lost,
                              step_cosines=step_cosines(tr.poses, frames))), flush=True)


if __name__ == "__main__":
    if sys.argv[1:2] == ["record"]:
        record()
    elif sys.argv[1:2] == ["seeds"] and sys.argv[2] in ("jax", "port"):
        seeds(sys.argv[2], [int(s) for s in sys.argv[3:]])
    else:
        sys.exit(__doc__)
