"""A cell's inputs: the clean drive, rendered once per checkout into
``portbench/.cache/`` and loaded by every later run, and the run's own
noise drawn from ``--seed``.

The cache directory of a drive (``portbench/.cache/<scene>-<hash>/``) is named by a hash of the scene's source,
the renderer's source and the scene's arguments, so it is a fixed path
that an edited scene never hits by mistake.
"""

from __future__ import annotations

import concurrent.futures as cf
import hashlib
import json
import multiprocessing
import os
import shutil

import numpy as np

from portbench import harness
from portbench.scenes.render import Frame, degrade_frames

_ARRAYS = ("gray", "depth_raw", "flow", "sem_mask", "pose_gt")


def _render_one(scene_file: str, args: dict, k: int) -> Frame:
    """Worker: frame k of the scene (runs in a spawned process)."""
    import pathlib

    mod = harness.load_module(pathlib.Path(scene_file), "scene")
    return mod.build(**args).frame(k)


def _key(cell) -> str:
    scene_file = cell.bench_dir / "scenes" / f"{cell.traffic['scene']}.py"
    h = hashlib.sha256()
    for p in (scene_file, cell.bench_dir / "scenes" / "render.py"):
        h.update(p.read_bytes())
    h.update(json.dumps(cell.traffic.get("scene_args", {}), sort_keys=True).encode())
    return f"{cell.traffic['scene']}-{h.hexdigest()[:16]}"


def _render(cell):
    """Every frame of the drive, spread over up to 8 spawned processes."""
    workers = min(8, os.cpu_count() or 1)
    scene = cell.scene()
    n = len(scene.times)
    scene_file = str(cell.bench_dir / "scenes" / f"{cell.traffic['scene']}.py")
    args = cell.traffic.get("scene_args", {})
    if workers <= 1:
        return [scene.frame(k) for k in range(n)]
    ctx = multiprocessing.get_context("spawn")
    with cf.ProcessPoolExecutor(workers, mp_context=ctx) as pool:
        futs = [pool.submit(_render_one, scene_file, args, k) for k in range(n)]
        return [f.result() for f in futs]


def _save(frames, path):
    tmp = path.with_name(path.name + ".partial")
    shutil.rmtree(tmp, ignore_errors=True)
    tmp.mkdir(parents=True)
    for name in _ARRAYS:
        a = np.stack([getattr(f, name) for f in frames])
        if name == "sem_mask":
            a = a.astype(np.uint8)            # labels 0-15
        np.save(tmp / f"{name}.npy", a)
    meta = [{"index": f.index, "timestamp": f.timestamp,
             "obj_ids_gt": f.obj_ids_gt.tolist(), "obj_poses_gt": f.obj_poses_gt.tolist(),
             "obj_bboxes_gt": f.obj_bboxes_gt.tolist()} for f in frames]
    (tmp / "meta.json").write_text(json.dumps(meta))
    shutil.rmtree(path, ignore_errors=True)
    os.replace(tmp, path)


def _load(path):
    arrs = {name: np.load(path / f"{name}.npy") for name in _ARRAYS}
    meta = json.loads((path / "meta.json").read_text())
    frames = []
    for k, m in enumerate(meta):
        frames.append(Frame(
            index=m["index"], timestamp=m["timestamp"],
            gray=arrs["gray"][k], depth_raw=arrs["depth_raw"][k], flow=arrs["flow"][k],
            sem_mask=arrs["sem_mask"][k].astype(np.int32), pose_gt=arrs["pose_gt"][k],
            obj_ids_gt=np.asarray(m["obj_ids_gt"], np.int32).reshape(-1),
            obj_poses_gt=np.asarray(m["obj_poses_gt"], np.float32).reshape(-1, 4, 4),
            obj_bboxes_gt=np.asarray(m["obj_bboxes_gt"], np.float32).reshape(-1, 4)))
    return frames


def clean_frames(cell):
    """The cell's clean drive: from the cache, or rendered and cached.
    Returns (frames, 'cache' | 'render')."""
    cache = cell.bench_dir / ".cache"
    path = cache / _key(cell)
    if (path / "meta.json").is_file():
        return _load(path), "cache"
    cache.mkdir(parents=True, exist_ok=True)
    (cache / ".gitignore").write_text("*\n")
    frames = _render(cell)
    _save(frames, path)
    return _load(path), "render"


def noisy_frames(cell, frames, seed: int):
    """The run's inputs: the traffic's noise models at a seed drawn from
    ``--seed`` (the clean drive when the traffic names no noise)."""
    noise = cell.traffic.get("noise")
    if noise is None:
        return frames
    return degrade_frames(frames, seed=harness.derive_seed(seed, "noise"), **noise)
