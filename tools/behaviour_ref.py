"""The behaviour gates' scenes, and the JAX package's values on them.

The port's gate tests (``tests/test_torch_robustness.py``,
``test_torch_multimover_k8.py``, ``test_torch_multimover_k4.py``,
``test_torch_marathon.py``, ``test_torch_maskless.py``,
``test_torch_precision.py``) and
``chip_smoke.py`` phase 16 build their scenes and configurations here and
hold the port to the values this script records from the JAX package on the
CPU, in ``tools/behaviour_ref.json``.  The module imports neither package at
its top: each builder takes the package's config module and camera, so the
card's smoke test (no JAX there) builds the same scenes.

Scenes (``degenerate_frames`` and ``precision_problem`` build the inputs of
``tests/test_robustness.py`` and ``tests/test_precision.py`` without JAX;
the JAX tests run those themselves):
  multimover_k8, multimover_k4
      ``make_multimover_frames(8)`` (six movers, crossing, occlusion, birth,
      death) at the synth camera through ``MultiMotSystem(cfg,
      enable_keyframes=False)``, at ``tests/test_multimover._cfg(k)``;
  marathon
      a 17-frame shuttle rendered as ``tests/test_torch_loop_live.
      shuttle_frames`` renders its frames (0.3 m a position, synth camera,
      ``default_movers()``) in ``tests/test_marathon.py``'s order over 5
      positions (forward, back, forward, back), through ``MultiMotSystem(cfg,
      keyframe_gap=2, loop_consistency=1)`` with the store's capacity forced
      to 5, at ``test_marathon.TEST_CFG`` on the synth camera with both
      windows off (the settings with which the port's shuttle tests close
      loops);
  marathon_pipelined
      the same in pipelined mode (``pipelined=True``).

  JAX_PLATFORMS=cpu python tools/behaviour_ref.py record [SCENE ...]
      runs the JAX package on the CPU on each scene named (default: all;
      ~1 min each multimover scene, ~3 min the marathon) and writes its
      values into tools/behaviour_ref.json, keeping the other scenes'.
"""

from __future__ import annotations

import dataclasses
import json
import pathlib
import sys

import numpy as np

REPO = pathlib.Path(__file__).resolve().parent.parent
REF = REPO / "tools" / "behaviour_ref.json"

MULTIMOVER_N = 8
MARATHON_ORDER = list(range(5)) + list(range(3, -1, -1)) + list(range(1, 5)) \
    + list(range(3, -1, -1))          # tests/test_marathon.py: fwd, rev, fwd, rev
MARATHON_STEP = 0.3                   # metres a position
MARATHON_CAPACITY = 5
MARATHON_KW = dict(keyframe_gap=2, loop_consistency=1)


def multimover_config(C, cam, k_obj: int, full_width: bool = False):
    """``tests/test_multimover._cfg(k_obj)`` on package ``C``'s config
    module; ``full_width``: DEFAULT_CONFIG's padding and solver instead."""
    D = C.DEFAULT_CONFIG
    if full_width:
        return dataclasses.replace(D, camera=cam,
                                   padding=dataclasses.replace(D.padding, k_obj_max=k_obj))
    return dataclasses.replace(
        D, camera=cam,
        padding=dataclasses.replace(D.padding, n_static_max=1024, n_obj_pts_max=4096,
                                    k_obj_max=k_obj),
        solver=dataclasses.replace(D.solver, ransac_iters=200, cam_lm_iters=60,
                                   obj_lm_iters=100),
    )


def marathon_config(C, cam, full_width: bool = False):
    """``tests/test_marathon.TEST_CFG`` at ``cam`` with both windows off;
    ``full_width``: DEFAULT_CONFIG with both windows off."""
    D = C.DEFAULT_CONFIG
    backend = dataclasses.replace(D.backend, window_refine=False, joint_window_refine=False)
    if full_width:
        return dataclasses.replace(D, camera=cam, backend=backend)
    return dataclasses.replace(
        D, camera=cam, backend=backend,
        padding=dataclasses.replace(D.padding, n_static_max=1024, n_obj_pts_max=2048,
                                    k_obj_max=4),
        solver=dataclasses.replace(D.solver, ransac_iters=200, cam_lm_iters=60,
                                   obj_lm_iters=60, obj_ensemble_seeds=1),
    )


def marathon_frames(synth):
    """The 17 shuttle frames, rendered by package ``synth`` (an ``io.synth``
    module of either package)."""
    def Twc_at(t):
        T = np.eye(4)
        T[2, 3] = MARATHON_STEP * MARATHON_ORDER[t]
        return T

    return synth._build_frames(dict(synth.SYNTH_CAM), Twc_at, synth.default_movers(),
                               len(MARATHON_ORDER), box=False)


# tests/test_robustness.py's cases, in the order of their gray images' seeds
DEGENERATE = ("zero_depth", "fully_masked", "nan_flow", "saturated_depth",
              "single_pixel_objects")


def degenerate_frames(case: str, H: int, W: int, n: int = 3):
    """``tests/test_robustness.py``'s ``n`` frames of ``case`` at H x W, as
    the port's ``FrameData``: gray drawn from the case's seed, depth 10 m,
    zero flow and masks unless the case changes them."""
    from multimot_track_tpu_torch.io.frame import FrameData

    gray = np.random.default_rng(DEGENERATE.index(case)).uniform(0, 255, (H, W)).astype(np.float32)
    depth = np.full((H, W), 256.0 * 10.0, np.float32)
    flow = np.zeros((H, W, 2), np.float32)
    sem = np.zeros((H, W), np.int32)
    if case == "zero_depth":
        depth = np.zeros((H, W), np.float32)
    elif case == "fully_masked":
        sem = np.ones((H, W), np.int32)
    elif case == "nan_flow":
        flow = np.full((H, W, 2), np.nan, np.float32)
    elif case == "saturated_depth":
        depth = np.full((H, W), 65535.0, np.float32)
    else:
        sem[10, 10], sem[30, 50] = 1, 2
        flow = np.full((H, W, 2), 1.0, np.float32)
    return [FrameData(index=i, timestamp=0.1 * i, gray=gray, depth_raw=depth, flow=flow,
                      sem_mask=sem, pose_gt=np.eye(4, dtype=np.float32),
                      obj_ids_gt=np.zeros(0, np.int32),
                      obj_poses_gt=np.zeros((0, 4, 4), np.float32),
                      obj_bboxes_gt=np.zeros((0, 4), np.float32)) for i in range(n)]


PRECISION_N, PRECISION_SEED = 1024, 17      # tests/test_precision.py's problem
PRECISION_ITERS, PRECISION_GATE = 60, 0.04


def precision_problem(seed: int = PRECISION_SEED, n: int = PRECISION_N, noise_px: float = 0.3):
    """``tests/test_precision.synth`` with the port's geometry (float32, as
    there): (uv, z, flow, T_true) as float64 numpy, from a generator at
    ``seed`` drawing in that file's order."""
    import torch

    from multimot_track_tpu_torch.config import CameraConfig
    from multimot_track_tpu_torch.geometry import camera, se3

    cam = CameraConfig()
    rng = np.random.default_rng(seed)
    uv = rng.uniform([80, 40], [cam.width - 80, cam.height - 40], (n, 2))
    z = rng.uniform(4.0, 30.0, n)
    f32 = lambda a: torch.as_tensor(np.asarray(a), dtype=torch.float32)
    X = camera.backproject(f32(uv), f32(z), cam.fx, cam.fy, cam.cx, cam.cy)
    T_true = se3.exp_se3(f32([0.003, -0.002, 0.001, 0.04, -0.02, 1.1]))
    uv1 = camera.project(se3.transform(T_true, X), cam.fx, cam.fy, cam.cx, cam.cy)
    flow = uv1.numpy() - uv + rng.normal(scale=noise_px, size=(n, 2))
    return uv, z, flow, T_true.numpy().astype(np.float64)


def maskless_pair(cfg, frames, sampler, device="cpu"):
    """``tests/test_maskless_ego._pair_rpe`` on the port: frames 0 and 1
    with their masks zeroed, in that test's wire formats (gray8, raw
    disparity, flow x128 in int16, uint8 labels), the pair solved from the
    initial context with draws at site ``(0, ...)``.  Returns the pair's
    ``PairResult`` (no batch axis, on ``device``)."""
    import torch

    from multimot_track_tpu_torch.pipeline import frames as F
    from multimot_track_tpu_torch.pipeline import tracker

    K = cfg.padding.k_obj_max

    def wire(fd):
        arrays = (np.clip(np.round(fd.gray), 0, 255).astype(np.uint8),
                  np.clip(fd.depth_raw, 0, 65535).astype(np.int32),
                  np.clip(fd.flow * 128.0, -32767, 32767).astype(np.int16),
                  np.zeros(fd.sem_mask.shape, np.uint8))
        return [torch.from_numpy(a).to(device) for a in arrays]

    def gt(fd):
        table = F.make_gt_table(fd.pose_gt, fd.obj_ids_gt, fd.obj_poses_gt, K)
        return F.GTTable(*(torch.from_numpy(x).to(device) for x in table))

    obs0 = tracker.first_step(*wire(frames[0]), gt(frames[0]), cfg)
    ctx = F.tree_map(lambda x: x[0], tracker.initial_context(K, 1, device))
    return tracker.full_step(sampler, 0, obs0, *wire(frames[1]), gt(frames[1]), ctx, cfg)[0]


def count_adds(system) -> list:
    """Wrap the system's ``keyframes.maybe_add``; the returned list gets the
    index of every keyframe added."""
    added, add = [], system.keyframes.maybe_add

    def counted(kf):
        ok = add(kf)
        if ok:
            added.append(int(kf.index))
        return ok
    system.keyframes.maybe_add = counted
    return added


def multimover_table(system) -> dict:
    """The record table the gates compare: per label with ground truth, its
    records' frames and track IDs in order and their median t-RPE; the
    camera's mean t-RPE and the speed error's median."""
    recs = [r for r in system.map.obj_records if r.has_gt]
    labels = {}
    for r in recs:
        e = labels.setdefault(str(int(r.sem_label)), dict(frames=[], track_ids=[], t_rpe=[]))
        e["frames"].append(int(r.frame))
        e["track_ids"].append(int(r.track_id))
        e["t_rpe"].append(float(r.t_rpe_rel))
    for e in labels.values():
        e["median_t_rpe"] = float(np.median(e.pop("t_rpe")))
    sp = [r.speed_err_rel for r in recs if np.isfinite(r.speed_err_rel)]
    return dict(labels=labels,
                cam_t_rpe_rel_mean=float(system.summary()["cam_t_rpe_rel_mean"]),
                speed_err_median=float(np.median(sp)) if sp else None)


def marathon_summary(system, added) -> dict:
    """Loop events (frame, keyframe frame, inliers), the keyframes added
    and held, and every camera pose."""
    return dict(loop_events=[[int(x) for x in e[:3]] for e in system.map.loop_events],
                added=list(added), held=[int(k.index) for k in system.keyframes.frames],
                poses=np.stack(system.map.camera_poses).astype(float).tolist())


def load() -> dict:
    return json.loads(REF.read_text())


def _jax_run(name):
    import multimot_track_tpu.config as C
    from multimot_track_tpu.io import synth
    from multimot_track_tpu.pipeline.system import MultiMotSystem

    cam = synth.synth_camera_config()
    if name.startswith("multimover_k"):
        k = int(name[len("multimover_k"):])
        s = MultiMotSystem(multimover_config(C, cam, k), enable_keyframes=False)
        for fd in synth.make_multimover_frames(n_frames=MULTIMOVER_N):
            s.track_rgbd(fd)
        s.flush()
        return multimover_table(s)
    if name in ("marathon", "marathon_pipelined"):
        s = MultiMotSystem(marathon_config(C, cam), pipelined=name.endswith("_pipelined"),
                           **MARATHON_KW)
        s.keyframes.capacity = MARATHON_CAPACITY
        added = count_adds(s)
        for fd in marathon_frames(synth):
            s.track_rgbd(fd)
        s.flush()
        return marathon_summary(s, added)
    raise SystemExit(f"unknown scene {name}")


SCENES = ("multimover_k8", "multimover_k4", "marathon", "marathon_pipelined")


def main(argv) -> int:
    if not argv or argv[0] != "record":
        print(__doc__)
        return 2
    import jax

    jax.config.update("jax_platforms", "cpu")
    sys.path.insert(0, str(REPO))
    ref = load() if REF.exists() else {}
    for name in argv[1:] or SCENES:
        ref[name] = _jax_run(name)
        print(name, json.dumps({k: v for k, v in ref[name].items() if k != "poses"}), flush=True)
        REF.write_text(json.dumps(ref, indent=1, sort_keys=True) + "\n")
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
