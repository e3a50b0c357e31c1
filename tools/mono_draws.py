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
          [--scene junction|avenue] [--backend] [--cpu]
      either package's tracker with its own draws at each seed, one JSON
      line a seed: the initialisation frame, the LOST frames (their count
      and the first), the Sim3 ATE, the scale drift and its number of scale
      pairs, and each step's direction cosine against the ground truth
      (junction only).  ``--scene junction`` (the default) is the 8-frame
      fixture above; ``--scene avenue`` is the scene exactly as
      ``eval.long_seq --mono`` renders and tracks it
      (``make_avenue_frames(239, cam=KITTI_SYNTH_CAM, texture="distinct")``,
      ``n_kp=768, keyframe_gap=3``).  ``--backend`` turns the backend on.
      The JAX package runs on the CPU; the port runs on the card, or on the
      CPU with ``--cpu``.
  JAX_PLATFORMS=cpu python tools/mono_draws.py replay [--frames N]
      the avenue (as ``--scene avenue --backend`` tracks it) through both
      packages' trackers on the CPU, frame by frame, the port drawing what
      the JAX package's ``MonoTracker(seed=0)`` draws
      (tests/test_torch_mono.MonoKeySampler): one JSON line a frame with
      each tracker's state (tracked / LOST / relocalized / not yet
      initialised), keyframes held, TrackLocalMap accepted, and the
      largest difference of the returned poses; beside them each stage's
      output: the frontend's keypoint rows that differ (and, where some
      do, how many differ from the same detector with a float32 pyramid),
      the map points (valid sets, points more than 1e-3 apart), the RANSAC
      PnP calls' inliers and the TrackLocalMap calls' inliers and matches
      with their poses' differences, and at each relocalization of the
      port the JAX package's ``relocalize`` on the port's own store, query
      and key; then the first frame at which each of these parts
"""

from __future__ import annotations

import dataclasses
import json
import pathlib
import sys
import time

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


def avenue(n=239):
    """The first ``n`` frames of the 239-frame avenue (the gray images and
    ground truth of a whole render)."""
    from multimot_track_tpu_torch.io.synth import KITTI_SYNTH_CAM, make_avenue_frames

    return make_avenue_frames(239, cam=dict(KITTI_SYNTH_CAM), texture="distinct",
                              times=range(n))


def seeds(package, seed_list, scene="junction", backend=False, cpu=False):
    import torch

    from multimot_track_tpu_torch.eval.long_seq import _scale_drift, _scale_series, card_info
    from multimot_track_tpu_torch.eval.metrics import absolute_trajectory_error

    frames = fixture() if scene == "junction" else avenue()
    # the junction fixture's own settings, or eval.long_seq's mono row's
    tr_kw = dict(enable_backend=backend) if scene == "junction" else dict(
        n_kp=768, keyframe_gap=3, enable_backend=backend)
    if package == "jax":
        import os

        os.environ["XLA_FLAGS"] = (os.environ.get("XLA_FLAGS", "") + " --xla_cpu_max_isa=AVX2").strip()
        import jax

        jax.config.update("jax_platforms", "cpu")
        from multimot_track_tpu.config import DEFAULT_CONFIG, CameraConfig
        from multimot_track_tpu.pipeline.mono import MonoTracker
        device = torch.device("cpu")
    else:
        from multimot_track_tpu_torch.config import DEFAULT_CONFIG, CameraConfig
        from multimot_track_tpu_torch.pipeline.mono import MonoTracker
        device = torch.device("cpu" if cpu else "cuda")
        tr_kw["device"] = device
    from multimot_track_tpu_torch.io.synth import KITTI_SYNTH_CAM

    cfg = dataclasses.replace(DEFAULT_CONFIG, camera=CameraConfig(**KITTI_SYNTH_CAM))
    for seed in seed_list:
        tr = MonoTracker(cfg, seed=seed, **tr_kw)
        lost, init = [], None
        t0 = time.perf_counter()
        for i, f in enumerate(frames):
            before = tr.n_lost_frames
            tr.track(f.gray)
            if tr.n_lost_frames > before:
                lost.append(i)
            if init is None and tr.initialized:
                init = i
        wall = time.perf_counter() - t0
        est = np.stack([np.linalg.inv(T) for T in tr.poses]).astype(np.float32)
        gt = np.stack([f.pose_gt for f in frames]).astype(np.float32)
        ate, _ = absolute_trajectory_error(torch.from_numpy(est), torch.from_numpy(gt),
                                           with_scale=True)
        ratios = _scale_series(tr.poses, frames)
        row = dict(package=package, scene=scene, backend=backend, seed=seed, init=init,
                   n_lost_frames=len(lost), first_lost=lost[0] if lost else None,
                   ate_sim3_m=float(ate),
                   scale_drift_log=_scale_drift(ratios) if ratios.size > 20 else None,
                   n_scale_pairs=int(ratios.size), n_loop_closures=len(tr.loop_events),
                   ms_per_frame=1e3 * wall / len(frames), **card_info(device))
        if scene == "junction":
            row.update(lost=lost, step_cosines=step_cosines(tr.poses, frames))
        print(json.dumps(row), flush=True)


def replay(n_frames, seed=0, pose_tol=1e-3, point_tol=1e-3):
    import os

    os.environ["XLA_FLAGS"] = (os.environ.get("XLA_FLAGS", "") + " --xla_cpu_max_isa=AVX2").strip()
    import jax
    import jax.numpy as jnp
    import torch

    jax.config.update("jax_platforms", "cpu")
    sys.path.insert(0, str(REPO / "tests"))
    from test_torch_mono import MonoKeySampler

    from multimot_track_tpu.config import DEFAULT_CONFIG as JDEFAULT
    from multimot_track_tpu.config import CameraConfig as JCameraConfig
    from multimot_track_tpu.pipeline import keyframes as jkf
    from multimot_track_tpu.pipeline import mono as jmono
    from multimot_track_tpu_torch.config import DEFAULT_CONFIG, CameraConfig
    from multimot_track_tpu_torch.frontend import fast
    from multimot_track_tpu_torch.io.synth import KITTI_SYNTH_CAM
    from multimot_track_tpu_torch.pipeline import mono as tmono

    torch.set_num_threads(1)     # as the tests run: CPU reductions split by threads round otherwise
    kw = dict(n_kp=768, keyframe_gap=3, enable_backend=True)
    trackers = {
        "jax": jmono.MonoTracker(dataclasses.replace(JDEFAULT, camera=JCameraConfig(**KITTI_SYNTH_CAM)),
                                 seed=seed, **kw),
        "port": tmono.MonoTracker(dataclasses.replace(DEFAULT_CONFIG,
                                                      camera=CameraConfig(**KITTI_SYNTH_CAM)),
                                  device="cpu", sampler=MonoKeySampler(seed), **kw)}
    # every stage's output of the current frame, by package
    rec = {name: dict(pnp=[], tlm=[], accepted=[], front=[], reloc=[]) for name in trackers}

    def recorder(fn, into, keep):
        def wrapped(*a, **k):
            out = fn(*a, **k)
            into.append(keep(a, out))
            return out
        return wrapped

    for name, mod in (("jax", jmono), ("port", tmono)):
        tr, r = trackers[name], rec[name]
        mod.pnp.ransac_pnp = recorder(mod.pnp.ransac_pnp, r["pnp"], lambda a, sol: (
            int(sol.n_inliers), np.asarray(sol.T, np.float64)))
        tr._track_local_map = recorder(tr._track_local_map, r["accepted"],
                                       lambda a, T: T is not None)
        tr._frontend = recorder(tr._frontend, r["front"], lambda a, out: tuple(
            np.asarray(x.cpu() if hasattr(x, "cpu") else x) for x in out))
        tr.keyframes.track_local_map = recorder(tr.keyframes.track_local_map, r["tlm"], lambda a, out: (
            np.asarray(a[0], np.float64), int(out[1]), int(out[2]), np.asarray(out[0], np.float64)))
    port_store = trackers["port"].keyframes

    def reloc_cross(a, T):
        """The JAX package's relocalize on a copy of the port's store, with
        the port's query and the same key."""
        sampler, site, desc, uv, valid, fx, fy, cx, cy = a[:9]
        js = jkf.KeyframeStore(capacity=port_store.capacity, min_gap=port_store.min_gap)
        js.frames = [jkf.Keyframe(**{f.name: np.copy(getattr(kf, f.name))
                                     if isinstance(getattr(kf, f.name), np.ndarray)
                                     else getattr(kf, f.name)
                                     for f in dataclasses.fields(jkf.Keyframe)})
                     for kf in port_store.frames]
        Tj = js.relocalize(jax.random.fold_in(jax.random.PRNGKey(seed), site[0]),
                           *(jnp.asarray(x.cpu().numpy()) for x in (desc, uv, valid)),
                           fx, fy, cx, cy)
        return dict(port=T is not None, jax_on_port_store=Tj is not None,
                    max_abs_dT=None if T is None or Tj is None
                    else float(np.abs(np.asarray(T) - np.asarray(Tj)).max()))
    port_store.relocalize = recorder(port_store.relocalize, rec["port"]["reloc"], reloc_cross)

    fe = DEFAULT_CONFIG.frontend
    first = {}
    for i, f in enumerate(avenue(n_frames)):
        row = dict(frame=i)
        poses = {}
        for name, tr in trackers.items():
            n_lost, n_reloc = tr.n_lost_frames, tr.n_relocalizations
            poses[name] = np.asarray(tr.track(f.gray), np.float64)
            acc = rec[name]["accepted"]
            row[name] = dict(state="not initialised" if not tr.initialized else
                             "LOST" if tr.n_lost_frames > n_lost else
                             "relocalized" if tr.n_relocalizations > n_reloc else "tracked",
                             keyframes=len(tr.keyframes.frames),
                             local_map=bool(acc[-1]) if acc else None)
        row["max_abs_dpose"] = float(np.abs(poses["jax"] - poses["port"]).max())
        (uj, dj, vj), (ut, dt, vt) = (rec[name]["front"][-1] for name in trackers)
        apart = (np.abs(uj - ut).max(1) > 0) | (dj != dt).any(1) | (vj != vt)
        row["frontend_rows_apart"] = int(apart.sum())
        if apart.any():
            # the same detector with a float32 pyramid (the JAX package's precision)
            kp = fast.detect_pyramid(torch.from_numpy(np.asarray(f.gray, np.float32))[None],
                                     threshold=float(fe.fast_threshold),
                                     min_threshold=float(fe.fast_min_threshold), n_levels=4,
                                     n_total=kw["n_kp"], accumulate=torch.float32)
            row["frontend_rows_apart_float32_pyramid"] = int(
                (np.abs(kp.uv[0].numpy() - uj).max(1) > 0).sum())
        sj, st = (trackers[name].state for name in trackers)
        if sj is not None and sj.Xw is not None and st.Xw is not None:
            both = sj.Xw_valid & st.Xw_valid
            d = np.abs(sj.Xw[both] - st.Xw[both]).max(1)
            row["map"] = dict(valid_equal=bool(np.array_equal(sj.Xw_valid, st.Xw_valid)),
                              n_valid=[int(sj.Xw_valid.sum()), int(st.Xw_valid.sum())],
                              n_apart=int((d > point_tol).sum()),
                              max_abs=float(d.max()) if d.size else 0.0)
        if rec["port"]["reloc"]:
            row["reloc_cross"] = rec["port"]["reloc"][-1]
        for stage in ("pnp", "tlm"):
            calls = {name: rec[name][stage] for name in trackers}
            if any(calls.values()):
                got = row["stages_" + stage] = {
                    name: [[c[1], c[2]] if stage == "tlm" else c[0] for c in cs]
                    for name, cs in calls.items()}
                if len(calls["jax"]) == len(calls["port"]):
                    got["max_abs_dT"] = [float(np.abs(a[-1] - b[-1]).max())
                                         for a, b in zip(calls["jax"], calls["port"])]
        for r in rec.values():
            for v in r.values():
                v.clear()
        print(json.dumps(row), flush=True)
        if row["max_abs_dpose"] > pose_tol:
            first.setdefault("pose", i)
        if row["jax"] != row["port"]:
            first.setdefault("state", i)
        if row["frontend_rows_apart"]:
            first.setdefault("frontend", i)
        if row.get("map", {}).get("n_apart"):
            first.setdefault("map_points", i)
    print(json.dumps(dict(first_parting=first, frames=n_frames, seed=seed)), flush=True)


def main(argv):
    import argparse

    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("what", choices=("record", "seeds", "replay"))
    ap.add_argument("package", nargs="?", choices=("jax", "port"))
    ap.add_argument("seed", nargs="*", type=int)
    ap.add_argument("--scene", choices=("junction", "avenue"), default="junction")
    ap.add_argument("--backend", action="store_true")
    ap.add_argument("--cpu", action="store_true")
    ap.add_argument("--frames", type=int, default=239)
    args = ap.parse_args(argv)
    if args.what == "record":
        record()
    elif args.what == "replay":
        replay(args.frames)
    elif args.package is None or not args.seed:
        sys.exit(__doc__)
    else:
        seeds(args.package, args.seed, args.scene, args.backend, args.cpu)


if __name__ == "__main__":
    main(sys.argv[1:])
