"""How much of the quad rows' accuracy the RANSAC hypotheses decide.

The rows: ``tools/measure_quad_ab.py``'s four (640x384, 1024 / 4096
points, ``max_disp=64``, 14 frames, textures default and distinct, the
quad gate off and on) and the stereo CLI's tree of ``chip_smoke.py``
phase 11(c) with ``--quad-stereo`` (``write_stereo_tree(n_frames=14,
cam=KITTI_SYNTH_CAM, texture="distinct")`` at DEFAULT_CONFIG).  Each run
prints one JSON line: camera t-RPE, ATE, quad matches, final state.

  JAX_PLATFORMS=cpu python tools/torch_quad_trace.py record [ROW ...]
      the port on the CPU drawing the JAX package's hypotheses (the key
      path of ``tests/test_torch_ransac.JaxKeySampler``, seed 0); writes
      each row's draws to ``tools/quad_ab_draws/<row>.npz`` (the stereo
      CLI's tree to ``build/scratch/quad_draws/``), the files
      ``chip_smoke.py`` replays
  JAX_PLATFORMS=cpu python tools/torch_quad_trace.py seeds {jax,port} SEED [SEED ...] [--rows ROW ...]
      the JAX package's or the port's system with its own draws,
      ``MultiMotSystem(seed=SEED)``, on the CPU
  python tools/torch_quad_trace.py card [--rows ROW ...]
      the port on the card, each row with the recorded draws replayed,
      with draws from a host ``torch.Generator`` (those of the port on
      the CPU at the same seed) and with the CUDA generator's (seeds 0 and
      1)

One process per row runs the CPU modes in parallel: ``--rows`` picks them.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import os
import pathlib
import shutil
import sys
import time

import numpy as np

REPO = pathlib.Path(__file__).resolve().parent.parent
AB_ROWS = ("ab-default-off", "ab-default-on", "ab-distinct-off", "ab-distinct-on")
ROWS = AB_ROWS + ("cli-quad",)
DRAWS = REPO / "tools" / "quad_ab_draws"
CLI_DRAWS = REPO / "build" / "scratch" / "quad_draws"
TREES = REPO / "build" / "scratch" / "quad_trace_trees"


def draws_path(row: str) -> pathlib.Path:
    return (CLI_DRAWS if row == "cli-quad" else DRAWS) / f"{row}.npz"


def tree(row: str, synth) -> pathlib.Path:
    """The row's stereo tree, rendered once under build/scratch/."""
    tex = "distinct" if row == "cli-quad" else row.split("-")[1]
    name = "kitti_distinct" if row == "cli-quad" else tex
    root = TREES / name
    if not (root / "times.txt").exists():
        kw = dict(cam=dict(synth.KITTI_SYNTH_CAM)) if row == "cli-quad" else {}
        tmp = TREES / f".{name}.{os.getpid()}"
        synth.write_stereo_tree(tmp, n_frames=14, texture=tex, **kw)
        try:
            os.replace(tmp, root)
        except OSError:                     # another process rendered it first
            shutil.rmtree(tmp)
    return root


def row_config(row: str, D):
    if row == "cli-quad":
        return D
    return dataclasses.replace(
        D, camera=_synth(D).synth_camera_config(),
        padding=dataclasses.replace(D.padding, n_static_max=1024, n_obj_pts_max=4096),
        solver=dataclasses.replace(D.solver, ransac_iters=200, cam_lm_iters=60,
                                   obj_lm_iters=100))


def _synth(D):
    if type(D).__module__.startswith("multimot_track_tpu_torch"):
        from multimot_track_tpu_torch.io import synth
    else:
        from multimot_track_tpu.io import synth
    return synth


def run_row(row, package, device=None, **system_kw):
    """Track the row's 14 frames; returns the JSON line's fields."""
    if package == "jax":
        from multimot_track_tpu.config import DEFAULT_CONFIG
        from multimot_track_tpu.io.stereo_seq import StereoKittiSequence
        from multimot_track_tpu.pipeline.system import MultiMotSystem
        dev_kw = {}
    else:
        from multimot_track_tpu_torch.config import DEFAULT_CONFIG
        from multimot_track_tpu_torch.io.stereo_seq import StereoKittiSequence
        from multimot_track_tpu_torch.pipeline.system import MultiMotSystem
        dev_kw = dict(device=device)
    from multimot_track_tpu_torch.io import synth

    quad = row == "cli-quad" or row.endswith("-on")
    seq_kw = {} if row == "cli-quad" else dict(max_disp=64)
    seq = StereoKittiSequence(tree(row, synth), quad_gate=quad, **seq_kw, **dev_kw)
    s = MultiMotSystem(row_config(row, DEFAULT_CONFIG), **dev_kw, **system_kw)
    t0 = time.perf_counter()
    for i in range(len(seq)):
        s.track_rgbd(seq.load_frame(i))
    summ = s.summary()
    return dict(row=row, package=package, cam_t_rpe=summ["cam_t_rpe_rel_mean"],
                ate_m=summ["ego_ate_rmse_m"], n_quad_matched=int(seq.n_quad_matched),
                state=s.state, seconds=round(time.perf_counter() - t0, 1))


def emit(line: dict):
    print(json.dumps(line), flush=True)


class RecordingSampler:
    """The JAX package's draws, kept under ``repr(site)#occurrence`` (a
    relocalization may draw twice at one site)."""

    def __init__(self, inner):
        self.inner, self.seen, self.rows = inner, {}, {}

    def __call__(self, p, iters, sites, k=3):
        idx = self.inner(p, iters, sites, k)
        for m, site in enumerate(sites.names()):
            key = repr(tuple(site))
            self.seen[key] = self.seen.get(key, -1) + 1
            self.rows[f"{key}#{self.seen[key]}"] = idx[m].numpy().astype(np.int16)
        return idx

    def save(self, path: pathlib.Path):
        path.parent.mkdir(parents=True, exist_ok=True)
        keys = list(self.rows)
        np.savez_compressed(path, keys=np.array(keys),
                            **{f"s{n}": self.rows[k] for n, k in enumerate(keys)})


def record(rows):
    import torch

    sys.path.insert(0, str(REPO / "tests"))
    from test_torch_ransac import FoldInKeys, JaxKeySampler

    from multimot_track_tpu_torch.config import DEFAULT_CONFIG

    torch.set_num_threads(2)
    for row in rows:
        cfg = row_config(row, DEFAULT_CONFIG)
        sampler = RecordingSampler(JaxKeySampler(FoldInKeys(0), cfg.padding.k_obj_max,
                                                 cfg.solver.obj_ensemble_seeds))
        line = run_row(row, "port", device="cpu", sampler=sampler)
        sampler.save(draws_path(row))
        emit(dict(line, draws="jax seed 0 (recorded)", n_draws=len(sampler.rows)))


def seeds(package, seed_list, rows):
    import torch

    torch.set_num_threads(2)
    for row in rows:
        for seed in seed_list:
            kw = dict(device="cpu") if package == "port" else {}
            emit(dict(run_row(row, package, seed=seed, **kw), draws=f"own, seed {seed}"))


def card(rows):
    import torch

    sys.path.insert(0, str(REPO))
    from chip_smoke import HostSampler, ReplaySampler

    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device("cuda", 0)
    for row in rows:
        replay = ReplaySampler(draws_path(row))
        emit(dict(run_row(row, "port", device=dev, sampler=replay),
                  draws="jax seed 0 (replayed)", replayed=replay.hits, missed=replay.misses))
        emit(dict(run_row(row, "port", device=dev, sampler=HostSampler(0)),
                  draws="host generator, seed 0"))
        for seed in (0, 1):
            emit(dict(run_row(row, "port", device=dev, seed=seed), draws=f"own, seed {seed}"))


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("mode", choices=("record", "seeds", "card"))
    ap.add_argument("args", nargs="*")
    ap.add_argument("--rows", nargs="+", choices=ROWS, default=list(ROWS))
    a = ap.parse_args()
    sys.path.insert(0, str(REPO))
    if a.mode == "record":
        record(a.args or a.rows)
    elif a.mode == "seeds":
        seeds(a.args[0], [int(x) for x in a.args[1:]], a.rows)
    else:
        card(a.rows)


if __name__ == "__main__":
    main()
