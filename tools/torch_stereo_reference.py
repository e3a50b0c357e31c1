"""The JAX package's CLI on the trees of ``chip_smoke.py`` phase 11, on the
CPU: the reference figures the card's runs are read beside.

Default: writes ``write_stereo_tree(n_frames=14, cam=KITTI_SYNTH_CAM,
texture="distinct")`` under ``build/scratch/stereo_reference/`` and runs
``python -m multimot_track_tpu.cli TREE --cpu --stereo`` with
``--discover-objects`` and with ``--quad-stereo`` (and, with ``--port``,
the port's CLI with the same flags and ``--cpu``).  ~4 min per JAX run on
8 CPU cores, ~6 min per port run.

``--rgbd``: phase 11(b)'s tree instead, ``write_kitti_tree`` of
``make_junction_frames(12)`` at the KITTI camera (8-bit RGB images,
integer disparity PNGs, .flo, mask text), through ``python -m
multimot_track_tpu.cli TREE --cpu``, beside the JAX package's
``MultiMotSystem`` on the same frames in memory (phase 6's run): how much
accuracy the tree's 8-bit gray and integer disparity cost the reference.
~5 min per run.

Prints one JSON line of each run's camera t-RPE, ATE and quad matches.

  JAX_PLATFORMS=cpu python tools/torch_stereo_reference.py [--port] [--rgbd]
"""

import argparse
import json
import os
import pathlib
import shutil
import subprocess
import sys

REPO = pathlib.Path(__file__).resolve().parent.parent
KEYS = ("n_frames", "cam_t_rpe_rel_mean", "ego_ate_rmse_m", "n_quad_matched")


def run_cli(package, tree, flags):
    env = dict(os.environ, PYTHONPATH=str(REPO), JAX_PLATFORMS="cpu",
               XLA_FLAGS="--xla_cpu_max_isa=AVX2")
    out = subprocess.run([sys.executable, "-m", f"{package}.cli", str(tree), "--cpu", *flags],
                         capture_output=True, text=True, env=env, check=True).stdout
    s = json.loads(out.split("summary:", 1)[1].split("\ntraj.png", 1)[0])
    return {k: s.get(k) for k in KEYS}


def jax_in_memory(frames_n):
    """The JAX package's system at DEFAULT_CONFIG over the junction frames
    in memory."""
    import jax

    jax.config.update("jax_platforms", "cpu")
    from multimot_track_tpu.config import DEFAULT_CONFIG
    from multimot_track_tpu.io.synth import KITTI_SYNTH_CAM, make_junction_frames
    from multimot_track_tpu.pipeline.system import MultiMotSystem

    s = MultiMotSystem(DEFAULT_CONFIG)
    for fd in make_junction_frames(n_frames=frames_n, cam=dict(KITTI_SYNTH_CAM)):
        s.track_rgbd(fd)
    summ = s.summary()
    return {k: summ.get(k) for k in KEYS}


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--port", action="store_true", help="also run the port's CLI on the CPU")
    ap.add_argument("--rgbd", action="store_true", help="phase 11(b)'s RGB-D tree")
    args = ap.parse_args()
    sys.path.insert(0, str(REPO))
    from multimot_track_tpu_torch.io.synth import (KITTI_SYNTH_CAM, make_junction_frames,
                                                   write_kitti_tree, write_stereo_tree)

    packages = ["multimot_track_tpu"] + (["multimot_track_tpu_torch"] if args.port else [])
    rows = {}
    if args.rgbd:
        tree = REPO / "build" / "scratch" / "rgbd_reference"
        shutil.rmtree(tree, ignore_errors=True)
        write_kitti_tree(tree, make_junction_frames(n_frames=12, cam=dict(KITTI_SYNTH_CAM)))
        runs = [(p, []) for p in packages]
    else:
        tree = REPO / "build" / "scratch" / "stereo_reference"
        shutil.rmtree(tree, ignore_errors=True)
        write_stereo_tree(tree, n_frames=14, cam=dict(KITTI_SYNTH_CAM), texture="distinct")
        runs = [(p, ["--stereo", flag]) for p in packages
                for flag in ("--discover-objects", "--quad-stereo")]
    try:
        for package, flags in runs:
            rows[" ".join([package, *flags])] = run_cli(package, tree, flags)
    finally:
        shutil.rmtree(tree, ignore_errors=True)
    if args.rgbd:
        rows["multimot_track_tpu in memory"] = jax_in_memory(12)
    print(json.dumps(rows))


if __name__ == "__main__":
    main()
