"""The monocular entry points (CPU): the EuRoC reader and the CLI's
``--mono`` / ``--euroc`` / ``--tum --mono`` drives, against the JAX package.

* ``io/synth.write_euroc_tree`` puts the monocular fixture (the
  distinct-texture junction at the KITTI camera, every 6th frame of 43) in
  the EuRoC ASL layout: 8-bit gray PNGs, ``data.csv``, a ``sensor.yaml``
  with radial-tangential distortion and a body <- camera extrinsic, and
  body ground truth 1 ms off the frame clock;
* the port's ``EurocSequence`` gives the JAX package's frames, timestamps,
  ground-truth poses and camera config (a drift guard of the numpy copy);
* ``cli.main([tree, "--mono", "--cpu", "--out", ...])`` over a KITTI tree
  with a kitti03.yaml, and ``[tree, "--euroc", ...]``, write a
  ``mono_trajectory.txt`` within 1e-3 of the JAX CLI's (5e-3 on the KITTI
  tree: ``KITTI_TREE_TOL``) and the same summary, the port drawing the JAX
  package's hypotheses; ``--tum --mono`` runs;
* a subprocess with ``jax`` blocked imports the monocular modules and runs
  ``--euroc``.
"""

import dataclasses
import json
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from multimot_track_tpu import cli as jcli
from multimot_track_tpu.io.euroc import EurocSequence as JEuroc
from multimot_track_tpu_torch import cli
from multimot_track_tpu_torch.io.euroc import EurocSequence
from multimot_track_tpu_torch.io.synth import (
    KITTI_SYNTH_CAM, make_junction_frames, write_euroc_tree, write_kitti_tree, write_tum_tree)
from multimot_track_tpu_torch.pipeline import mono
from test_torch_mono import MonoKeySampler

torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TRAJ_TOL = 1e-3
# the KITTI tree's 8-bit RGB frames: the JAX package's float32 bootstrap at
# frame 2 lies 4.5e-2 from its float64 answer, the port's within 1e-6
# (tests/test_torch_mono_init.py::test_initialize_mono_on_8bit_frames_jax_float32_error);
# the trajectories part by 3.5e-3 (measured)
KITTI_TREE_TOL = 5e-3


@pytest.fixture(scope="module")
def frames():
    return make_junction_frames(43, cam=dict(KITTI_SYNTH_CAM), texture="distinct",
                                times=range(0, 43, 6))


@pytest.fixture(scope="module")
def euroc_tree(frames, tmp_path_factory):
    return write_euroc_tree(tmp_path_factory.mktemp("euroc"), frames, KITTI_SYNTH_CAM)


def summary_of(out: str) -> dict:
    return json.loads(out.split("summary:", 1)[1])


class ReplayingTracker(mono.MonoTracker):
    """The port's tracker drawing the JAX CLI's hypotheses (PRNGKey(0))."""

    def __init__(self, *a, **kw):
        super().__init__(*a, sampler=MonoKeySampler(0), **kw)


def run_both(capsys, tmp_path, argv):
    """The port's and the JAX package's CLI on ``argv``: (trajectories,
    summaries, the port's stdout)."""
    t_out, j_out = tmp_path / "port", tmp_path / "jax"
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(mono, "MonoTracker", ReplayingTracker)
        assert cli.main(argv + ["--out", str(t_out)]) == 0
    t_text = capsys.readouterr().out
    assert jcli.main(argv + ["--out", str(j_out)]) == 0
    j_text = capsys.readouterr().out
    trajs = [np.loadtxt(d / "mono_trajectory.txt") for d in (t_out, j_out)]
    return trajs, (summary_of(t_text), summary_of(j_text)), t_text


def test_euroc_sequence_matches_jax(euroc_tree, frames):
    t, j = EurocSequence(euroc_tree), JEuroc(euroc_tree)
    assert len(t) == len(j) == len(frames)
    np.testing.assert_array_equal(t.T_BS, j.T_BS)
    ct, cj = dataclasses.asdict(t.camera_config()), dataclasses.asdict(j.camera_config())
    assert ct == cj and ct["k1"] != 0.0
    for i in range(len(t)):
        a, b = t.load_frame(i), j.load_frame(i)
        np.testing.assert_array_equal(a.gray, b.gray)
        assert a.timestamp == b.timestamp and a.index == b.index == i
        np.testing.assert_array_equal(a.pose_gt, b.pose_gt)
        # the ground truth's T_WB T_BS is the rendered camera-to-world pose
        np.testing.assert_allclose(a.pose_gt, frames[i].pose_gt, atol=1e-5)


def test_cli_mono_kitti_tree_matches_jax(tmp_path, capsys, frames):
    root = write_kitti_tree(tmp_path / "seq", frames)
    (root / "kitti03.yaml").write_text(
        "%YAML:1.0\n" + "".join(f"Camera.{k}: {float(v)}\n" for k, v in KITTI_SYNTH_CAM.items()))
    (t, j), (st, sj), out = run_both(capsys, tmp_path, [str(root), "--mono", "--cpu"])
    assert out.count("[track]") >= len(frames) - 2 and "frame 0: [init]" in out
    assert t.shape == j.shape == (len(frames), 12)
    assert np.abs(t - j).max() <= KITTI_TREE_TOL
    assert st["initialized"] and set(st) == set(sj)
    assert abs(st["ego_ate_sim3_rmse_m"] - sj["ego_ate_sim3_rmse_m"]) <= KITTI_TREE_TOL


def test_cli_euroc_matches_jax(tmp_path, capsys, euroc_tree, frames):
    (t, j), (st, sj), out = run_both(capsys, tmp_path, [str(euroc_tree), "--euroc", "--cpu"])
    assert t.shape == j.shape == (len(frames), 12)
    assert np.abs(t - j).max() <= TRAJ_TOL
    assert st["initialized"] and set(st) == set(sj) == {"n_frames", "initialized",
                                                        "ego_ate_sim3_rmse_m"}
    assert abs(st["ego_ate_sim3_rmse_m"] - sj["ego_ate_sim3_rmse_m"]) <= TRAJ_TOL


def test_cli_tum_mono_runs(tmp_path, capsys, frames):
    root = write_tum_tree(tmp_path / "rgbd_dataset_freiburg1_synth", frames[:3],
                          bf=KITTI_SYNTH_CAM["bf"])
    assert cli.main([str(root), "--tum", "--mono", "--cpu", "--out", str(tmp_path / "o")]) == 0
    out = capsys.readouterr().out
    assert out.count("frame ") == 3 and summary_of(out)["n_frames"] == 3
    assert np.loadtxt(tmp_path / "o" / "mono_trajectory.txt").shape == (3, 12)


def test_mono_modules_run_without_jax(tmp_path, euroc_tree):
    code = (
        "import sys, pathlib\n"
        "for m in ('jax', 'jaxlib', 'PIL', 'yaml'):\n"
        "    sys.modules[m] = None\n"
        "import torch; torch.set_num_threads(1)\n"
        "from multimot_track_tpu_torch import cli\n"
        "from multimot_track_tpu_torch.io import euroc\n"
        "from multimot_track_tpu_torch.pipeline import mono\n"
        "from multimot_track_tpu_torch.solvers import initializer\n"
        "assert cli.main([sys.argv[1], '--euroc', '--cpu', '--frames', '2',\n"
        "                 '--out', sys.argv[2]]) == 0\n"
        "bad = [m for m in ('jax', 'PIL', 'yaml', 'multimot_track_tpu')\n"
        "       if sys.modules.get(m) is not None]\n"
        "print('loaded', bad)\n"
    )
    env = dict(os.environ)
    env["PYTHONPATH"] = REPO + os.pathsep + env.get("PYTHONPATH", "")
    out = subprocess.run([sys.executable, "-c", code, str(euroc_tree), str(tmp_path / "o")],
                         capture_output=True, text=True, env=env, timeout=300)
    assert out.returncode == 0, out.stderr[-3000:]
    assert out.stdout.strip().splitlines()[-1] == "loaded []"
    assert np.loadtxt(tmp_path / "o" / "mono_trajectory.txt").shape == (2, 12)


def test_mono_cli_needs_a_card_without_cpu(euroc_tree):
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device is usable")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        cli.main([str(euroc_tree), "--euroc", "--frames", "1"])
