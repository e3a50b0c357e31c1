"""The port's entry points (CPU): the CLI, the socket server, and the
sequence modules running without jax, PIL or PyYAML.

* ``cli.main([..., "--cpu", "--frames", "3"])`` in RGB-D mode (a KITTI
  tree with a kitti03.yaml, read by the native loader), ``--stereo
  --quad-stereo --discover-objects`` (tests/test_cli.py's images-only
  stereo tree) and ``--tum``: exit 0, the per-frame lines, and the JAX
  CLI's summary keys (plus ``n_quad_matched`` under the quad gate);
* ``--viz`` raises, naming its ROADMAP item; ``--mono`` and ``--euroc``
  run and write their trajectory (tests/test_torch_entry_mono.py holds
  them to the JAX CLI);
* a subprocess with ``jax``, ``PIL`` and ``yaml`` blocked in
  ``sys.modules`` imports every module of the port and drives the CLI.

The JAX package's summary keys come from its ``MultiMotSystem.summary``.
The socket server is tested in tests/test_torch_stream.py, the whole-path
parity of the stereo reader under ``run_sequence`` in
tests/test_torch_entry_live.py.
"""

import json
import os
import subprocess
import sys

import numpy as np
import pytest
import torch
from PIL import Image

from multimot_track_tpu import config as jconfig
from multimot_track_tpu.pipeline.system import MultiMotSystem as JSystem
from multimot_track_tpu_torch import cli
from multimot_track_tpu_torch.io.synth import (
    SYNTH_CAM, make_multimover_frames, write_euroc_tree, write_kitti_tree, write_tum_tree)

torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(scope="module")
def jax_summary_keys():
    return set(JSystem(jconfig.DEFAULT_CONFIG).summary())


@pytest.fixture(scope="module")
def frames():
    return make_multimover_frames(n_frames=4)


def kitti03_yaml(cam) -> str:
    return "%YAML:1.0\n" + "".join(f"Camera.{k}: {float(v)}\n" for k, v in cam.items())


def run_cli(capsys, argv):
    assert cli.main(argv) == 0
    out = capsys.readouterr().out
    return out, json.loads(out.split("summary:", 1)[1].split("\ntraj.png", 1)[0])


def test_cli_rgbd(tmp_path, capsys, frames, jax_summary_keys):
    root = write_kitti_tree(tmp_path / "seq", frames[:3])
    (root / "kitti03.yaml").write_text(kitti03_yaml(SYNTH_CAM))
    out_dir = tmp_path / "out"
    out, s = run_cli(capsys, [str(root), "--cpu", "--frames", "3", "--out", str(out_dir)])
    assert out.count("cam RPE") == 2 and "obj label=" in out
    assert set(s) == jax_summary_keys and s["n_frames"] == 3
    assert s["cam_t_rpe_rel_mean"] < 0.05 and s["ego_ate_rmse_m"] < 0.1
    assert "traj.png not written" in out and "ROADMAP item 23" in out
    assert (out_dir / "camera_pose.txt").exists() and (out_dir / "object_motion.txt").exists()
    assert not (out_dir / "traj.png").exists()


STEREO_CAM = dict(fx=300.0, fy=300.0, cx=160.0, cy=48.0, bf=120.0, width=320, height=96)


def test_cli_stereo_quad_discover(tmp_path, capsys, jax_summary_keys):
    """tests/test_cli.py's images-only stereo tree (no depth/, flow/ or
    semantic/): disparity and flow estimated, objects discovered.  Its
    kitti03.yaml gives a camera of the images' size (the port decodes the
    wire images at the configured size, and the CLI refuses a mismatch)."""
    rng = np.random.default_rng(0)
    H, W = 96, 320
    (tmp_path / "image_2").mkdir()
    (tmp_path / "image_3").mkdir()
    base = rng.uniform(0, 255, (H, W)).astype(np.float32)
    k = np.ones(3) / 3
    for ax in (0, 1):
        base = np.apply_along_axis(lambda v: np.convolve(v, k, "same"), ax, base)
    for i in range(3):
        left = np.roll(base, 2 * i, axis=1).astype(np.uint8)   # ego slide
        right = np.roll(left, -8, axis=1)
        Image.fromarray(left).save(tmp_path / "image_2" / f"{i:06d}.png")
        Image.fromarray(right).save(tmp_path / "image_3" / f"{i:06d}.png")
    args = [str(tmp_path), "--cpu", "--stereo", "--discover-objects", "--quad-stereo",
            "--frames", "3"]
    with pytest.raises(ValueError, match="320x96 but the camera config is 1242x375"):
        cli.main(args)
    (tmp_path / "kitti03.yaml").write_text(kitti03_yaml(STEREO_CAM))
    out, s = run_cli(capsys, args)
    assert set(s) == jax_summary_keys | {"n_quad_matched"}
    assert s["n_frames"] == 3 and s["n_quad_matched"] > 0, s


def test_cli_tum(tmp_path, capsys, frames, jax_summary_keys):
    root = write_tum_tree(tmp_path / "rgbd_dataset_freiburg1_synth", frames[:3],
                          bf=SYNTH_CAM["bf"])
    out, s = run_cli(capsys, [str(root), "--cpu", "--tum", "--frames", "3",
                              "--no-loop-closing"])
    assert out.count("cam RPE") == 2
    assert set(s) == jax_summary_keys and s["n_frames"] == 3
    assert np.isfinite(s["ego_ate_rmse_m"])


@pytest.mark.parametrize("flag,item", [("--mono", "item 19"), ("--euroc", "item 19"),
                                       ("--viz", "item 23")])
def test_cli_refuses_unported_modes(tmp_path, frames, flag, item):
    """``--viz`` (ROADMAP item 23) is refused.  The monocular modes of item
    19 are ported: ``--mono`` over a KITTI tree and ``--euroc`` over an
    EuRoC tree run on the CPU and write ``mono_trajectory.txt``
    (tests/test_torch_entry_mono.py holds them to the JAX CLI)."""
    if flag == "--viz":
        with pytest.raises(NotImplementedError, match=item):
            cli.main([str(tmp_path), "--cpu", flag])
        return
    if flag == "--mono":
        root = write_kitti_tree(tmp_path / "seq", frames[:2], flow=False)
        (root / "kitti03.yaml").write_text(kitti03_yaml(SYNTH_CAM))
    else:
        root = write_euroc_tree(tmp_path / "seq", frames[:2], SYNTH_CAM)
    assert cli.main([str(root), "--cpu", flag, "--out", str(tmp_path / "out")]) == 0
    assert np.loadtxt(tmp_path / "out" / "mono_trajectory.txt").shape == (2, 12)


def test_cli_needs_a_card_without_cpu(tmp_path, frames):
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device is usable")
    root = write_kitti_tree(tmp_path / "seq", frames[:2])
    with pytest.raises(RuntimeError, match="--cpu"):
        cli.main([str(root), "--frames", "2"])


def test_entry_points_run_without_jax_pil_or_yaml(tmp_path):
    """Every module of the port imports, and the stereo CLI, the PNG and
    YAML readers run, with jax, PIL and yaml unimportable."""
    code = (
        "import sys, pkgutil, importlib, pathlib, numpy as np\n"
        "for m in ('jax', 'jaxlib', 'PIL', 'yaml'):\n"
        "    sys.modules[m] = None\n"
        "import torch; torch.set_num_threads(1)\n"
        "import multimot_track_tpu_torch as P\n"
        "names = [m.name for m in pkgutil.walk_packages(P.__path__, P.__name__ + '.')]\n"
        "for n in names:\n"
        "    importlib.import_module(n)\n"
        "from multimot_track_tpu_torch import cli\n"
        "from multimot_track_tpu_torch.io import png, yamlcfg\n"
        "from multimot_track_tpu_torch.io.synth import write_stereo_tree\n"
        "root = pathlib.Path(sys.argv[1])\n"
        "(root / 'kitti03.yaml').write_text('%YAML:1.0\\nCamera.width: 320\\n'\n"
        "                                   'Camera.height: 96 # rows\\n')\n"
        "assert yamlcfg.load_opencv_yaml(root / 'kitti03.yaml') == {'Camera.width': 320,\n"
        "                                                            'Camera.height': 96}\n"
        "rng = np.random.default_rng(0)\n"
        "base = np.round(rng.uniform(0, 255, (96, 320))).astype(np.uint8)\n"
        "for d in ('image_2', 'image_3'):\n"
        "    (root / d).mkdir()\n"
        "for i in range(2):\n"
        "    png.write_png(root / 'image_2' / f'{i:06d}.png', np.roll(base, 2 * i, 1))\n"
        "    png.write_png(root / 'image_3' / f'{i:06d}.png', np.roll(base, 2 * i - 8, 1))\n"
        "assert cli.main([str(root), '--cpu', '--stereo', '--quad-stereo', '--frames', '2',\n"
        "                 '--no-keyframes']) == 0\n"
        "bad = [m for m in ('jax', 'PIL', 'yaml', 'multimot_track_tpu')\n"
        "       if sys.modules.get(m) is not None]\n"
        "print('imported', len(names), 'modules; loaded', bad)\n"
    )
    env = dict(os.environ)
    env["PYTHONPATH"] = REPO + os.pathsep + env.get("PYTHONPATH", "")
    out = subprocess.run([sys.executable, "-c", code, str(tmp_path)], capture_output=True,
                         text=True, env=env, timeout=300)
    assert out.returncode == 0, out.stderr[-3000:]
    last = out.stdout.strip().splitlines()[-1]
    assert last.endswith("loaded []"), last
    assert int(last.split()[1]) >= 50, last
