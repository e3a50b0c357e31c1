"""The port's PIL-free renderer against the JAX package's PIL drawings (CPU).

Each ``draw_*`` runs in both packages on the same seeded inputs; the JAX
package's PIL image is the yardstick.  Outside the text boxes (PIL's
default font there, the port's 5x7 bitmap font here) every pixel where
the two images differ must lie within one pixel (8-neighbourhood) of a
pixel that both drew alike: the rasterisers may place an edge pixel one
step apart, never more.  The text must be drawn in the label's colour
inside its box.  Then the PNG round trip through ``io/png``, and the
port's CLI with ``--cpu --viz --out`` on a 3-frame KITTI tree.
"""

import numpy as np
import pytest
from PIL import Image, ImageDraw
from scipy.ndimage import binary_dilation

from multimot_track_tpu.viz import render as jrender
from multimot_track_tpu_torch import cli
from multimot_track_tpu_torch.io.png import read_png
from multimot_track_tpu_torch.io.synth import SYNTH_CAM, make_multimover_frames, write_kitti_tree
from multimot_track_tpu_torch.viz import render as trender


def _far_pixels(a, b, base, boxes=()):
    """Pixels where ``a`` and ``b`` differ, outside ``boxes``, and not next
    to a pixel both changed from ``base`` alike; and the two drawn counts."""
    a, b = np.asarray(a), np.asarray(b)
    diff = (a != b).any(-1)
    both = (a != base).any(-1) & (b != base).any(-1) & ~diff
    keep = np.ones_like(diff)
    for x0, y0, x1, y1 in boxes:
        keep[max(y0, 0):y1 + 1, max(x0, 0):x1 + 1] = False
    far = diff & keep & ~binary_dilation(both, np.ones((3, 3), bool))
    return np.argwhere(far), int((a != base).any(-1).sum()), int((b != base).any(-1).sum())


@pytest.fixture(scope="module")
def scene():
    rng = np.random.default_rng(0)
    gray = rng.uniform(0, 255, (120, 200)).astype(np.float32)
    n = 60
    uv = np.stack([rng.uniform(-5, 205, n), rng.uniform(-5, 125, n)], -1)
    return dict(gray=gray, base=np.repeat(np.clip(gray, 0, 255).astype(np.uint8)[..., None], 3, -1),
                uv=uv, valid=rng.random(n) < 0.8, flow=rng.normal(0, 8, (n, 2)), rng=rng)


@pytest.mark.parametrize("with_flow", [False, True])
def test_draw_features_matches_pil(scene, with_flow):
    flow = scene["flow"] if with_flow else None
    a = jrender.draw_features(scene["gray"], scene["uv"], scene["valid"], flow)
    b = trender.draw_features(scene["gray"], scene["uv"], scene["valid"], flow)
    assert b.shape == (120, 200, 3) and b.dtype == np.uint8
    far, na, nb = _far_pixels(a, b, scene["base"])
    assert len(far) == 0, far
    assert abs(na - nb) <= 0.1 * na


def test_draw_objects_matches_pil_outside_text(scene):
    bbs = [np.array([10.3, 20.7, 60.2, 50.9]), np.array([100, 5, 190, 110]),
           np.array([150.5, 60, 198, 119])]
    labs, speeds = [1, 5, 12], [42.5, -3.25, 120.0]
    a = jrender.draw_objects(scene["gray"], bbs, labs, speeds)
    b = trender.draw_objects(scene["gray"], bbs, labs, speeds)
    probe = ImageDraw.Draw(Image.new("RGB", (1, 1)))
    boxes = []
    for bb, lab, sp in zip(bbs, labs, speeds):
        txt = f"#{lab} {sp:.1f} km/h"
        x, y = float(bb[0]), max(float(bb[1]) - 12, 0)
        pil_box = tuple(int(v) for v in probe.textbbox((x, y), txt))
        box = trender.text_box(x, y, txt)
        boxes += [pil_box, box]
        colour = trender._COLORS[lab % len(trender._COLORS)]
        x0, y0, x1, y1 = box
        assert (b[y0:y1 + 1, x0:min(x1, 199) + 1] == colour).all(-1).sum() >= 3 * len(txt)
    far, na, nb = _far_pixels(a, b, scene["base"], boxes)
    assert len(far) == 0, far


def test_draw_trajectory_matches_pil():
    poses = []
    for i in range(40):
        T = np.eye(4)
        th = i * 0.08
        T[0, 3], T[2, 3] = 20 * np.sin(th), 20 * (1 - np.cos(th)) + i * 0.5
        poses.append(T)
    centres = [(np.array([3.0, 0, 10]), 1), (np.array([-10.0, 0, 30]), 2),
               (np.array([40.0, 0, -5]), 3)]
    a = jrender.draw_trajectory(poses, centres)
    b = trender.draw_trajectory(poses, centres)
    far, na, nb = _far_pixels(a, b, np.full((800, 800, 3), 255, np.uint8))
    assert len(far) == 0, far
    assert abs(na - nb) <= 0.1 * na


def test_draw_birdeye_flow_matches_pil(scene):
    rng = np.random.default_rng(4)
    pts = np.stack([rng.normal(0, 8, 80), rng.normal(0, 1, 80), rng.uniform(0, 30, 80)], -1)
    vel = rng.normal(0, 1, (80, 3))
    valid = rng.random(80) < 0.9
    a = jrender.draw_birdeye_flow(pts, vel, valid)
    b = trender.draw_birdeye_flow(pts, vel, valid)
    far, na, nb = _far_pixels(a, b, np.zeros((600, 600, 3), np.uint8))
    assert len(far) == 0, far


def test_png_round_trip(scene, tmp_path):
    """``path=`` writes the returned image; ``io/png`` and PIL read it back
    unchanged."""
    img = trender.draw_features(scene["gray"], scene["uv"], scene["valid"], scene["flow"],
                                path=tmp_path / "feat.png")
    np.testing.assert_array_equal(read_png(tmp_path / "feat.png"), img)
    np.testing.assert_array_equal(np.asarray(Image.open(tmp_path / "feat.png")), img)
    traj = trender.draw_trajectory([np.eye(4)] * 2, path=tmp_path / "traj.png")
    np.testing.assert_array_equal(read_png(tmp_path / "traj.png"), traj)


def test_cli_viz_writes_images(tmp_path):
    frames = make_multimover_frames(n_frames=3)
    root = write_kitti_tree(tmp_path / "seq", frames)
    (root / "kitti03.yaml").write_text(
        "%YAML:1.0\n" + "".join(f"Camera.{k}: {float(v)}\n" for k, v in SYNTH_CAM.items()))
    out = tmp_path / "out"
    assert cli.main([str(root), "--cpu", "--viz", "--out", str(out), "--no-loop-closing"]) == 0
    names = sorted(p.name for p in out.glob("speed_*.png"))
    assert names == ["speed_000001.png", "speed_000002.png"], names
    for n in names:
        img = read_png(out / n)
        assert img.shape == (SYNTH_CAM["height"], SYNTH_CAM["width"], 3)
    traj = read_png(out / "traj.png")
    assert traj.shape == (800, 800, 3) and (traj[..., 2] > traj[..., 0]).any()
