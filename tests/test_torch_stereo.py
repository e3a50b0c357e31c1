"""Stereo disparity, LK flow, the quad gate and the stereo reader: the
PyTorch port against the JAX package (CPU).

Tolerances, with their reasons:
* ``dense_disparity`` on 8-bit input: identical, bit for bit.  Every SAD
  cost is an integer below 2**24, exact in float32 in any summation order,
  and the sub-pixel parabola reads the same bfloat16-rounded costs, so the
  division is the only rounding and it rounds alike.  On float input (the
  two-region pair before rounding) the costs are float sums in another
  order: the integer disparities and the valid set are identical there,
  the sub-pixel value within 1e-2 px (measured 1.5e-3);
* ``keypoint_disparity``: identical on 8-bit input;
* ``dense_flow``: float32 box sums in another order (torch's cumulative
  sum against XLA's associative scan) carried through 5 levels x 8 LK
  iterations.  Median |d flow| <= 5e-4 px and the 99.9th percentile
  <= 2e-2 px (measured at 640 x 384: 3e-5 and 4e-3 on 8-bit gray, 2.2e-4
  and 1.1e-2 on the gray of an RGB frame); the update is clipped at +-1 px
  a step, so a pixel whose 2x2 system sits at the determinant gate (weak
  texture) can end a whole step apart: at most 0.1 % of pixels beyond
  0.05 px;
* ``quad_temporal_matches`` given the same disparity and flow: identical
  keypoints, matches and valid flags;
* ``StereoKittiSequence`` with the quad gate: identical depth, the same
  number of quad matches, flow within the dense-flow bounds.
"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from PIL import Image

from multimot_track_tpu.frontend import optical_flow as jflow
from multimot_track_tpu.frontend import stereo as jstereo
from multimot_track_tpu.io.stereo_seq import StereoKittiSequence as JStereoSeq
from multimot_track_tpu_torch.frontend import optical_flow as tflow
from multimot_track_tpu_torch.frontend import stereo as tstereo
from multimot_track_tpu_torch.io import kitti as tkitti
from multimot_track_tpu_torch.io.stereo_seq import StereoKittiSequence as TStereoSeq
from multimot_track_tpu_torch.io.synth import write_stereo_tree

torch.set_num_threads(1)

T = torch.from_numpy


def flow_ok(ft, fj):
    e = np.abs(ft - fj).max(-1)
    assert np.median(e) <= 5e-4, np.median(e)
    assert np.percentile(e, 99.9) <= 2e-2, np.percentile(e, 99.9)
    assert (e > 0.05).mean() <= 1e-3, (e > 0.05).mean()


@pytest.fixture(scope="module")
def pair(H=96, W=256, d_left=6, d_right=12):
    """tests/test_stereo.py's two-region pair (the same recipe and seed, on
    a generator of its own): the right image is the left one shifted by 6
    px on its left half and 12 px on its right half."""
    rng = np.random.default_rng(17)
    left = rng.uniform(0, 255, (H, W)).astype(np.float32)
    k = np.ones(3) / 3
    for ax in (0, 1):
        left = np.apply_along_axis(lambda v: np.convolve(v, k, "same"), ax, left)
    right = np.zeros_like(left)
    mid = W // 2
    right[:, :mid] = np.roll(left, -d_left, axis=1)[:, :mid]
    right[:, mid:] = np.roll(left, -d_right, axis=1)[:, mid:]
    return left.astype(np.float32), right.astype(np.float32)


@pytest.mark.parametrize("eight_bit", [True, False])
def test_dense_disparity_matches_jax_on_two_regions(pair, eight_bit):
    left, right = (np.round(a) if eight_bit else a for a in pair)
    dj = np.asarray(jstereo.dense_disparity(jnp.asarray(left), jnp.asarray(right),
                                            max_disp=32))
    dt = tstereo.dense_disparity(T(left), T(right), max_disp=32).numpy()
    assert (dt > 0).mean() > 0.5
    if eight_bit:
        np.testing.assert_array_equal(dt, dj)
    else:
        np.testing.assert_array_equal(dt > 0, dj > 0)
        np.testing.assert_array_equal(np.floor(dt), np.floor(dj))
        np.testing.assert_allclose(dt, dj, atol=1e-2)


@pytest.mark.parametrize("chunk", [7, 16, 128])
def test_dense_disparity_chunks_agree(pair, chunk, monkeypatch):
    """The disparity blocks reduce to the scan's state whatever their size."""
    left, right = (np.round(a) for a in pair)
    monkeypatch.setattr(tstereo, "CHUNK", 32)
    ref = tstereo.dense_disparity(T(left), T(right), max_disp=32).numpy()
    monkeypatch.setattr(tstereo, "CHUNK", chunk)
    out = tstereo.dense_disparity(T(left), T(right), max_disp=32).numpy()
    np.testing.assert_array_equal(out, ref)


def test_box_filter_matches_jax(pair):
    a = np.round(pair[0])
    for r in (1, 4):
        np.testing.assert_array_equal(
            tstereo._box_filter(T(a), r).numpy(), np.asarray(jstereo._box_filter(jnp.asarray(a), r)))


@pytest.fixture(scope="module")
def stereo_tree(tmp_path_factory):
    """A 3-frame synthetic stereo sequence at the 640 x 384 test camera."""
    return write_stereo_tree(tmp_path_factory.mktemp("stereo"), n_frames=3)


def read_gray(path):
    return np.asarray(Image.open(path), np.float32)


def test_dense_disparity_matches_jax_on_stereo_tree(stereo_tree):
    L = read_gray(stereo_tree / "image_2" / "000001.png")
    R = read_gray(stereo_tree / "image_3" / "000001.png")
    dj = np.asarray(jstereo.dense_disparity(jnp.asarray(L), jnp.asarray(R)))
    dt = tstereo.dense_disparity(T(L), T(R)).numpy()
    assert (dt > 0).mean() > 0.8
    np.testing.assert_array_equal(dt, dj)
    raw = tstereo.disparity_to_depth_raw(T(dt)).numpy()
    np.testing.assert_array_equal(raw, np.asarray(jstereo.disparity_to_depth_raw(jnp.asarray(dj))))


def test_keypoint_disparity_matches_jax(pair):
    left, right = (np.round(a) for a in pair)
    uv = np.asarray([[60.0, 40.0], [200.0, 50.0], [3.0, 4.0], [255.0, 95.0], [130.4, 47.6]],
                    np.float32)
    dj, okj = jstereo.keypoint_disparity(jnp.asarray(left), jnp.asarray(right),
                                         jnp.asarray(uv), max_disp=32)
    dt, okt = tstereo.keypoint_disparity(T(left), T(right), T(uv), max_disp=32)
    np.testing.assert_array_equal(dt.numpy(), np.asarray(dj))
    np.testing.assert_array_equal(okt.numpy(), np.asarray(okj))
    assert okt[:2].all() and abs(float(dt[0]) - 6) < 1 and abs(float(dt[1]) - 12) < 1


def test_disparity_to_depth_raw():
    d = np.asarray([[4.0, 0.0, -1.0, 0.25]], np.float32)
    np.testing.assert_array_equal(tstereo.disparity_to_depth_raw(T(d)).numpy(),
                                  np.asarray(jstereo.disparity_to_depth_raw(jnp.asarray(d))))
    assert tstereo.disparity_to_depth_raw(T(d)).numpy().tolist() == [[1024.0, 0, 0, 64.0]]


def smooth_noise(rng, H, W, blur=4):
    img = rng.uniform(0, 255, (H, W))
    k = np.ones(blur) / blur
    for ax in (0, 1):
        img = np.apply_along_axis(lambda v: np.convolve(v, k, "same"), ax, img)
    return img.astype(np.float32)


@pytest.mark.parametrize("levels", [5, 3])
def test_dense_flow_matches_jax(levels):
    rng = np.random.default_rng(41)
    img0 = smooth_noise(rng, 96, 320)
    img1 = np.roll(img0, (1, 3), (0, 1))
    img1[:, 160:] = np.roll(img0, (0, -2), (0, 1))[:, 160:]
    fj = np.asarray(jflow.dense_flow(jnp.asarray(img0), jnp.asarray(img1), n_levels=levels))
    ft = tflow.dense_flow(T(img0), T(img1), n_levels=levels).numpy()
    assert ft.shape == (96, 320, 2) and ft.dtype == np.float32
    flow_ok(ft, fj)
    # it tracks: the left half moves (3, 1), the right half (-2, 0)
    assert abs(np.median(ft[20:-20, 40:120, 0]) - 3) < 0.3
    assert abs(np.median(ft[20:-20, 200:280, 0]) + 2) < 0.3


def test_dense_flow_matches_jax_on_stereo_tree(stereo_tree):
    a = read_gray(stereo_tree / "image_2" / "000000.png")
    b = read_gray(stereo_tree / "image_2" / "000001.png")
    flow_ok(tflow.dense_flow(T(a), T(b)).numpy(),
            np.asarray(jflow.dense_flow(jnp.asarray(a), jnp.asarray(b))))


@pytest.fixture(scope="module")
def quad_views(tmp_path_factory):
    """tests/test_quad_stereo.py's fixture: two stereo pairs of one texture
    under a known image shift, disparity from the JAX package."""
    from test_quad_stereo import H, SHIFT, W, _texture

    base = _texture()
    views = []
    for i in range(2):
        ox, oy = SHIFT[0] * i, SHIFT[1] * i
        views.append(np.round(base[oy:oy + H, ox:ox + W]).astype(np.float32))
        views.append(np.round(base[oy:oy + H, ox + 8:ox + W + 8]).astype(np.float32))
    L0, R0, L1, R1 = views
    disp = [np.asarray(jstereo.dense_disparity(jnp.asarray(a), jnp.asarray(b), max_disp=32))
            for a, b in ((L0, R0), (L1, R1))]
    flow = np.zeros((H, W, 2), np.float32)
    flow[..., 0], flow[..., 1] = -SHIFT[0], -SHIFT[1]
    return L0, R0, L1, R1, disp[0], disp[1], flow


def test_quad_temporal_matches_identical(quad_views):
    from test_quad_stereo import SHIFT

    uj, vj, okj = (np.asarray(x) for x in jstereo.quad_temporal_matches(
        *(jnp.asarray(a) for a in quad_views)))
    ut, vt, okt = (x.numpy() for x in tstereo.quad_temporal_matches(
        *(T(a.copy()) for a in quad_views)))
    np.testing.assert_array_equal(okt, okj)
    np.testing.assert_array_equal(ut, uj)
    np.testing.assert_array_equal(vt[okt], vj[okj])
    assert okt.sum() >= 50
    d = (vt - ut)[okt]
    assert np.median(np.abs(d - [-SHIFT[0], -SHIFT[1]]), axis=0).max() < 1.0


def test_stereo_sequence_with_quad_gate_matches_jax(stereo_tree):
    t = TStereoSeq(stereo_tree, quad_gate=True, device="cpu")
    j = JStereoSeq(stereo_tree, quad_gate=True)
    assert len(t) == len(j) == 3
    for i in range(3):
        ft, fj = t.load_frame(i), j.load_frame(i)
        np.testing.assert_array_equal(ft.gray, fj.gray)
        np.testing.assert_array_equal(ft.depth_raw, fj.depth_raw)
        np.testing.assert_array_equal(ft.sem_mask, fj.sem_mask)
        np.testing.assert_array_equal(ft.pose_gt, fj.pose_gt)
        assert ft.timestamp == fj.timestamp
        flow_ok(ft.flow, fj.flow)
        assert t.n_quad_matched == j.n_quad_matched
    assert t.n_quad_matched > 0 and t.n_flow_estimated == j.n_flow_estimated == 2


def test_kitti_sequence_estimates_missing_flow_like_jax(tmp_path):
    """A KITTI tree without flow/: the port's reader estimates the flow
    with its dense_flow on its device, as the JAX reader does."""
    from multimot_track_tpu.io.kitti import KittiSequence as JKitti
    from multimot_track_tpu_torch.io.synth import make_multimover_frames, write_kitti_tree

    root = write_kitti_tree(tmp_path / "noflow", make_multimover_frames(n_frames=2), flow=False)
    t, j = tkitti.KittiSequence(root, device="cpu"), JKitti(root)
    ft, fj = t.load_frame(0), j.load_frame(0)
    flow_ok(ft.flow, fj.flow)
    assert t.n_flow_estimated == j.n_flow_estimated == 1
    assert np.abs(ft.flow).max() > 1.0
    # the last frame has no successor: zeros, as in the JAX reader
    np.testing.assert_array_equal(t.load_frame(1).flow, j.load_frame(1).flow)
    assert dataclasses.asdict(ft).keys() == dataclasses.asdict(fj).keys()
