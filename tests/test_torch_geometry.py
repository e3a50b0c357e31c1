"""Parity of the PyTorch port's geometry, wire codec, metrics and copied
host code with the JAX package (CPU).

Tolerances: geometry rtol 1e-5 (float32 with the same formulas, sums of
three terms in another order); the wire codec and the copied config and
synthetic scenes are exact.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from multimot_track_tpu import config as jconfig
from multimot_track_tpu.eval import metrics as jmetrics
from multimot_track_tpu.geometry import camera as jcamera
from multimot_track_tpu.geometry import se3 as jse3
from multimot_track_tpu.geometry import smallsolve as jsmall
from multimot_track_tpu.io import synth as jsynth
from multimot_track_tpu.ops import wire as jwire
from multimot_track_tpu_torch import config as tconfig
from multimot_track_tpu_torch.eval import metrics as tmetrics
from multimot_track_tpu_torch.geometry import camera as tcamera
from multimot_track_tpu_torch.geometry import se3 as tse3
from multimot_track_tpu_torch.geometry import smallsolve as tsmall
from multimot_track_tpu_torch.io import synth as tsynth
from multimot_track_tpu_torch.ops import resize as tresize
from multimot_track_tpu_torch.ops import wire as twire

torch.set_num_threads(1)

RTOL, ATOL = 1e-5, 1e-6


def _t(a):
    return torch.from_numpy(np.array(a))


def _xi(seed, n, scale=0.3):
    return np.random.default_rng(seed).normal(0, scale, (n, 6)).astype(np.float32)


@pytest.mark.parametrize("scale", [1e-7, 0.05, 1.0])
def test_exp_log_se3_match(scale):
    xi = _xi(0, 64, scale)
    Tj = np.asarray(jse3.exp_se3(jnp.asarray(xi)))
    Tt = tse3.exp_se3(_t(xi)).numpy()
    np.testing.assert_allclose(Tt, Tj, rtol=RTOL, atol=ATOL)
    np.testing.assert_allclose(tse3.log_se3(_t(Tj)).numpy(),
                               np.asarray(jse3.log_se3(jnp.asarray(Tj))),
                               rtol=RTOL, atol=1e-5)


def test_inverse_transform_rotation_angle_match():
    T = np.asarray(jse3.exp_se3(jnp.asarray(_xi(1, 8))))
    pts = np.random.default_rng(2).normal(0, 5, (8, 100, 3)).astype(np.float32)
    np.testing.assert_allclose(tse3.inverse(_t(T)).numpy(), np.asarray(jse3.inverse(jnp.asarray(T))),
                               rtol=RTOL, atol=ATOL)
    np.testing.assert_allclose(
        tse3.transform(_t(T), _t(pts)).numpy(),
        np.asarray(jse3.transform_points(jnp.asarray(T), jnp.asarray(pts))),
        rtol=RTOL, atol=1e-5)
    np.testing.assert_allclose(
        tse3.rotation_angle_deg(_t(T[:, :3, :3])).numpy(),
        np.asarray(jse3.rotation_angle_deg(jnp.asarray(T[:, :3, :3]))), rtol=1e-4, atol=1e-3)


def test_camera_project_backproject_and_depth_match():
    rng = np.random.default_rng(3)
    uv = rng.uniform(0, 600, (5, 50, 2)).astype(np.float32)
    d = rng.uniform(1, 40, (5, 50)).astype(np.float32)
    c = (460.0, 470.0, 320.0, 192.0)
    Xj = np.asarray(jcamera.backproject(jnp.asarray(uv), jnp.asarray(d), *c))
    np.testing.assert_allclose(tcamera.backproject(_t(uv), _t(d), *c).numpy(), Xj,
                               rtol=RTOL, atol=ATOL)
    np.testing.assert_allclose(tcamera.project(_t(Xj), *c).numpy(),
                               np.asarray(jcamera.project(jnp.asarray(Xj), *c)),
                               rtol=RTOL, atol=1e-4)
    raw = rng.integers(0, 65535, (4, 7)).astype(np.float32)
    raw[0, 0] = 0.0
    np.testing.assert_allclose(tcamera.disparity_png_to_depth(_t(raw), 138.0).numpy(),
                               np.asarray(jcamera.disparity_png_to_depth(jnp.asarray(raw), 138.0)),
                               rtol=RTOL)


def test_nearest_sample_rounds_half_to_even_like_jax():
    img = np.arange(30 * 40, dtype=np.float32).reshape(30, 40)
    uv = np.array([[0.5, 0.5], [1.5, 2.5], [2.5, 3.5], [39.5, 10.0], [-0.4, 3.0],
                   [10.49, 20.51], [38.5, 28.5], [40.2, 5.0]], np.float32)
    vj, inbj = jcamera.nearest_sample(jnp.asarray(img), jnp.asarray(uv))
    vt, inbt = tcamera.nearest_sample(_t(img)[None], _t(uv)[None])
    np.testing.assert_array_equal(vt[0].numpy(), np.asarray(vj))
    np.testing.assert_array_equal(inbt[0].numpy(), np.asarray(inbj))


def test_solve_spd6_matches():
    rng = np.random.default_rng(4)
    A = rng.normal(0, 1, (16, 6, 6)).astype(np.float32)
    H = A @ A.transpose(0, 2, 1) + 0.5 * np.eye(6, dtype=np.float32)
    g = rng.normal(0, 1, (16, 6)).astype(np.float32)
    np.testing.assert_allclose(tsmall.solve_spd6(_t(H), _t(g)).numpy(),
                               np.asarray(jsmall.solve_spd6(jnp.asarray(H), jnp.asarray(g))),
                               rtol=1e-4, atol=1e-4)


def test_wire_codec_exact():
    rng = np.random.default_rng(5)
    flow = rng.normal(0, 20, (24, 37, 2)).astype(np.float32)
    raw = rng.integers(0, 65536, (24, 37)).astype(np.uint16)
    sem = rng.integers(0, 16, (24, 37))
    pf, pd, ps = jwire.pack_flow12(flow), jwire.pack_depth12(raw), jwire.pack_sem4(sem)
    np.testing.assert_array_equal(twire.pack_flow12(flow), pf)
    np.testing.assert_array_equal(twire.pack_depth12(raw), pd)
    np.testing.assert_array_equal(twire.pack_sem4(sem), ps)
    np.testing.assert_array_equal(twire.pack_flow12_half(flow), jwire.pack_flow12_half(flow))
    np.testing.assert_array_equal(twire._decode_flow(_t(pf), 24, 37).numpy(),
                                  np.asarray(jwire._decode_flow(jnp.asarray(pf), 24, 37)))
    np.testing.assert_array_equal(twire._decode_depth(_t(pd), 37).numpy(),
                                  np.asarray(jwire._decode_depth(jnp.asarray(pd), 37)))
    np.testing.assert_array_equal(twire._decode_sem(_t(ps), 37).numpy(),
                                  np.asarray(jwire._decode_sem(jnp.asarray(ps), 37)))
    i16 = (flow * 128).astype(np.int16)
    np.testing.assert_array_equal(twire._decode_flow(_t(i16)).numpy(),
                                  np.asarray(jwire._decode_flow(jnp.asarray(i16))))


def test_half_flow_and_pyramid_resize_match_jax_image_resize():
    """Within float32 rounding of the contraction; torch's own antialiased
    interpolate is off by up to ~7e-3 grey levels at pyramid level 1."""
    rng = np.random.default_rng(6)
    flow = rng.normal(0, 5, (40, 66, 2)).astype(np.float32)
    half = jwire.pack_flow12_half(flow)
    np.testing.assert_allclose(
        twire._decode_flow(_t(half), 40, 66).numpy(),
        np.asarray(jax.jit(lambda h: jwire._decode_flow(h, 40, 66))(jnp.asarray(half))),
        atol=1e-5)
    img = np.round(rng.uniform(0, 255, (75, 124))).astype(np.float32)
    for lvl in range(1, 8):
        s = 1.2 ** lvl
        shape = (max(int(round(75 / s)), 16), max(int(round(124 / s)), 16))
        ref = jax.jit(lambda x: jax.image.resize(x, shape, "linear"))(jnp.asarray(img))
        np.testing.assert_allclose(tresize.resize_linear(_t(img), shape).numpy(),
                                   np.asarray(ref), rtol=1e-5, atol=1e-4)


def test_metrics_match():
    rng = np.random.default_rng(7)
    T = [np.asarray(jse3.exp_se3(jnp.asarray(_xi(s, 6, 0.2)))) for s in (10, 11, 12, 13)]
    c = rng.normal(0, 3, (6, 3)).astype(np.float32)
    pa, pb = rng.normal(0, 3, (6, 3)).astype(np.float32), rng.normal(0, 3, (6, 3)).astype(np.float32)
    rj = jmetrics.camera_rpe(*map(jnp.asarray, T))
    rt = tmetrics.camera_rpe(*map(_t, T))
    for a, b in zip(rt, rj):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-4, atol=1e-4)
    oj = jax.vmap(jmetrics.object_motion_error)(*map(jnp.asarray, (T[0], T[1], c, pa, pb)))
    ot = tmetrics.object_motion_error(*map(_t, (T[0], T[1], c, pa, pb)))
    for a, b in zip(ot, oj):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-4, atol=1e-4)
    err = rng.uniform(0, 12, 300).astype(np.float32)
    err[:5] = [0.0, 0.5, 9.0, 10.0, np.inf]
    valid = rng.uniform(size=300) < 0.8
    np.testing.assert_array_equal(
        tmetrics.flow_error_histogram(_t(err), _t(valid)).numpy(),
        np.asarray(jmetrics.flow_error_histogram(jnp.asarray(err), jnp.asarray(valid))))
    pred = rng.integers(-2, 4, 200).astype(np.int32)
    sem = rng.integers(0, 5, 200).astype(np.int32)
    ids, dyn = np.array([1, 2, 3, 0], np.int32), np.array([True, False, True, False])
    sj = jmetrics.segmentation_confusion(*map(jnp.asarray, (pred, sem, ids, dyn, valid[:200])))
    st = tmetrics.segmentation_confusion(*map(_t, (pred, sem, ids, dyn, valid[:200])))
    assert [int(x) for x in st] == [int(x) for x in sj]
    Twc_e = np.stack([np.asarray(jse3.exp_se3(jnp.asarray(x))) for x in _xi(14, 10, 0.5)])
    Twc_g = np.stack([np.asarray(jse3.exp_se3(jnp.asarray(x))) for x in _xi(15, 10, 0.5)])
    for ws in (False, True):
        aj, ej = jmetrics.absolute_trajectory_error(jnp.asarray(Twc_e), jnp.asarray(Twc_g),
                                                    with_scale=ws)
        at, et = tmetrics.absolute_trajectory_error(_t(Twc_e), _t(Twc_g), with_scale=ws)
        np.testing.assert_allclose(float(at), float(aj), rtol=1e-4)
        np.testing.assert_allclose(et.numpy(), np.asarray(ej), rtol=1e-3, atol=1e-4)


def _fields(dc):
    return [(f.name, f.default if f.default is not dataclasses.MISSING
             else f.default_factory()) for f in dataclasses.fields(dc)]


@pytest.mark.parametrize("name", ["CameraConfig", "FrontendConfig", "PaddingConfig",
                                  "SolverConfig", "SegmentationConfig", "BackendConfig",
                                  "PipelineConfig"])
def test_config_copy_has_same_fields_and_defaults(name):
    jt, tt = getattr(jconfig, name), getattr(tconfig, name)
    assert [f for f, _ in _fields(tt)] == [f for f, _ in _fields(jt)]
    assert dataclasses.asdict(tt()) == dataclasses.asdict(jt())


def _frames_equal(fa, fb):
    assert len(fa) == len(fb)
    for a, b in zip(fa, fb):
        for f in dataclasses.fields(a):
            x, y = getattr(a, f.name), getattr(b, f.name)
            if isinstance(x, np.ndarray):
                assert x.dtype == y.dtype and x.shape == y.shape, f.name
                np.testing.assert_array_equal(x, y, err_msg=f.name)
            else:
                assert x == y, f.name


def test_synth_copy_multimover_bit_identical():
    _frames_equal(tsynth.make_multimover_frames(n_frames=2),
                  jsynth.make_multimover_frames(n_frames=2))


def test_synth_copy_junction_bit_identical():
    _frames_equal(tsynth.make_junction_frames(n_frames=2),
                  jsynth.make_junction_frames(n_frames=2))


def test_stereo_tree_writer_copy_identical(tmp_path):
    """Both packages' ``write_stereo_tree`` (PIL there, ``io/png`` here)
    write the same decoded pixels, masks, poses and times."""
    from PIL import Image

    jroot = jsynth.write_stereo_tree(tmp_path / "jax", n_frames=2)
    troot = tsynth.write_stereo_tree(tmp_path / "port", n_frames=2)
    names = sorted(p.relative_to(jroot) for p in jroot.rglob("*") if p.is_file())
    assert names == sorted(p.relative_to(troot) for p in troot.rglob("*") if p.is_file())
    assert len(names) == 2 + 3 * 2
    for name in names:
        a, b = jroot / name, troot / name
        if name.suffix == ".png":
            np.testing.assert_array_equal(np.asarray(Image.open(b)), np.asarray(Image.open(a)))
        else:
            assert a.read_bytes() == b.read_bytes(), name
