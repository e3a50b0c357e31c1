"""Parity of the port's ORB descriptors with the JAX package (CPU).

Tolerances, with their reasons:
* the BRIEF pattern: identical (the same numpy draw, or the same file);
* the blur: atol 1e-4 (a 7-tap float32 convolution summed in another
  order: a few ulp at grey levels up to 255);
* the IC angle: 1e-5 rad wherever the centroid moment |m| is at least
  1e4, and |d angle| * |m| <= 0.2 everywhere.  The moments are ~700-term
  float32 sums (terms up to ~4e3) whose rounding, ~0.1 in absolute terms,
  differs with the summation order; the angle inherits it divided by |m|;
* the descriptors, given the JAX package's blurred image and angles:
  identical, bit for bit.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from multimot_track_tpu.frontend import fast as jfast
from multimot_track_tpu.frontend import orb as jorb
from multimot_track_tpu.io.synth import make_multimover_frames
from multimot_track_tpu_torch.frontend import orb as torb

torch.set_num_threads(1)


@pytest.fixture(scope="module")
def scene():
    fd = make_multimover_frames(n_frames=2)[1]
    g = np.clip(np.round(fd.gray), 0, 255).astype(np.float32)
    kp = jfast.detect_pyramid(jnp.asarray(g), n_levels=4, n_total=1024)
    uv = np.asarray(kp.uv)
    # plus keypoints on the border, where the clipped gathers repeat pixels
    uv = np.concatenate([uv, [[0.0, 0.0], [639.0, 383.0], [2.5, 380.5], [637.5, 1.5]]])
    blur = np.array(jorb.gaussian_blur(jnp.asarray(g)))
    return g, uv.astype(np.float32), blur


def test_brief_pattern_matches_jax():
    np.testing.assert_array_equal(torb.brief_pattern(), jorb.brief_pattern())
    np.testing.assert_array_equal(torb.brief_pattern(seed=7, n_bits=64),
                                  jorb.brief_pattern(seed=7, n_bits=64))
    dx_t, dy_t = torb._disc_offsets(torb.PATCH_RADIUS)
    dx_j, dy_j = jorb._disc_offsets(jorb.PATCH_RADIUS)
    np.testing.assert_array_equal(dx_t, dx_j)
    np.testing.assert_array_equal(dy_t, dy_j)


def test_gaussian_blur_close(scene):
    g, _, blur = scene
    np.testing.assert_allclose(torb.gaussian_blur(torch.from_numpy(g)).numpy(), blur, atol=1e-4)


def test_orientations_close(scene):
    g, uv, blur = scene
    aj = np.array(jorb.compute_orientations(jnp.asarray(blur), jnp.asarray(uv)))
    at = torb.compute_orientations(torch.from_numpy(blur), torch.from_numpy(uv)).numpy()
    d = np.abs(np.angle(np.exp(1j * (at.astype(np.float64) - aj))))
    H, W = blur.shape
    dx, dy = torb._disc_offsets(torb.PATCH_RADIUS)
    xi = np.clip(np.round(uv[:, :1]).astype(int) + dx, 0, W - 1)
    yi = np.clip(np.round(uv[:, 1:]).astype(int) + dy, 0, H - 1)
    vals = blur[yi, xi].astype(np.float64)
    mag = np.hypot((vals * dx).sum(-1), (vals * dy).sum(-1))
    strong = mag >= 1e4
    assert strong.mean() > 0.5
    assert d[strong].max() <= 1e-5, d[strong].max()
    assert (d * mag).max() <= 0.2, (d * mag).max()


def test_brief_descriptors_equal_given_jax_angles(scene):
    _, uv, blur = scene
    aj = np.array(jorb.compute_orientations(jnp.asarray(blur), jnp.asarray(uv)))
    dj = np.asarray(jorb.brief_descriptors(jnp.asarray(blur), jnp.asarray(uv), jnp.asarray(aj)))
    dt = torb.brief_descriptors(torch.from_numpy(blur), torch.from_numpy(uv),
                                torch.from_numpy(aj)).numpy()
    assert dt.dtype == np.int8 and set(np.unique(dt)) <= {-1, 1}
    np.testing.assert_array_equal(dt, dj)


def test_describe_shapes_and_sign_form(scene):
    g, uv, _ = scene
    desc, ang = torb.describe(torch.from_numpy(g), torch.from_numpy(uv))
    assert desc.shape == (uv.shape[0], torb.N_BITS) and desc.dtype == torch.int8
    assert ang.shape == (uv.shape[0],) and bool(torch.isfinite(ang).all())
    dj, _ = jorb.describe(jnp.asarray(g), jnp.asarray(uv))
    # end to end the angles may differ by float32 rounding (see above), which
    # can move a steered sample across a pixel boundary: nearly all bits agree
    assert (desc.numpy() == np.asarray(dj)).mean() > 0.999
