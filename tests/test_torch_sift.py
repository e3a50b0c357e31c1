"""Parity of the port's SIFT extractor with the JAX package (CPU).

Inputs: ``tests/test_sift.py``'s images (the blobby images at seeds 0 and
3, the latter also rolled by 5 px, and the three-blob image) at that
file's settings.  Tolerances: the valid keypoints identical in position
and scale, and at most 1 % of them may differ (a near-tie of float32 DoG
responses summed in another order can flip one extremum; none does on
these inputs today).  Their angles equal to 1e-6 rad, except where the
orientation histogram's best bins tie to float32 rounding (the blobs are
symmetric Gaussians centred on pixels, so their histograms tie 2 or 4
bins, and XLA's fused sum breaks the tie another way than its own op-by-op
sum): there the JAX package's bin must be one of the tied bins.
Descriptors within 1e-4 of the JAX package's ``_descriptors`` at the
port's angle, and of its extractor's output where the angles agree.  Then
the three behavioural tests of ``tests/test_sift.py`` on the port alone.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from multimot_track_tpu.frontend import sift as jsift
from multimot_track_tpu_torch.frontend import sift as tsift
from multimot_track_tpu_torch.ops import matching as tmatching

torch.set_num_threads(1)

MAX_FLIPPED = 0.01      # share of valid keypoints a near-tie may move
DESC_ATOL = 1e-4
TIE_RTOL = 1e-5         # histogram bins this close to the best one tie


def blobby_image(H=160, W=240, n=40, seed=0):
    rng = np.random.default_rng(seed)
    img = np.zeros((H, W), np.float32)
    for _ in range(n):
        y, x = rng.integers(20, H - 20), rng.integers(20, W - 20)
        r = rng.integers(3, 9)
        yy, xx = np.mgrid[-r: r + 1, -r: r + 1]
        blob = np.exp(-(yy ** 2 + xx ** 2) / (0.5 * r ** 2)) * rng.uniform(80, 200)
        img[y - r: y + r + 1, x - r: x + r + 1] += blob
    return np.clip(img, 0, 255)


def three_blobs():
    img = np.zeros((100, 100), np.float32)
    for (y, x) in [(30, 30), (30, 70), (70, 50)]:
        yy, xx = np.mgrid[-6:7, -6:7]
        img[y - 6: y + 7, x - 6: x + 7] += 200 * np.exp(-(yy ** 2 + xx ** 2) / 8.0)
    return img


CASES = {
    "blobby0": (lambda: blobby_image(), dict(n_octaves=3, n_max=256)),
    "blobby3": (lambda: blobby_image(seed=3), dict(n_octaves=3, n_max=128)),
    "blobby3_rolled": (lambda: np.roll(blobby_image(seed=3), 5, axis=1),
                       dict(n_octaves=3, n_max=128)),
    "three_blobs": (three_blobs, dict(n_octaves=2, n_max=64)),
}


def _np(kp):
    return {k: np.asarray(v) for k, v in kp._asdict().items()}


@pytest.mark.parametrize("case", sorted(CASES))
def test_sift_matches_jax(case):
    make, kw = CASES[case]
    img = make()
    j = _np(jsift.extract_sift(jnp.asarray(img), **kw))
    t = {k: v.numpy() for k, v in tsift.extract_sift(torch.from_numpy(img), **kw)._asdict().items()}
    assert t["desc"].shape == j["desc"].shape
    jv = {(float(u), float(v), float(s)): i
          for i, ((u, v), s) in enumerate(zip(j["uv"][j["valid"]], j["scale"][j["valid"]]))}
    tv = {(float(u), float(v), float(s)): i
          for i, ((u, v), s) in enumerate(zip(t["uv"][t["valid"]], t["scale"][t["valid"]]))}
    shared = sorted(set(jv) & set(tv))
    n_valid = max(len(jv), len(tv))
    assert n_valid > 0
    assert len(shared) >= (1 - MAX_FLIPPED) * n_valid, (len(shared), len(jv), len(tv))
    ji = np.flatnonzero(j["valid"])[[jv[k] for k in shared]]
    ti = np.flatnonzero(t["valid"])[[tv[k] for k in shared]]
    uv_t = torch.from_numpy(t["uv"][ti])
    hist = tsift._orientation_hist(torch.from_numpy(img), uv_t).numpy()
    tied = hist >= hist.max(-1, keepdims=True) * (1 - TIE_RTOL)
    j_bin = np.round((j["angle"][ji] + np.pi) / (2 * np.pi) * 36 - 0.5).astype(int) % 36
    assert tied[np.arange(len(ti)), j_bin].all()
    single = tied.sum(-1) == 1
    np.testing.assert_allclose(t["angle"][ti][single], j["angle"][ji][single], atol=1e-6)
    same = np.abs(t["angle"][ti] - j["angle"][ji]) < 1e-6
    np.testing.assert_allclose(t["desc"][ti][same], j["desc"][ji][same], atol=DESC_ATOL)
    j_at_t = np.asarray(jsift._descriptors(jnp.asarray(img), jnp.asarray(t["uv"][ti]),
                                           jnp.asarray(t["scale"][ti]),
                                           jnp.asarray(t["angle"][ti])))
    np.testing.assert_allclose(t["desc"][ti], j_at_t, atol=DESC_ATOL)
    np.testing.assert_allclose(t["score"][ti], j["score"][ji], rtol=1e-4, atol=1e-5)
    assert not t["desc"][~t["valid"]].any()


def test_extract_shapes():
    kp = tsift.extract_sift(torch.from_numpy(blobby_image()), n_octaves=3, n_max=256)
    assert kp.desc.shape == (256, 128)
    v = kp.valid.numpy()
    assert v.sum() > 20
    norms = np.linalg.norm(kp.desc.numpy()[v], axis=1)
    np.testing.assert_allclose(norms, 1.0, atol=1e-4)


def test_blob_centers_detected():
    kp = tsift.extract_sift(torch.from_numpy(three_blobs()), n_octaves=2, n_max=64)
    uv = kp.uv.numpy()[kp.valid.numpy()]
    for (y, x) in [(30, 30), (30, 70), (70, 50)]:
        assert np.min(np.linalg.norm(uv - [x, y], axis=1)) < 3.0


def test_sift_matching_under_shift():
    base = blobby_image(seed=3)
    k0 = tsift.extract_sift(torch.from_numpy(base), n_octaves=3, n_max=128)
    k1 = tsift.extract_sift(torch.from_numpy(np.roll(base, 5, axis=1)), n_octaves=3, n_max=128)
    res = tmatching.match_float(k0.desc, k1.desc, k0.valid, k1.valid)
    v = res.valid.numpy()
    assert v.sum() > 10
    duv = k1.uv.numpy()[res.idx.numpy()[v]] - k0.uv.numpy()[v]
    med = np.median(duv, axis=0)
    assert abs(med[0] - 5) < 1.5 and abs(med[1]) < 1.5, med
