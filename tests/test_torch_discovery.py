"""Mask-free object discovery: the PyTorch port against the JAX package (CPU).

Unit parity of ``ops/graphcut`` (k-NN graph with equal-distance ties,
hypothesis dedupe, data costs, energy, the mean-field + ICM labeler, the
exact alpha-expansion labeler) and ``pipeline/motion_seg`` (the whole
discovery with the JAX package's hypothesis draws replayed, and the
rasteriser with points outside the image on every side), on the fixtures
of ``tests/test_graphcut.py`` and ``tests/test_motion_seg.py``; and a
discovery run with a BoW query that loads no jax.  The live system in
mask-free mode is ``test_torch_discovery_live.py``.

Tolerances: graph indices, dedupe masks, labels and masks identical; graph
weights rtol 1e-6; data costs and energies rtol 1e-5 (float32 products in
another summation order), with an absolute 1e-2 per cost (and per point of
an energy) where the hypotheses come from two Horn fits.
"""

import os
import pathlib
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from multimot_track_tpu.config import CameraConfig
from multimot_track_tpu.ops import graphcut as jgc
from multimot_track_tpu.pipeline import motion_seg as jms
from multimot_track_tpu_torch.ops import graphcut as tgc
from multimot_track_tpu_torch.pipeline import motion_seg as tms
from multimot_track_tpu_torch.solvers.ransac import Sites
import test_graphcut
from test_graphcut import two_motion_scene
from test_motion_seg import synth_pair
from test_torch_ransac import JaxKeySampler
from torch_seeding import seeded

torch.set_num_threads(1)

CAM = CameraConfig()
INTR = (CAM.fx, CAM.fy, CAM.cx, CAM.cy)
REPO = pathlib.Path(__file__).resolve().parent.parent
# data costs: LAMBDA x 1.25e-4 px, a few float32 roundings of pixel
# coordinates of a few hundred px (the hypotheses' Horn fits differ ~1e-6)
COST_ATOL = 1e-2


def _t(a):
    return torch.from_numpy(np.array(a))


def key_sampler(key):
    """Draws a ``(0, "discover")`` site with ``key``."""
    return JaxKeySampler({100_000: key}, 1, 1)


def _graph_t(g):
    return tgc.SegGraph(_t(g.nbr_idx).long(), _t(g.nbr_w), _t(g.valid))


def _two_motion_problem(n_hyp=16):
    """The JAX package's problem tensors on the two-motion fixture."""
    uv, Xw, Xc, uv_cur, n_per = seeded(test_graphcut, 5, two_motion_scene)
    valid = jnp.ones(uv.shape[0], bool)
    g = jgc.build_knn_graph(jnp.asarray(uv_cur), valid, k=6)
    hyp = jgc.sample_motion_hypotheses(jax.random.PRNGKey(0), g, jnp.asarray(Xw),
                                       jnp.asarray(Xc), n_hyp=n_hyp)
    keep = jgc.dedupe_hypotheses(hyp)
    D = jgc.data_costs(hyp, jnp.asarray(Xw), jnp.asarray(uv_cur), *INTR)
    return g, hyp, keep, jnp.where(keep[None, :], D, 1e9), (Xw, Xc, uv_cur)


def test_knn_graph_matches_jax_with_ties():
    rng = np.random.default_rng(3)
    # a step-8 grid (four neighbours at 8 px, four at 8 sqrt 2) with holes,
    # and scattered points
    yy, xx = np.mgrid[0:96:8, 0:128:8]
    grid = np.stack([xx, yy], -1).reshape(-1, 2).astype(np.float32)
    for uv, valid in ((grid, rng.random(len(grid)) < 0.85),
                      (rng.uniform(0, 100, (64, 2)).astype(np.float32), np.ones(64, bool))):
        gj = jgc.build_knn_graph(jnp.asarray(uv), jnp.asarray(valid), k=6)
        gt = tgc.build_knn_graph(_t(uv), _t(valid), k=6)
        np.testing.assert_array_equal(gt.nbr_idx.numpy(), np.asarray(gj.nbr_idx))
        np.testing.assert_allclose(gt.nbr_w.numpy(), np.asarray(gj.nbr_w), rtol=1e-6)


def test_hypotheses_dedupe_and_costs_match_jax():
    g, hyp, keep, D, (Xw, Xc, uv_cur) = _two_motion_problem()
    seeds = np.asarray(jax.random.choice(jax.random.PRNGKey(0), len(Xw), (16,),
                                         p=jnp.asarray(np.full(len(Xw), 1.0 / len(Xw),
                                                               np.float32))))
    hyp_t = tgc.sample_motion_hypotheses(_t(seeds), _graph_t(g), _t(Xw), _t(Xc))
    np.testing.assert_allclose(hyp_t.numpy(), np.asarray(hyp), atol=2e-5)
    # duplicates of earlier hypotheses, one just inside each gate
    H = np.asarray(hyp)
    dup = np.concatenate([H, H[:3]]).copy()
    dup[-2, :3, 3] += 0.04
    dup[-1, :3, 3] += 0.2
    np.testing.assert_array_equal(tgc.dedupe_hypotheses(_t(dup)).numpy(),
                                  np.asarray(jgc.dedupe_hypotheses(jnp.asarray(dup))))
    np.testing.assert_array_equal(tgc.dedupe_hypotheses(_t(H)).numpy(), np.asarray(keep))
    Dt = tgc.data_costs(_t(H), _t(Xw), _t(uv_cur), *INTR)
    Dj = jgc.data_costs(hyp, jnp.asarray(Xw), jnp.asarray(uv_cur), *INTR)
    np.testing.assert_allclose(Dt.numpy(), np.asarray(Dj), rtol=1e-5, atol=1e-3)


def test_segment_and_energy_match_jax():
    g, _, _, D, _ = _two_motion_problem()
    lj, ej = jgc.segment(D, g)
    lt, et = tgc.segment(_t(D), _graph_t(g))
    np.testing.assert_array_equal(lt.numpy(), np.asarray(lj))
    np.testing.assert_allclose(float(et), float(ej), rtol=1e-5)
    rand = np.random.default_rng(4).integers(0, D.shape[1], D.shape[0])
    np.testing.assert_allclose(
        float(tgc.total_energy(_t(rand), _t(D), _graph_t(g))),
        float(jgc.total_energy(jnp.asarray(rand, jnp.int32), D, g)), rtol=1e-5)


def test_segment_constant_guard_matches_jax():
    """Random costs under near-saturated weights: the single-label guard."""
    rng = np.random.default_rng(9)
    uv = rng.uniform(0, 30, (96, 2)).astype(np.float32)
    valid = rng.random(96) < 0.9
    g = jgc.build_knn_graph(jnp.asarray(uv), jnp.asarray(valid), k=6)
    D = rng.uniform(0, 200, (96, 5)).astype(np.float32)
    lj, ej = jgc.segment(jnp.asarray(D), g)
    lt, et = tgc.segment(_t(D), _graph_t(g))
    np.testing.assert_array_equal(lt.numpy(), np.asarray(lj))
    np.testing.assert_allclose(float(et), float(ej), rtol=1e-5)


def test_segment_exact_matches_jax():
    g, _, _, D, _ = _two_motion_problem()
    lj, ej = jgc.segment_exact(np.asarray(D), g)
    lt, et = tgc.segment_exact(_t(D), _graph_t(g))
    np.testing.assert_array_equal(lt, lj)
    assert et == ej
    # with invalid sites, on random costs
    rng = np.random.default_rng(12)
    uv = rng.uniform(0, 60, (80, 2)).astype(np.float32)
    valid = rng.random(80) < 0.8
    g2 = jgc.build_knn_graph(jnp.asarray(uv), jnp.asarray(valid), k=6)
    D2 = rng.uniform(0, 300, (80, 3)).astype(np.float32)
    lj, ej = jgc.segment_exact(D2, g2)
    lt, et = tgc.segment_exact(_t(D2), _graph_t(g2))
    np.testing.assert_array_equal(lt, lj)
    assert et == ej


def test_native_source_is_the_jax_packages():
    """The port builds its own copy of the exact labeler's source."""
    a = (REPO / "multimot_track_tpu_torch" / "native" / "graphcut.cc").read_bytes()
    assert a == (REPO / "multimot_track_tpu" / "native" / "graphcut.cc").read_bytes()


def test_native_build_failure_raises(tmp_path, monkeypatch):
    """A labeler that cannot be built raises; nothing falls back."""
    from multimot_track_tpu_torch import kernels

    monkeypatch.setattr(kernels, "BUILD_ROOT", tmp_path)
    monkeypatch.setattr(tgc, "_GC_DLL", None)
    monkeypatch.setenv("CXX", str(tmp_path / "no-such-compiler"))
    g = tgc.build_knn_graph(torch.rand(20, 2) * 30, torch.ones(20, dtype=torch.bool))
    with pytest.raises(kernels.KernelBuildError, match="no-such-compiler"):
        tgc.segment_exact(torch.rand(20, 3) * 100, g)


def test_rasterize_labels_at_matches_jax_outside_the_image():
    H, W, step = 60, 90, 8
    rng = np.random.default_rng(5)
    inside = rng.uniform([0, 0], [W, H], (40, 2))
    # just left / above (round to -1: wraps), far outside (dropped), right, below
    outside = np.array([[-3.0, 20], [-4.1, 30], [20, -3.5], [30, -4.0], [-40, 10], [10, -70],
                        [W + 3, 20], [W + 30, 5], [15, H + 3], [22, H + 40], [-5, -5],
                        [W + 2, H + 2], [-200, -200]])
    uv = np.concatenate([inside, outside]).astype(np.float32)
    labels = rng.integers(0, 4, len(uv)).astype(np.int32)
    valid = rng.random(len(uv)) < 0.9
    valid[len(inside):] = True
    labels[len(inside):] = 3
    mj = jms.rasterize_labels_at(jnp.asarray(uv), jnp.asarray(labels), jnp.asarray(valid),
                                 H, W, step)
    mt = tms.rasterize_labels_at(_t(uv), _t(labels).long(), _t(valid), H, W, step)
    np.testing.assert_array_equal(mt.numpy(), np.asarray(mj))
    assert (np.asarray(mj)[:, -3:] == 3).any() and (np.asarray(mj)[-3:, :] == 3).any()


@pytest.fixture(scope="module")
def pair():
    depth0, depth1, flow, ego, _ = synth_pair()
    return depth0, depth1, flow, ego


def test_discovery_problem_matches_jax(pair):
    """Candidates, graph and data costs of the discovery problem."""
    kw = dict(step=8, n_max=512)
    key = jax.random.PRNGKey(0)
    pj = jms._discovery_problem(key, *map(jnp.asarray, pair), *INTR, **kw)
    pt = tms._discovery_problem(key_sampler(key), (0, "discover"), *map(_t, pair), *INTR, **kw)
    mask = np.asarray(pj[4])
    np.testing.assert_array_equal(pt[4].numpy(), mask)
    np.testing.assert_array_equal(pt[0].numpy(), np.asarray(pj[0]))
    np.testing.assert_array_equal(pt[3].nbr_idx.numpy(), np.asarray(pj[3].nbr_idx))
    np.testing.assert_allclose(pt[2].numpy()[mask], np.asarray(pj[2])[mask], rtol=1e-4,
                               atol=COST_ATOL)


@pytest.mark.parametrize("exact", [False, True])
def test_discover_objects_matches_jax(pair, exact):
    """The whole discovery, the JAX draw replayed: identical candidates,
    labels and rasters."""
    kw = dict(step=8, n_max=512)
    key = jax.random.PRNGKey(0)
    jfn, tfn = ((jms.discover_objects_exact, tms.discover_objects_exact) if exact
                else (jms.discover_objects, tms.discover_objects))
    dj = jfn(key, *map(jnp.asarray, pair), *INTR, **kw)
    dt = tfn(key_sampler(key), (0, "discover"), *map(_t, pair), *INTR, **kw)
    np.testing.assert_array_equal(dt.valid.numpy(), np.asarray(dj.valid))
    assert int(dt.valid.sum()) > 50
    np.testing.assert_array_equal(dt.uv.numpy(), np.asarray(dj.uv))
    np.testing.assert_allclose(dt.uv_cur.numpy(), np.asarray(dj.uv_cur), atol=1e-4)
    np.testing.assert_array_equal(dt.labels.numpy(), np.asarray(dj.labels))
    # the energy sums near-zero costs here (the fixture's motions are
    # exact), so its bound is absolute: the data costs' own per point
    n = int(dt.valid.sum())
    assert abs(float(dt.energy) - float(dj.energy)) <= COST_ATOL * n + 1e-5 * float(dj.energy)
    np.testing.assert_array_equal(tms.rasterize_labels(dt, 192, 512).numpy(),
                                  np.asarray(jms.rasterize_labels(dj, 192, 512)))


def test_discovery_draw_shape():
    """The port's (n_hyp, 1) draw is JAX's (n_hyp,) draw."""
    p = np.random.default_rng(1).random(300).astype(np.float32)
    p /= p.sum()
    key = jax.random.PRNGKey(7)
    a = np.asarray(jax.random.choice(key, 300, (24,), p=jnp.asarray(p)))
    b = key_sampler(key)(_t(p)[None], 24, Sites([(0, "discover")]), k=1)
    np.testing.assert_array_equal(b[0, :, 0].numpy(), a)


def test_discovery_and_bow_run_without_jax():
    """A discovery run, the exact labeler and a BoW query load no jax."""
    code = (
        "import sys, dataclasses, numpy as np, torch\n"
        "torch.set_num_threads(1)\n"
        "from multimot_track_tpu_torch import config as C\n"
        "from multimot_track_tpu_torch.io.synth import make_multimover_frames, "
        "synth_camera_config\n"
        "from multimot_track_tpu_torch.ops import graphcut\n"
        "from multimot_track_tpu_torch.pipeline.keyframes import Keyframe, KeyframeStore\n"
        "from multimot_track_tpu_torch.pipeline.system import MultiMotSystem\n"
        "D = C.DEFAULT_CONFIG\n"
        "cfg = dataclasses.replace(D, camera=synth_camera_config(),\n"
        "    frontend=dataclasses.replace(D.frontend, n_features=500, n_levels=2),\n"
        "    padding=dataclasses.replace(D.padding, n_static_max=256, n_obj_pts_max=1024,\n"
        "        n_per_obj_max=512, k_obj_max=2, k_obj_solve=1),\n"
        "    solver=dataclasses.replace(D.solver, ransac_iters=16, obj_ransac_iters=16,\n"
        "        obj_ensemble_seeds=1, obj_reclassify_rounds=1, cam_lm_iters=5,\n"
        "        obj_lm_iters=5),\n"
        "    backend=dataclasses.replace(D.backend, window_refine=False,\n"
        "        joint_window_refine=False))\n"
        "s = MultiMotSystem(cfg, keyframe_gap=1, enable_loop_closing=False,\n"
        "                   discover_objects=True, device='cpu')\n"
        "for fd in make_multimover_frames(n_frames=3):\n"
        "    s.track_rgbd(fd)\n"
        "assert s.stage_report()['discover']['n'] == 1\n"
        "g = graphcut.build_knn_graph(torch.rand(50, 2) * 40, torch.ones(50, dtype=torch.bool))\n"
        "graphcut.segment_exact(torch.rand(50, 3) * 100, g)\n"
        "rng = np.random.default_rng(0)\n"
        "st = KeyframeStore(min_gap=1, bow_threshold=4, device='cpu')\n"
        "descs = [np.where(rng.random((128, 256)) < 0.5, 1, -1).astype(np.int8)\n"
        "         for _ in range(8)]\n"
        "for i, d in enumerate(descs):\n"
        "    st.maybe_add(Keyframe(index=i, Tcw=np.eye(4, dtype=np.float32),\n"
        "        uv=np.zeros((128, 2), np.float32), desc=d, valid=np.ones(128, bool),\n"
        "        Xw=np.zeros((128, 3), np.float32)))\n"
        "cand = st.detect_loop(torch.from_numpy(descs[2]), torch.ones(128, dtype=torch.bool))\n"
        "print(cand, st._voc is not None, 'jax' in sys.modules)\n"
    )
    env = dict(os.environ)
    env["PYTHONPATH"] = str(REPO) + os.pathsep + env.get("PYTHONPATH", "")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         env=env, timeout=300)
    assert out.returncode == 0, out.stderr[-3000:]
    assert out.stdout.strip().splitlines()[-1].split() == ["2", "True", "False"]
