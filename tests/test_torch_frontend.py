"""Parity of the PyTorch port's frontend with the JAX package (CPU).

Tolerances: ``compact``, ``nms3x3``, the FAST score map and keypoint set
at pyramid level 0, and the sampled positions, validity and labels are
exact (integer grey levels make every level-0 sum exact); depth, flow and
correspondences rtol 1e-6 (XLA's float32 division may round 1 ulp apart);
``zncc`` atol 1e-5 (a 25-term float32 mean in another order); patches
atol 1e-4.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from multimot_track_tpu.config import DEFAULT_CONFIG as JCFG
from multimot_track_tpu.frontend import fast as jfast
from multimot_track_tpu.frontend import sampling as jsampling
from multimot_track_tpu.io.synth import make_multimover_frames, synth_camera_config
from multimot_track_tpu.ops import photometric as jphot
from multimot_track_tpu.pipeline import frames as jframes
from multimot_track_tpu_torch import state
from multimot_track_tpu_torch.config import DEFAULT_CONFIG as TCFG
from multimot_track_tpu_torch.frontend import fast as tfast
from multimot_track_tpu_torch.frontend import sampling as tsampling
from multimot_track_tpu_torch.io.synth import synth_camera_config as t_synth_cam
from multimot_track_tpu_torch.ops import photometric as tphot
from multimot_track_tpu_torch.pipeline import frames as tframes

torch.set_num_threads(1)


def _t(a):
    return torch.from_numpy(np.array(a))


@pytest.fixture(scope="module")
def scene():
    frames = make_multimover_frames(n_frames=2)
    gray = np.clip(np.round(frames[0].gray), 0, 255).astype(np.float32)
    return frames, gray


def test_compact_exact():
    rng = np.random.default_rng(0)
    valid = rng.uniform(size=300) < 0.3
    pay = rng.normal(0, 1, (300, 3)).astype(np.float32)
    for n_max in (50, 400):
        nj, mj, pj = jsampling.compact(jnp.asarray(valid), n_max, jnp.asarray(pay))
        nt, mt, pt = tsampling.compact(_t(valid)[None], n_max, _t(pay)[None])
        assert int(nt[0]) == int(nj)
        np.testing.assert_array_equal(mt[0].numpy(), np.asarray(mj))
        np.testing.assert_array_equal(pt[0].numpy(), np.asarray(pj))


def test_fast_score_and_nms_exact(scene):
    _, gray = scene
    for thr in (7.0, 20.0):
        sj = np.asarray(jfast.fast_score_map(jnp.asarray(gray), thr))
        st = tfast.fast_score_map(_t(gray)[None], thr)[0].numpy()
        np.testing.assert_array_equal(st, sj)
    sj = np.asarray(jfast.nms3x3(jnp.asarray(sj)))
    np.testing.assert_array_equal(tfast.nms3x3(_t(st)[None])[0].numpy(), sj)


def test_topk_stable_matches_lax_top_k_on_ties():
    x = np.array([[3.0, 1.0, 3.0, 2.0, 3.0, 1.0, 0.0, 2.0]], np.float32)
    vj, ij = jax.lax.top_k(jnp.asarray(x), 5)
    vt, it = tfast.topk_stable(_t(x), 5)
    np.testing.assert_array_equal(it.numpy(), np.asarray(ij))
    np.testing.assert_array_equal(vt.numpy(), np.asarray(vj))


def test_detect_pyramid_level0_exact_and_upper_levels_close(scene):
    _, gray = scene
    kw = dict(n_levels=4, n_total=1000)
    kj = jfast.detect_pyramid(jnp.asarray(gray), **kw)
    kt = tfast.detect_pyramid(_t(gray)[None], **kw)
    lvl = np.asarray(kj.level)
    assert np.array_equal(kt.level[0].numpy(), lvl)
    l0 = lvl == 0
    np.testing.assert_array_equal(kt.uv[0].numpy()[l0], np.asarray(kj.uv)[l0])
    np.testing.assert_array_equal(kt.valid[0].numpy()[l0], np.asarray(kj.valid)[l0])
    np.testing.assert_array_equal(kt.score[0].numpy()[l0], np.asarray(kj.score)[l0])
    # upper levels resize with JAX's filter to float32 rounding: the sets
    # agree up to the odd quantisation tie of the +1e6 bias
    same = (kt.uv[0].numpy() == np.asarray(kj.uv)).all(-1)
    assert same[~l0].mean() > 0.97, same[~l0].mean()


def test_extract_patches_and_zncc(scene):
    frames, gray = scene
    rng = np.random.default_rng(1)
    uv = np.concatenate([rng.uniform(-5, 645, (200, 2)),
                         rng.uniform(0, 384, (50, 2))]).astype(np.float32)
    pj = np.asarray(jphot.extract_patches(jnp.asarray(gray), jnp.asarray(uv), 2))
    pt = tphot.extract_patches(_t(gray)[None], _t(uv)[None], 2)[0].numpy()
    np.testing.assert_allclose(pt, pj, atol=1e-4)
    g2 = np.clip(np.round(frames[1].gray), 0, 255).astype(np.float32)
    pj2 = np.asarray(jphot.extract_patches(jnp.asarray(g2), jnp.asarray(uv + 0.7), 2))
    np.testing.assert_allclose(tphot.zncc(_t(pj), _t(pj2)).numpy(),
                               np.asarray(jphot.zncc(jnp.asarray(pj), jnp.asarray(pj2))),
                               atol=1e-5)


def _cfgs():
    def cut(C, cam):
        return dataclasses.replace(
            C, camera=cam,
            frontend=dataclasses.replace(C.frontend, n_features=1000, n_levels=4),
            padding=dataclasses.replace(C.padding, n_static_max=512, n_obj_pts_max=2048,
                                        n_per_obj_max=1024, k_obj_max=4),
        )
    return cut(JCFG, synth_camera_config()), cut(TCFG, t_synth_cam())


@pytest.fixture(scope="module")
def observations(scene):
    frames, _ = scene
    jcfg, tcfg = _cfgs()
    from multimot_track_tpu.pipeline import tracker as jtracker
    from multimot_track_tpu.ops import wire as jwire

    fd = frames[0]
    gt = jframes.make_gt_table(fd.pose_gt, fd.obj_ids_gt, fd.obj_poses_gt, 4)
    args = (np.clip(np.round(fd.gray), 0, 255).astype(np.uint8),
            np.clip(fd.depth_raw, 0, 65535).astype(np.uint16),
            jwire.pack_flow12(fd.flow), jwire.pack_sem4(fd.sem_mask))
    obs_j = jtracker.first_step(*map(jnp.asarray, args), gt, jcfg)
    from multimot_track_tpu_torch.ops import wire as twire

    W, H = tcfg.camera.width, tcfg.camera.height
    obs_t = tframes.build_frame_observation(
        _t(args[0])[None].to(torch.float32),
        twire._decode_depth(_t(args[1].astype(np.int32))[None], W),
        twire._decode_flow(_t(args[2])[None], H, W),
        twire._decode_sem(_t(args[3])[None], W),
        state.from_reference(gt, tframes.GTTable, batch=True), tcfg,
    )
    return frames, jcfg, tcfg, obs_j, obs_t


def test_frame_observation_samples_match(observations):
    _, _, _, obs_j, obs_t = observations
    for group in ("static", "objects"):
        gj, gt_ = getattr(obs_j, group), getattr(obs_t, group)
        valid = np.asarray(gj.valid)
        np.testing.assert_array_equal(gt_.valid[0].numpy(), valid)
        for f in gj._fields:
            a, b = np.asarray(getattr(gj, f)), getattr(gt_, f)[0].numpy()
            if f == "patch":
                np.testing.assert_allclose(b[valid], a[valid], atol=1e-4, err_msg=f)
            elif f in ("depth", "flow", "corres"):
                # bf / disparity may round 1 ulp apart under XLA's division
                np.testing.assert_allclose(b[valid], a[valid], rtol=1e-6, err_msg=f)
            else:
                np.testing.assert_array_equal(b[valid], a[valid], err_msg=f)


def test_build_pair_matches(observations):
    frames, jcfg, tcfg, obs_j, obs_t = observations
    fd = frames[1]
    gt = jframes.make_gt_table(fd.pose_gt, fd.obj_ids_gt, fd.obj_poses_gt, 4)
    depth = np.clip(fd.depth_raw, 0, 65535).astype(np.uint16).astype(np.float32)
    sem = fd.sem_mask.astype(np.int32)
    gray = np.clip(np.round(fd.gray), 0, 255).astype(np.float32)
    pj = jframes.build_pair(obs_j, jnp.asarray(depth), jnp.asarray(sem), gt, jcfg,
                            cur_gray=jnp.asarray(gray))
    pt = tframes.build_pair(obs_t, _t(depth)[None], _t(sem)[None],
                            state.from_reference(gt, tframes.GTTable, batch=True), tcfg,
                            cur_gray=_t(gray)[None])
    sv, ov = np.asarray(pj.st_valid), np.asarray(pj.ob_valid)
    for f in tframes.PairInputs._fields:
        if f.startswith("gt_"):
            continue
        a, b = np.asarray(getattr(pj, f)), getattr(pt, f)[0].numpy()
        m = sv if f.startswith("st_") else ov if f.startswith("ob_") else slice(None)
        if f == "st_zncc":
            np.testing.assert_allclose(b[m], a[m], atol=1e-5, err_msg=f)
        elif f == "ob_patch":
            np.testing.assert_allclose(b[m], a[m], atol=1e-4, err_msg=f)
        elif a.dtype == np.float32 and f not in ("st_uv", "ob_uv", "cur_gray"):
            np.testing.assert_allclose(b[m], a[m], rtol=1e-6, err_msg=f)
        else:
            np.testing.assert_array_equal(b[m], a[m], err_msg=f)
