"""Parity of the port's Horn alignment and RANSAC with the JAX package (CPU).

``JaxKeySampler`` replays the JAX package's random key path, so both
packages score the same hypotheses: per pair ``split(PRNGKey(seed), F-1)``,
then ``k_ego, k_obj = split``, per label slot ``split(k_obj, K)``, per seed
``split(k_rng, S)``, and ``jax.random.choice`` with the same probabilities.

Tolerances: poses atol 1e-4 (float32 power iteration and Gauss-Newton in
another summation order), inlier counts +-2 (points within rounding of the
reprojection gate).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from multimot_track_tpu.geometry import camera as jcamera
from multimot_track_tpu.geometry import se3 as jse3
from multimot_track_tpu.solvers import horn as jhorn
from multimot_track_tpu.solvers import ransac as jransac
from multimot_track_tpu_torch.solvers import horn as thorn
from multimot_track_tpu_torch.solvers import ransac as transac

torch.set_num_threads(1)

FX, FY, CX, CY = 460.0, 460.0, 320.0, 192.0


class JaxKeySampler:
    """A HypothesisSampler that draws what the JAX package draws.

    ``pair_keys[i]`` is pair i's key: ``split(PRNGKey(seed), F-1)`` for the
    batched drivers, ``FoldInKeys`` for the live system (its step key
    ``fold_in(PRNGKey(seed), frame_idx)``).  A ``(frame, "pnp")`` or
    ``(frame, "sim3")`` site draws with the step key itself, as
    relocalization's PnP and the loop ladder's Sim3 RANSAC do; a
    ``(frame, "discover")`` site (k = 1) with the key the JAX system folds
    for discovery."""

    def __init__(self, pair_keys, k_obj_max, n_seeds):
        self.pair_keys, self.K, self.S = pair_keys, k_obj_max, n_seeds

    @classmethod
    def for_sequence(cls, seed, n_pairs, k_obj_max, n_seeds):
        return cls(jax.random.split(jax.random.PRNGKey(seed), n_pairs), k_obj_max, n_seeds)

    def key(self, site):
        if site[1] in ("pnp", "sim3"):
            return self.pair_keys[site[0]]
        if site[1] == "discover":
            # the live system's discovery key: fold_in(PRNGKey(seed), 100_000 + frame)
            return self.pair_keys[100_000 + site[0]]
        k_ego, k_obj = jax.random.split(self.pair_keys[site[0]])
        if site[1] == "ego":
            return k_ego
        k_rng = jax.random.split(k_obj, self.K)[site[2]]
        return k_rng if site[3] is None else jax.random.split(k_rng, self.S)[site[3]]

    def __call__(self, p, iters, sites, k=3):
        pn = p.cpu().numpy()
        idx = [np.asarray(jax.random.choice(self.key(s), pn.shape[1], shape=(iters, k),
                                            replace=True, p=jnp.asarray(pn[m])))
               for m, s in enumerate(sites.names())]
        return torch.from_numpy(np.stack(idx)).to(torch.int64).to(p.device)


class FoldInKeys:
    """The live system's step keys: ``fold_in(PRNGKey(seed), frame_idx)``."""

    def __init__(self, seed):
        self.root = jax.random.PRNGKey(seed)

    def __getitem__(self, frame_idx):
        return jax.random.fold_in(self.root, frame_idx)


def _t(a):
    return torch.from_numpy(np.array(a))


def _scene(seed, N=300, outliers=0.3):
    rng = np.random.default_rng(seed)
    uv = np.stack([rng.uniform(20, 620, N), rng.uniform(20, 360, N)], -1).astype(np.float32)
    depth = rng.uniform(3.0, 25.0, N).astype(np.float32)
    Xw = np.asarray(jcamera.backproject(jnp.asarray(uv), jnp.asarray(depth), FX, FY, CX, CY))
    T = np.asarray(jse3.exp_se3(jnp.asarray([0.01, -0.02, 0.005, 0.2, -0.05, 0.6])))
    xyz = Xw @ T[:3, :3].T + T[:3, 3]
    xyz[: int(outliers * N)] += rng.normal(0, 1.0, (int(outliers * N), 3))
    uv_cur = np.asarray(jcamera.project(jnp.asarray(xyz), FX, FY, CX, CY))
    valid = rng.uniform(size=N) < 0.9
    return Xw, uv_cur.astype(np.float32), xyz.astype(np.float32), valid, T


def test_rigid_align_matches():
    rng = np.random.default_rng(0)
    src = rng.normal(0, 3, (200, 3, 3)).astype(np.float32)
    T = np.asarray(jse3.exp_se3(jnp.asarray(rng.normal(0, 0.3, (200, 6)).astype(np.float32))))
    dst = np.einsum("nij,nkj->nki", T[:, :3, :3], src) + T[:, None, :3, 3]
    dst += rng.normal(0, 0.01, dst.shape).astype(np.float32)
    Tj = np.asarray(jhorn.rigid_align(jnp.asarray(src), jnp.asarray(dst)))
    Tt = thorn.rigid_align(_t(src), _t(dst)).numpy()
    # float32 power iteration: near-degenerate triples (a second eigenvalue
    # close to the first) converge a little apart in either package
    err = np.abs(Tt - Tj).reshape(200, -1).max(-1)
    assert np.mean(err < 1e-4) >= 0.98 and err.max() < 2e-3, np.sort(err)[-5:]


def test_count_inliers_and_gn_refine_match():
    Xw, uv, _, valid, T = _scene(1, outliers=0.0)
    Tp = np.asarray(jse3.exp_se3(jnp.asarray([0.001, 0.0, -0.001, 0.01, 0.02, -0.01]))) @ T
    inl_j, n_j = jransac._count_inliers(jnp.asarray(Tp), jnp.asarray(Xw), jnp.asarray(uv),
                                        jnp.asarray(valid), 3.0, FX, FY, CX, CY)
    inl_t, n_t = transac._count_inliers(_t(Tp)[None], _t(Xw)[None], _t(uv)[None],
                                        _t(valid)[None], 3.0, FX, FY, CX, CY)
    assert abs(int(n_t[0]) - int(n_j)) <= 2
    w = valid.astype(np.float32)
    Rj = np.asarray(jransac._gn_refine(jnp.asarray(Tp), jnp.asarray(Xw), jnp.asarray(uv),
                                       jnp.asarray(w), 10, FX, FY, CX, CY))
    Rt = transac._gn_refine(_t(Tp)[None], _t(Xw)[None], _t(uv)[None], _t(w)[None], 10,
                            FX, FY, CX, CY)[0].numpy()
    np.testing.assert_allclose(Rt, Rj, atol=1e-4)
    np.testing.assert_allclose(Rt, T, atol=1e-3)


@pytest.mark.parametrize("seed", [2, 5])
def test_ransac_with_jax_keyed_sampler_matches(seed):
    Xw, uv, xyz, valid, T = _scene(seed)
    key = jax.random.PRNGKey(seed)
    ref = jransac.ransac_rigid_pose(key, *map(jnp.asarray, (Xw, uv, xyz, valid)),
                                    FX, FY, CX, CY, thresh=0.3, iters=200, refine_iters=10)
    sampler = JaxKeySampler([key], 1, 1)
    # the ego site of pair 0 uses split(key)[0]; replay the raw key instead
    sampler.key = lambda site: key
    out = transac.ransac_rigid_pose(*(_t(a)[None] for a in (Xw, uv, xyz, valid)),
                                    FX, FY, CX, CY, sampler=sampler, sites=transac.Sites([(0, "ego")]),
                                    thresh=0.3, iters=200, refine_iters=10)
    np.testing.assert_allclose(out.T[0].numpy(), np.asarray(ref.T), atol=1e-4)
    assert abs(int(out.n_inliers[0]) - int(ref.n_inliers)) <= 2
    np.testing.assert_allclose(out.T[0].numpy(), T, atol=2e-3)


def test_multinomial_sampler_draws_only_valid_points():
    g = torch.Generator().manual_seed(0)
    p = torch.zeros(3, 50)
    p[0, [3, 7, 11]] = 1.0 / 3
    p[1, 20:] = 1.0 / 30
    idx = transac.MultinomialSampler(g)(p, 100, [(0, "ego")] * 3)
    assert idx.shape == (3, 100, 3)
    assert set(idx[0].unique().tolist()) <= {3, 7, 11}
    assert int(idx[1].min()) >= 20
    assert int(idx[2].max()) < 50          # an empty row draws uniformly
