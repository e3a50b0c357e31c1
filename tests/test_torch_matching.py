"""Parity of the port's descriptor matching with the JAX package (CPU).

Every comparison here is exact: Hamming distances of sign-form descriptors
are integers (exact in float32 on both sides), and the best / second /
index reductions must break ties as ``lax.top_k`` does (lowest index
first; a tied second equals the best).  The inputs are drawn from a small
pool of descriptors, so exact ties are common, and include invalid rows,
a row with every candidate masked, points exactly on the gate radius, and
query counts that are not multiples of 128.  ``match_float`` compares
unit vectors through a float32 product: its distances agree to 1e-5.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from multimot_track_tpu.ops import matching as jm
from multimot_track_tpu.ops.pallas_match import fused_match_projected
from multimot_track_tpu_torch.ops import matching as tm

torch.set_num_threads(1)


def _t(a):
    return torch.from_numpy(np.array(a))


def _pool_desc(rng, pool, n, flip_frac=0.5, max_flips=12):
    """n sign-form descriptors drawn from ``pool``; a fraction get a few bits
    flipped, the rest are exact copies (ties)."""
    d = pool[rng.integers(len(pool), size=n)].copy()
    for i in np.flatnonzero(rng.uniform(size=n) < flip_frac):
        bits = rng.choice(256, size=rng.integers(1, max_flips), replace=False)
        d[i, bits] *= -1
    return d


def projected_inputs(seed, N, M, radius, L=None):
    rng = np.random.default_rng(seed)
    pool = np.where(rng.uniform(size=(24, 256)) < 0.5, 1, -1).astype(np.int8)
    desc_b = _pool_desc(rng, pool, M)
    uv_b = np.round(rng.uniform(0, 160, (M, 2))).astype(np.float32)
    valid_b = rng.uniform(size=M) < 0.9
    shape = (N,) if L is None else (L, N)
    desc_a = _pool_desc(rng, pool, int(np.prod(shape))).reshape(shape + (256,))
    near = uv_b[rng.integers(M, size=shape)]
    uv_pred = (near + rng.normal(0, radius / 2, shape + (2,))).astype(np.float32)
    # exactly on the gate radius (integer positions: both sides exact)
    flat = uv_pred.reshape(-1, 2)
    flat[:8] = uv_b[:8] + np.array([radius, 0.0], np.float32)
    flat[8:12] = uv_b[8:12] + np.array([0.0, -radius], np.float32)
    flat[-1] = (1e4, 1e4)                      # every candidate out of range
    valid_a = rng.uniform(size=shape) < 0.9
    return desc_a, uv_pred, valid_a, desc_b, uv_b, valid_b


@pytest.mark.parametrize("N,M,radius", [(200, 300, 12.0), (333, 257, 6.0), (64, 1024, 15.0)])
def test_match_projected_equals_jax(N, M, radius):
    args = projected_inputs(N + M, N, M, radius)
    rj = jm.match_projected(*map(jnp.asarray, args), radius=radius)
    rt = tm.match_projected(*map(_t, args), radius=radius)
    np.testing.assert_array_equal(rt.idx.numpy(), np.asarray(rj.idx))
    np.testing.assert_array_equal(rt.dist.numpy(), np.asarray(rj.dist))
    np.testing.assert_array_equal(rt.valid.numpy(), np.asarray(rj.valid))
    assert rt.dist[-1] == 1e9 and rt.idx[-1] == 0 and not rt.valid[-1]
    # ties really happened: some best distances repeat within a row's gate
    best, second, _ = tm.match_projected_plain(*map(_t, args), radius=radius)
    assert bool(((best == second) & (best < 1e9)).any())


@pytest.mark.parametrize("N,M,radius", [(256, 300, 12.0), (128, 1024, 6.0)])
def test_plain_k2_equals_pallas_interpret(N, M, radius):
    """The plain version of K2 against the TPU kernel itself, run by the
    Pallas interpreter (its query count must be a multiple of 128)."""
    args = projected_inputs(7 * N + M, N, M, radius)
    bj, sj, ij = fused_match_projected(*map(jnp.asarray, args), radius=radius, interpret=True)
    bt, st, it = tm.match_projected_plain(*map(_t, args), radius=radius)
    np.testing.assert_array_equal(bt.numpy(), np.asarray(bj))
    np.testing.assert_array_equal(st.numpy(), np.asarray(sj))
    np.testing.assert_array_equal(it.numpy(), np.asarray(ij))


def test_batched_plain_k2_equals_per_batch():
    """The fuse scan's form: (L, N) queries against one reference set."""
    args = projected_inputs(3, 100, 150, 6.0, L=4)
    bt, st, it = tm.match_projected_plain(*map(_t, args), radius=6.0)
    for l in range(4):
        rj = jm.match_projected(*(jnp.asarray(a[l]) for a in args[:3]),
                                *map(jnp.asarray, args[3:]), radius=6.0)
        np.testing.assert_array_equal(it[l].numpy(), np.asarray(rj.idx))
        np.testing.assert_array_equal(bt[l].numpy(), np.asarray(rj.dist))


def test_match_projected_auto_routes_and_refuses():
    args = tuple(map(_t, projected_inputs(5, 50, 60, 12.0)))
    a = tm.match_projected_auto(*args, radius=12.0)
    b = tm.match_projected(*args, radius=12.0)
    for x, y in zip(a, b):
        assert torch.equal(x, y)
    with pytest.raises(ValueError, match="CUDA"):
        tm.match_projected_auto(*args, radius=12.0, backend="cuda")
    with pytest.raises(ValueError, match="backend"):
        tm.match_projected_auto(*args, radius=12.0, backend="pallas")


def _desc_sets(seed, N, M):
    rng = np.random.default_rng(seed)
    pool = np.where(rng.uniform(size=(40, 256)) < 0.5, 1, -1).astype(np.int8)
    return (_pool_desc(rng, pool, N, max_flips=40), _pool_desc(rng, pool, M, max_flips=40),
            rng.uniform(size=N) < 0.9, rng.uniform(size=M) < 0.85)


@pytest.mark.parametrize("mutual,threshold", [(True, 50.0), (False, 50.0), (True, 100.0)])
def test_match_descriptors_equals_jax(mutual, threshold):
    args = _desc_sets(11, 300, 250)
    rj = jm.match_descriptors(*map(jnp.asarray, args), threshold=threshold, mutual=mutual)
    rt = tm.match_descriptors(*map(_t, args), threshold=threshold, mutual=mutual)
    np.testing.assert_array_equal(rt.idx.numpy(), np.asarray(rj.idx))
    np.testing.assert_array_equal(rt.dist.numpy(), np.asarray(rj.dist))
    np.testing.assert_array_equal(rt.valid.numpy(), np.asarray(rj.valid))
    assert rt.valid.any()


def test_match_descriptors_batched_equals_single():
    a, b, va, vb = _desc_sets(12, 120, 130)
    b2, _, vb2, _ = _desc_sets(13, 130, 1)
    stack, vstack = np.stack([b, b2]), np.stack([vb, vb2])
    rt = tm.match_descriptors(_t(a)[None], _t(stack), _t(va)[None], _t(vstack))
    for k in range(2):
        rj = jm.match_descriptors(jnp.asarray(a), jnp.asarray(stack[k]), jnp.asarray(va),
                                  jnp.asarray(vstack[k]))
        np.testing.assert_array_equal(rt.valid[k].numpy(), np.asarray(rj.valid))
        np.testing.assert_array_equal(rt.idx[k].numpy(), np.asarray(rj.idx))


def test_rotation_consistency_equals_jax():
    rng = np.random.default_rng(4)
    N, M = 400, 300
    angle_a = rng.uniform(-np.pi, np.pi, N).astype(np.float32)
    angle_b = rng.uniform(-np.pi, np.pi, M).astype(np.float32)
    idx = rng.integers(M, size=N).astype(np.int32)
    # a dominant rotation so the histogram has clear and tied peaks
    angle_a[:150] = (angle_b[idx[:150]] + 0.3).astype(np.float32)
    angle_a[150:180] = (angle_b[idx[150:180]] - 2.0).astype(np.float32)
    angle_a[180:190] = angle_b[idx[180:190]]
    valid = rng.uniform(size=N) < 0.8
    for keep in (1, 3):
        kj = jm.rotation_consistency(*map(jnp.asarray, (angle_a, angle_b, idx, valid)),
                                     keep_bins=keep)
        kt = tm.rotation_consistency(_t(angle_a), _t(angle_b), _t(idx).long(), _t(valid),
                                     keep_bins=keep)
        np.testing.assert_array_equal(kt.numpy(), np.asarray(kj))


def test_search_by_quad_equals_jax():
    rng = np.random.default_rng(8)
    N, M = 150, 170
    pool = np.where(rng.uniform(size=(30, 256)) < 0.5, 1, -1).astype(np.int8)
    dL0, dR0 = _pool_desc(rng, pool, N), _pool_desc(rng, pool, N)
    dL1, dR1 = _pool_desc(rng, pool, M), _pool_desc(rng, pool, M)
    uv_L1 = np.round(rng.uniform(0, 100, (M, 2))).astype(np.float32)
    uv_pred = (uv_L1[rng.integers(M, size=N)] + rng.normal(0, 5, (N, 2))).astype(np.float32)
    v0, v1 = rng.uniform(size=N) < 0.9, rng.uniform(size=M) < 0.9
    args = (dL0, dR0, dL1, dR1, uv_pred, uv_L1, v0, v1)
    rj = jm.search_by_quad(*map(jnp.asarray, args), radius=15.0, threshold=100.0)
    rt = tm.search_by_quad(*map(_t, args), radius=15.0, threshold=100.0)
    np.testing.assert_array_equal(rt.idx.numpy(), np.asarray(rj.idx))
    np.testing.assert_array_equal(rt.dist.numpy(), np.asarray(rj.dist))
    np.testing.assert_array_equal(rt.valid.numpy(), np.asarray(rj.valid))


def test_match_float_matches_jax():
    rng = np.random.default_rng(9)
    a = rng.normal(size=(200, 64)).astype(np.float32)
    b = np.concatenate([a[:120] + rng.normal(0, 0.05, (120, 64)),
                        rng.normal(size=(80, 64))]).astype(np.float32)
    a /= np.linalg.norm(a, axis=1, keepdims=True)
    b /= np.linalg.norm(b, axis=1, keepdims=True)
    va, vb = rng.uniform(size=200) < 0.9, rng.uniform(size=200) < 0.9
    rj = jm.match_float(*map(jnp.asarray, (a, b, va, vb)))
    rt = tm.match_float(*map(_t, (a, b, va, vb)))
    np.testing.assert_array_equal(rt.idx.numpy(), np.asarray(rj.idx))
    np.testing.assert_array_equal(rt.valid.numpy(), np.asarray(rj.valid))
    np.testing.assert_allclose(rt.dist.numpy(), np.asarray(rj.dist), atol=1e-5)
