"""Kernel K1's module: the port's plain flow-BA against the JAX package and
its Pallas kernel (CPU), and the backend dispatch.  The CUDA kernel itself
is held to the plain version in tests/test_torch_kernels.py (GPU).

Tolerance: T atol 2e-4, inlier counts +-2, mean reprojection rtol 5 % — the
contract the JAX package holds its Pallas kernel to against XLA
(tests/test_flow_ba_pallas.py): float32 sums taken in another order.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from multimot_track_tpu.solvers.flow_ba import FlowBAParams as JParams
from multimot_track_tpu.solvers.flow_ba import solve_flow_ba as j_solve
from multimot_track_tpu.solvers.flow_ba_pallas import solve_flow_ba_pallas
from multimot_track_tpu_torch.solvers import flow_ba as tfb
from test_flow_ba_pallas import CX, CY, FX, FY, _make_problem

torch.set_num_threads(1)

T_ATOL, N_TOL, REPROJ_RTOL = 2e-4, 2, 0.05


def _t(a):
    return torch.from_numpy(np.array(a))


def _weights(depth):
    return (1.0 / (1.0 + (depth / 15.0) ** 2)).astype(np.float32)


def _check(out_T, out_n, out_rp, ref):
    np.testing.assert_allclose(out_T, np.asarray(ref.T), atol=T_ATOL)
    assert abs(int(out_n) - int(ref.n_inliers)) <= N_TOL
    np.testing.assert_allclose(float(out_rp), float(ref.mean_reproj), rtol=REPROJ_RTOL,
                               atol=1e-4)


@pytest.mark.parametrize("weighted", [False, True])
@pytest.mark.parametrize("seed", [0, 3])
def test_torch_solver_matches_jax_and_pallas(seed, weighted):
    uv, flow, depth, valid, T_true = _make_problem(seed)
    pw = _weights(depth) if weighted else None
    jargs = (jnp.eye(4), jnp.eye(4), jnp.asarray(uv), jnp.asarray(flow), jnp.asarray(depth),
             jnp.asarray(valid), FX, FY, CX, CY)
    jpw = None if pw is None else jnp.asarray(pw)
    ref = j_solve(*jargs, params=JParams(iters=40), point_weight=jpw)
    pal = solve_flow_ba_pallas(*jargs, params=JParams(iters=40), interpret=True,
                               point_weight=jpw)
    eye = _t(np.eye(4, dtype=np.float32))[None]
    out = tfb.solve_flow_ba(eye, eye, _t(uv)[None], _t(flow)[None], _t(depth)[None],
                            _t(valid)[None], FX, FY, CX, CY,
                            params=tfb.FlowBAParams(iters=40),
                            point_weight=None if pw is None else _t(pw)[None])
    assert np.linalg.norm(out.T[0, :3, 3].numpy() - T_true[:3, 3]) < 5e-3
    for r in (ref, pal):
        _check(out.T[0].numpy(), out.n_inliers[0], out.mean_reproj[0], r)
    # the final chi2 is unweighted in every backend
    np.testing.assert_allclose(out.chi2[0].numpy()[valid], np.asarray(ref.chi2)[valid],
                               rtol=1e-3, atol=1e-5)


def test_batched_solver_matches_vmap_with_per_instance_freezing():
    """Instances converge after different iteration counts; each must freeze
    where vmap-of-while_loop freezes it.  Different caps via instance 2's
    much larger initial error."""
    probs = [_make_problem(s, N=128, n_valid=100) for s in (1, 2, 7)]
    T0 = np.stack([np.eye(4, dtype=np.float32)] * 3)
    T0[2, :3, 3] = [0.5, -0.2, 0.3]
    stack = lambda i: np.stack([p[i] for p in probs])
    uv, flow, depth, valid = stack(0), stack(1), stack(2), stack(3)
    pw = _weights(depth)
    ref = jax.vmap(lambda t0, u, f, d, v, w: j_solve(
        t0, jnp.eye(4), u, f, d, v, FX, FY, CX, CY, params=JParams(iters=30), point_weight=w
    ))(*map(jnp.asarray, (T0, uv, flow, depth, valid, pw)))
    eye = _t(np.eye(4, dtype=np.float32)).expand(3, 4, 4)
    out = tfb.solve_flow_ba(_t(T0), eye, _t(uv), _t(flow), _t(depth), _t(valid),
                            FX, FY, CX, CY, params=tfb.FlowBAParams(iters=30),
                            point_weight=_t(pw))
    for k in range(3):
        _check(out.T[k].numpy(), out.n_inliers[k], out.mean_reproj[k],
               jax.tree_util.tree_map(lambda x: x[k], ref))


def test_dispatch_auto_cpu_uses_plain_version_and_cuda_on_cpu_raises():
    uv, flow, depth, valid, _ = _make_problem(0, N=64, n_valid=60)
    eye = _t(np.eye(4, dtype=np.float32))[None]
    args = (eye, eye, _t(uv)[None], _t(flow)[None], _t(depth)[None], _t(valid)[None],
            FX, FY, CX, CY)
    p = tfb.FlowBAParams(iters=10)
    a = tfb.solve_flow_ba_auto(*args, params=p, backend="auto")
    b = tfb.solve_flow_ba(*args, params=p)
    np.testing.assert_array_equal(a.T.numpy(), b.T.numpy())
    with pytest.raises(ValueError, match="CUDA"):
        tfb.solve_flow_ba_auto(*args, params=p, backend="cuda")
    with pytest.raises(ValueError, match="backend"):
        tfb.solve_flow_ba_auto(*args, params=p, backend="pallas")


@pytest.mark.parametrize("name, route", [("auto", "auto"), ("xla", "torch"), ("pallas", "cuda"),
                                         ("torch", "torch"), ("cuda", "cuda")])
def test_route_translates_the_config_names(name, route):
    """``SolverConfig.flow_ba_backend`` keeps the JAX package's names."""
    assert tfb.flow_ba_route(name) == route


def _solver_cfg(**solver):
    import dataclasses

    from multimot_track_tpu_torch import config as C

    D = C.DEFAULT_CONFIG
    return dataclasses.replace(D, solver=dataclasses.replace(D.solver, **solver))


def test_pairwise_reads_the_jax_route_names():
    """``flow_ba_backend="xla"`` (the JAX package's plain solver) is the
    plain version here: on CPU tensors exactly what ``"auto"`` returns."""
    from multimot_track_tpu_torch.parallel import pairwise
    from multimot_track_tpu_torch.solvers import ransac

    probs = [_make_problem(s, N=256, n_valid=240) for s in (4, 5)]
    uv, flow, depth, valid = (_t(np.stack([p[i] for p in probs])) for i in range(4))

    def solve(name):
        sampler = ransac.MultinomialSampler(torch.Generator().manual_seed(9))
        cfg = _solver_cfg(flow_ba_backend=name, ransac_iters=64, cam_lm_iters=20)
        return pairwise.solve_relative_batch(sampler, range(2), uv, flow, depth, uv + flow,
                                             depth, valid, cfg).numpy()

    np.testing.assert_array_equal(solve("xla"), solve("auto"))


def test_tracker_and_pairwise_share_the_route(monkeypatch):
    """The tracker translates the config's name with the function pairwise
    uses: ``"xla"`` reaches every flow-BA solve of a pair as ``"torch"``."""
    import dataclasses

    from multimot_track_tpu_torch.io.synth import make_multimover_frames, synth_camera_config
    from multimot_track_tpu_torch.parallel import pairwise
    from multimot_track_tpu_torch.pipeline import batch, tracker

    assert tracker.flow_ba_route is tfb.flow_ba_route
    assert pairwise.flow_ba_route is tfb.flow_ba_route
    seen, solve = [], tracker.solve_flow_ba_auto

    def recorded(*args, backend="auto", **kwargs):
        seen.append(backend)
        return solve(*args, backend=backend, **kwargs)

    monkeypatch.setattr(tracker, "solve_flow_ba_auto", recorded)
    cfg = _solver_cfg(flow_ba_backend="xla")
    cfg = dataclasses.replace(cfg, camera=synth_camera_config(), padding=dataclasses.replace(
        cfg.padding, n_static_max=1024, n_obj_pts_max=4096, k_obj_max=4, k_obj_solve=2))
    batch.run_sequence_batched(make_multimover_frames(n_frames=2), cfg, seed=1, device="cpu")
    assert len(seen) == 5 and set(seen) == {"torch"}
