"""float32 against float64 in the port's flow-BA: the JAX package's own
gate ``tests/test_precision.py::test_flow_ba_f32_matches_f64``, CPU.

The problem is that file's (``synth()``: N = 1024 points at the KITTI
camera, 0.3 px flow noise, ``RNG`` seed 17, drawn through
``torch_seeding.seeded`` so the JAX module's generator is left alone),
solved by the port's plain ``solve_flow_ba`` at 60 iterations in float32
and in float64.  Gates, as there: the poses within 1e-4, at most 5 points
flip at the 0.04 chi2 gate, the float64 pose within 5e-3 of the truth.
The port's float32 pose is also held to the JAX package's float32 solve
within 1e-4, and ``tools/behaviour_ref.precision_problem`` (the builder
``chip_smoke.py`` phase 16(d) uses, no JAX) to the JAX file's problem.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import test_precision as jprec
from multimot_track_tpu_torch.solvers import flow_ba as tfb
from torch_behaviour import br
from torch_seeding import seeded

torch.set_num_threads(1)

T_TOL, MAX_FLIPS, TRUTH_TOL = 1e-4, 5, 5e-3


@pytest.fixture(scope="module")
def problem():
    return seeded(jprec, 17, jprec.synth)


def port_solve(problem, dtype):
    uv, z, flow, _ = problem
    t = lambda a: torch.as_tensor(np.asarray(a), dtype=dtype)[None]
    eye = torch.eye(4, dtype=dtype)[None]
    cam = jprec.CAM
    out = tfb.solve_flow_ba(eye, eye, t(uv), t(flow), t(z), torch.ones(1, len(z), dtype=torch.bool),
                            cam.fx, cam.fy, cam.cx, cam.cy,
                            tfb.FlowBAParams(iters=br.PRECISION_ITERS))
    return out.T[0].double().numpy(), out.chi2[0].double().numpy()


def test_flow_ba_f32_matches_f64(problem):
    T64, chi64 = port_solve(problem, torch.float64)
    T32, chi32 = port_solve(problem, torch.float32)
    assert np.abs(T32 - T64).max() < T_TOL, np.abs(T32 - T64).max()
    flips = int(np.sum((chi32 < br.PRECISION_GATE) != (chi64 < br.PRECISION_GATE)))
    assert flips <= MAX_FLIPS, flips
    assert np.abs(T64 - problem[3]).max() < TRUTH_TOL


def test_float32_solve_matches_the_jax_package(problem):
    Tj, _, _ = seeded(jprec, 17, jprec._solve, jnp.float32)
    T32, _ = port_solve(problem, torch.float32)
    assert np.abs(T32 - Tj).max() < T_TOL, np.abs(T32 - Tj).max()


def test_the_card_builds_the_same_problem(problem):
    """The same draws; the float32 projection rounds apart by at most two
    ulps of a coordinate near 1200 px (1.2e-4 px)."""
    for a, b, tol in zip(br.precision_problem(), problem, (0.0, 0.0, 2.5e-4, 2e-7)):
        np.testing.assert_allclose(a, b, rtol=0, atol=tol)
