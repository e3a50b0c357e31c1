"""The port's tests leave the JAX test modules' fixture generators alone.

``tests/test_window_ba.py``, ``test_parallel.py``, ``test_graphcut.py`` and
``test_multi_window.py`` draw their fixtures from a module-level
``np.random.Generator``.  When a port test called one of their makers without
reseeding, a JAX test that ran after it in the same process solved another
problem (``test_window_ba_refines_poses`` failed after two earlier
``make_window`` calls).  Each port maker here goes through
``torch_seeding.seeded``: the module's generator state is the same before and
after it, and the maker's output does not depend on what ran before.
"""

import numpy as np
import pytest

import test_graphcut
import test_multi_window
import test_parallel
import test_torch_discovery
import test_torch_parallel
import test_torch_window
import test_window_ba

CASES = {
    "parallel-solvers/test_parallel": (test_parallel, test_torch_parallel.solver_problems),
    "parallel-solvers/test_window_ba": (test_window_ba, test_torch_parallel.solver_problems),
    "window-solver/test_window_ba": (test_window_ba, test_torch_window.make_solver_window),
    "multiwindow/test_multi_window": (test_multi_window, test_torch_window.make_multiwindow),
    "discovery/test_graphcut": (test_graphcut, test_torch_discovery._two_motion_problem),
}


def _arrays(x):
    """The numpy arrays inside a fixture's (nested) output, in order."""
    if isinstance(x, np.ndarray):
        return [x]
    if isinstance(x, dict):
        return [a for v in x.values() for a in _arrays(v)]
    if isinstance(x, (list, tuple)):
        return [a for v in x for a in _arrays(v)]
    return [np.asarray(x)] if hasattr(x, "shape") else []


@pytest.mark.parametrize("case", list(CASES))
def test_port_fixtures_leave_the_jax_test_generators_alone(case, monkeypatch):
    module, make = CASES[case]
    before = module.RNG.bit_generator.state
    first = _arrays(make())
    assert module.RNG.bit_generator.state == before
    # the same output after the module's generator has moved on (a
    # stand-in generator, so this test moves none of the module's)
    moved = np.random.default_rng(12345)
    moved.standard_normal(7)
    monkeypatch.setattr(module, "RNG", moved)
    state = moved.bit_generator.state
    again = _arrays(make())
    assert module.RNG is moved and moved.bit_generator.state == state
    assert len(first) == len(again) > 0
    for a, b in zip(first, again):
        np.testing.assert_array_equal(a, b)
