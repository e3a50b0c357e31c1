"""Reseeding for the JAX package's test fixtures that the port's tests borrow.

Several of the JAX package's test modules draw their fixtures from a
module-level generator (``RNG = np.random.default_rng(seed)``), so what a
fixture maker returns depends on how many draws came before it in the same
process.  Under ``pytest-xdist --dist loadfile`` one worker may run such a
module after a port test that called its maker, and then the module's own
tests solve another problem than they were written for.  Every port test
that calls such a maker does it through ``seeded``: the maker draws from a
fresh generator at the module's own seed, and the module's generator is
left where it was.
"""

from __future__ import annotations

import contextlib

import numpy as np
import pytest


@contextlib.contextmanager
def reseeded(module, seed):
    """Inside the block ``module.RNG`` is a fresh generator at ``seed``;
    after it, the module's own generator is back, not advanced."""
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(module, "RNG", np.random.default_rng(seed))
        yield


def seeded(module, seed, make, *args, **kwargs):
    """``make(*args, **kwargs)`` with ``module.RNG`` reseeded at ``seed``."""
    with reseeded(module, seed):
        return make(*args, **kwargs)
