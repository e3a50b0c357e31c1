"""Six movers into four slots: the PyTorch port against the JAX package's
own gate ``tests/test_multimover.py::test_slot_exhaustion_k4``, CPU.

``make_multimover_frames(8)`` at ``test_multimover._cfg(4)`` through the
port's ``MultiMotSystem(enable_keyframes=False, device="cpu")`` with its own
draws, once for the module: labels beyond ``k_obj_max`` are dropped, the
in-range movers still track.  Then the record table against the JAX
package's (``tools/behaviour_ref.json``), with the tolerances of
``test_torch_multimover_k8.py``.
"""

import numpy as np
import pytest
import torch

from torch_behaviour import assert_table_matches, br, by_label, run_multimover

torch.set_num_threads(1)

K_OBJ = 4


@pytest.fixture(scope="module")
def system():
    return run_multimover(K_OBJ)


def test_slot_exhaustion_k4(system):
    recs = [r for r in system.map.obj_records if r.has_gt]
    assert recs
    assert all(r.sem_label <= K_OBJ for r in recs)
    labels = by_label(system)
    assert len(labels) >= 3
    for sem, rs in labels.items():
        assert np.median([r.t_rpe_rel for r in rs]) < 0.10
    assert np.isfinite(system.summary()["cam_t_rpe_rel_mean"])


def test_records_match_the_jax_package(system):
    assert_table_matches(br.multimover_table(system), br.load()[f"multimover_k{K_OBJ}"])
