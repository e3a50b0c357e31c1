"""Six movers through a crossing at ``k_obj_max`` 8: the PyTorch port
against the JAX package's own gates (``tests/test_multimover.py``), CPU.

``make_multimover_frames(8)`` (six movers: crossing paths, a full occlusion
and reappearance, a birth, a death) at ``test_multimover._cfg(8)`` through
the port's ``MultiMotSystem(enable_keyframes=False, device="cpu")`` with its
own draws, once for the module.  The JAX test's gates, then the record
table against the JAX package's on the same frames and config
(``tools/behaviour_ref.json``, written by ``tools/behaviour_ref.py record``
from the JAX package on the CPU): labels, records' frames and track IDs
exactly, each label's median t-RPE within 1e-3, the camera's mean t-RPE
within 1e-5 (the exact scene makes both packages' draws agree that far).
"""

import numpy as np
import pytest
import torch

from torch_behaviour import assert_table_matches, br, by_label, run_multimover

torch.set_num_threads(1)

K_OBJ = 8


@pytest.fixture(scope="module")
def system():
    return run_multimover(K_OBJ)


def test_six_movers_tracked_k8(system):
    recs = [r for r in system.map.obj_records if r.has_gt]
    assert recs, "no ground-truth-matched object estimates"
    labels = by_label(system)
    assert len(labels) >= 4, sorted(labels)
    for sem, rs in labels.items():
        med = np.median([r.t_rpe_rel for r in rs])
        assert med < 0.10, (sem, med)
    sp = [r.speed_err_rel for r in recs if np.isfinite(r.speed_err_rel)]
    assert np.median(sp) < 0.20, np.median(sp)
    assert system.summary()["cam_t_rpe_rel_mean"] < 0.05


def test_id_stability_through_crossing(system):
    recs = [r for r in system.map.obj_records if r.has_gt]
    ids_1 = {r.track_id for r in recs if r.sem_label == 1}
    ids_2 = {r.track_id for r in recs if r.sem_label == 2}
    assert len(ids_1) == 1, ids_1
    assert ids_1.isdisjoint(ids_2), (ids_1, ids_2)
    f4 = [r.frame for r in recs if r.sem_label == 4]
    if f4:
        assert min(f4) >= 3
    f5 = [r.frame for r in recs if r.sem_label == 5]
    assert all(f <= 4 for f in f5), f5


def test_records_match_the_jax_package(system):
    assert_table_matches(br.multimover_table(system), br.load()[f"multimover_k{K_OBJ}"])
