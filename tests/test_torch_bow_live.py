"""The live loop ladder through the BoW retrieval: the PyTorch port against
the JAX package (CPU), synchronous mode.

The 15-frame shuttle of ``test_torch_loop_live`` with ``bow_threshold = 3``
set on both systems' keyframe stores after construction, so every place
recognition from the fourth keyframe on goes through the two-stage BoW
path (the port replays the JAX package's vocabulary seed draw).  With at
most 7 keyframes the shortlist of 8 covers every candidate, so the loop
events are those of the exact path: closures at frames 11 and 13.

Tolerances: those of ``test_torch_loop_live.compare_loop_runs``.
"""

import pytest
import torch

from multimot_track_tpu.pipeline.system import MultiMotSystem as JSystem
from multimot_track_tpu_torch.pipeline.system import MultiMotSystem as TSystem
from test_torch_bow import jax_vocab_seed
from test_torch_live import JCFG, TCFG, jax_sampler
from test_torch_loop_live import LOOP_KW, _record_gba, compare_loop_runs, shuttle_frames

torch.set_num_threads(1)


@pytest.fixture(scope="module")
def bow_runs():
    frames = shuttle_frames()
    j = JSystem(JCFG, **LOOP_KW)
    t = TSystem(TCFG, sampler=jax_sampler(), device="cpu", **LOOP_KW)
    t.keyframes.vocab_seed = jax_vocab_seed
    out = []
    for s in (j, t):
        s.keyframes.bow_threshold = 3
        gba = _record_gba(s)
        for fd in frames:
            s.track_rgbd(fd)
        s.flush()
        out += [s, gba]
    return out


def test_bow_loop_ladder_matches_jax(bow_runs):
    j, gj, t, gt = bow_runs
    assert t.keyframes._voc is not None and j.keyframes._voc is not None
    compare_loop_runs(j, gj, t, gt)
    assert [e[:2] for e in t.map.loop_events] == [(11, 3), (13, 1)]
