"""The port's rBRIEF learner against the JAX package's (CPU).

Both packages' ``learn_brief_pattern`` on the same two 8-bit rendered
frames (``make_multimover_frames(2)``, 640x384), at a reduced candidate
pool, keypoint count and table width so the test stays small: the learned
tables must be identical (the features are exact on 8-bit input, and the
greedy selection is the same numpy loop).
"""

import numpy as np
import pytest
import torch

from multimot_track_tpu.frontend import orb as jorb
from multimot_track_tpu_torch.frontend import orb as torb
from multimot_track_tpu_torch.io.synth import make_multimover_frames

torch.set_num_threads(1)

KW = dict(n_bits=64, n_candidates=512, n_kp_per_image=256)


@pytest.fixture(scope="module")
def grays():
    return [np.round(f.gray).astype(np.float32) for f in make_multimover_frames(n_frames=2)]


def test_learned_pattern_identical(grays):
    pj = jorb.learn_brief_pattern(grays, **KW)
    pt = torb.learn_brief_pattern(grays, device="cpu", **KW)
    assert pt.shape == (KW["n_bits"], 2, 2) and pt.dtype == np.float32
    np.testing.assert_array_equal(pt, pj)


def test_learner_writes_nothing_and_default_table_unchanged(grays, tmp_path, monkeypatch):
    """The learner returns its table; ``brief_pattern`` reads only the one
    learned-pattern file both packages share."""
    monkeypatch.chdir(tmp_path)
    before = torb.brief_pattern().copy()
    torb.learn_brief_pattern(grays[:1], n_bits=16, n_candidates=64, n_kp_per_image=64,
                             device="cpu")
    assert not any(tmp_path.iterdir())
    np.testing.assert_array_equal(torb.brief_pattern(), before)
    np.testing.assert_array_equal(torb.brief_pattern(), jorb.brief_pattern())


def test_learner_runs_on_the_card_by_default(grays, monkeypatch):
    """As ``MultiMotSystem`` does: the default device is the card, and
    without one the learner raises instead of running on the CPU."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        torb.learn_brief_pattern(grays[:1], n_bits=16, n_candidates=64, n_kp_per_image=64)
