"""The control on the card: the live cell's program with TF32 products
and convolutions switched on (the precision below the configuration's
float32 with TF32 off) comes out not correct, while the program on the
same seed comes out correct.  One whole drive of the cell at its own size
each, through the run's own warm-up and window (a few minutes).  Run on the
card:

    python -m pytest -m gpu portbench/tests/test_pb_control.py
"""

from __future__ import annotations

import pytest

from portbench import calibrate, harness, inputs

SEED = 2 ** 32 + 77


@pytest.mark.gpu
def test_live_tf32_control_is_not_correct(card):
    cell = harness.Cell("live-junction")
    clean, _ = inputs.clean_frames(cell)
    entry = cell.entry()
    sound = calibrate.reading(cell, entry, clean, SEED)
    control = calibrate.reading(cell, entry, clean, SEED, control="tf32")
    assert harness.verdict(sound, cell.limits)[0], sound
    assert not harness.verdict(control, cell.limits)[0], control
