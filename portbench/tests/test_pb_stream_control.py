"""The controls on the card: the stream cell's program with every float
input of each K1 call rounded to TF32's 10 mantissa bits (the precision
below the configuration's float32 with TF32 off, at the place where this
path computes) comes out not correct, while the program on the same seed
comes out correct.  One whole pass of the cell at its own size each,
through the run's own warm-up and window (a few minutes).  Run on the card:

    python -m pytest -m gpu portbench/tests/test_pb_stream_control.py
"""

from __future__ import annotations

import pytest

from portbench import calibrate_stream, harness, inputs

SEED = 2 ** 32 + 77


@pytest.mark.gpu
def test_stream_k1_tf32_inputs_control_is_not_correct(card):
    cell = harness.Cell("stream-junction")
    clean, _ = inputs.clean_frames(cell)
    entry = cell.entry()
    sound = calibrate_stream.reading(cell, entry, clean, SEED)
    control = calibrate_stream.reading(cell, entry, clean, SEED, control="k1-tf32-inputs")
    assert harness.verdict(sound, cell.limits)[0], sound
    assert not harness.verdict(control, cell.limits)[0], control
