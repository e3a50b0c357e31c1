"""A run with its timed path broken underneath comes out not correct.

Each test drives the rest of a run (set-up, window, the reference's
verdict with the cell's own limits) on the CPU at test size, past the
harness's look for a card, with one fault of ``portbench/faults.py``
planted in the program: a step that returns its state unchanged, half of
the object slots left out with the rest's mean in their place, an answer
altered where it is produced, the track-ID association left out.  The
sound run at the same size comes out correct, so the fault is what fails
it."""

from __future__ import annotations

import importlib.util

import pytest
import torch

from portbench import devtrace, faults, harness
from pbtest import REPO, small_root

SEED = 2 ** 33 + 11
N_FRAMES = 6


@pytest.fixture(scope="module")
def root(tmp_path_factory):
    return small_root(tmp_path_factory.mktemp("faults"), n_frames=N_FRAMES)


def _run(root):
    spec = importlib.util.spec_from_file_location("pb_run", REPO / "portbench" / "run.py")
    run = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(run)
    torch.set_num_threads(4)
    cell = harness.Cell("live-junction", root=root)
    # a window that ends the drive: its frames after the warm-up's
    kw = {"max_frames": N_FRAMES - cell.config["warmup_frames"]}
    result, _ = run.run_cell(cell, SEED, 0.0, False, device="cpu", **kw)
    return result


def test_the_sound_run_is_correct(root):
    result = _run(root)
    assert result["correct"], result["checks"]
    assert result["attempted"] == N_FRAMES - 2


@pytest.mark.parametrize("fault", ["live-stuck", "live-half", "live-altered", "live-ids"])
def test_a_fault_makes_the_run_not_correct(root, fault):
    patches = devtrace.Patches()
    faults.plant(fault, patches, altered_frame=2)
    try:
        result = _run(root)
    finally:
        patches.restore()
    assert not result["correct"], result["checks"]
