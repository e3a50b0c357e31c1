"""A stream run with its timed path broken underneath comes out not correct.

Each test drives the rest of a run of the stream cell (set-up, window, the
verdict with the cell's own limits) on the CPU at test size, past the
harness's look for a card, with one fault of ``portbench/stream_faults.py``
planted in the program: the batched pair step returning its state
unchanged, half of each chunk's pairs and solved objects left out with the
rest's mean in their place, one pair's answer altered where it is produced,
the track-ID association left out.  The sound run at the same size comes
out correct, so the fault is what fails it."""

from __future__ import annotations

import importlib.util
import json

import pytest
import torch

from portbench import devtrace, harness, stream_faults
from pbtest import REPO, small_root

SEED = 2 ** 33 + 11
N_FRAMES = 5


@pytest.fixture(scope="module")
def root(tmp_path_factory):
    root = small_root(tmp_path_factory.mktemp("stream_faults"), n_frames=N_FRAMES)
    path = root / "portbench" / "configs" / "kitti03-rgbd-offline.json"
    cfg = json.loads(path.read_text())
    cfg["stream"]["chunk"] = 2                   # two chunks a pass, as in test_pb_stream
    path.write_text(json.dumps(cfg))
    return root


def _run(root):
    spec = importlib.util.spec_from_file_location("pb_run", REPO / "portbench" / "run.py")
    run = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(run)
    torch.set_num_threads(4)
    cell = harness.Cell("stream-junction", root=root)
    result, _ = run.run_cell(cell, SEED, 0.0, False, device="cpu", max_frames=N_FRAMES - 1)
    return result


def test_the_sound_run_is_correct(root):
    result = _run(root)
    assert result["correct"], result["checks"]
    assert result["attempted"] == N_FRAMES - 1


@pytest.mark.parametrize("fault", ["stream-stuck", "stream-half", "stream-altered",
                                   "stream-ids"])
def test_a_fault_makes_the_run_not_correct(root, fault):
    patches = devtrace.Patches()
    stream_faults.plant(fault, patches, altered_pair=2)
    try:
        result = _run(root)
    finally:
        patches.restore()
    assert not result["correct"], result["checks"]
