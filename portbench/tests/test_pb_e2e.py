"""The end-to-end arithmetic, the seeds, the guards and the verdict."""

from __future__ import annotations

import json
import subprocess
import sys
import types

import pytest

from portbench import harness
from pbtest import REPO


def _reader(name):
    return harness.load_module(REPO / "portbench" / "metrics" / f"{name}.py", "metric")


def _live(dts):
    return {"kind": "live", "wall_s": sum(dts),
            "frames": [{"dt": d, "upload_s": 0.04, "stages": {}, "profiled": False}
                       for d in dts]}


def test_one_stall_moves_the_rate_and_the_p90():
    """100 frames at 0.5 s; then 11 of them stalled by 1.5 s each: the rate
    takes all the window's time, the p90 all its (unprofiled) frames, so
    both move."""
    steady = _live([0.5] * 100)
    stalled = _live([0.5] * 89 + [2.0] * 11)
    rate, p90 = _reader("live_ms_per_frame"), _reader("live_frame_ms_p90")
    assert rate.read(steady) == pytest.approx(500.0)
    assert p90.read(steady) == pytest.approx(500.0)
    assert rate.read(stalled) == pytest.approx(1e3 * (89 * 0.5 + 11 * 2.0) / 100)
    assert p90.read(stalled) == pytest.approx(2000.0)


def test_one_stall_moves_the_rate_but_not_the_p90():
    stalled = _live([0.5] * 99 + [10.0])
    assert _reader("live_ms_per_frame").read(stalled) == pytest.approx(595.0)
    assert _reader("live_frame_ms_p90").read(stalled) == pytest.approx(500.0)


def test_the_p90_leaves_out_the_profiled_frames():
    rec = _live([0.5] * 90 + [3.0] * 10)
    for f in rec["frames"][-10:]:
        f["profiled"] = True
    assert _reader("live_frame_ms_p90").read(rec) == pytest.approx(500.0)
    assert _reader("live_ms_per_frame").read(rec) == pytest.approx(750.0)


def test_nearest_rank():
    assert harness.nearest_rank(range(1, 101), 0.9) == 90
    assert harness.nearest_rank([3.0], 0.9) == 3.0


def test_seeds_past_32_bits_are_distinct_and_repeatable():
    a = harness.derive_seed(2 ** 31 + 5, "drive", 0)
    assert a == harness.derive_seed(2 ** 31 + 5, "drive", 0)
    assert a != harness.derive_seed(5, "drive", 0) != harness.derive_seed(2 ** 31 + 5, "drive", 1)
    assert 0 <= a < 2 ** 63


def test_the_guard_names_jax_and_the_jax_package_but_not_the_port(monkeypatch):
    monkeypatch.setitem(sys.modules, "multimot_track_tpu_torch_fake", types.ModuleType("x"))
    before = harness.forbidden_modules()
    monkeypatch.setitem(sys.modules, "multimot_track_tpu.config", types.ModuleType("y"))
    monkeypatch.setitem(sys.modules, "jax", types.ModuleType("jax"))
    assert set(harness.forbidden_modules()) - set(before) == {"jax", "multimot_track_tpu"}


def test_a_run_without_a_card_exits_non_zero_and_prints_nothing():
    import torch

    if torch.cuda.is_available():
        pytest.skip("this host has a card")
    p = subprocess.run([sys.executable, "portbench/run.py", "--workload", "live-junction",
                        "--seed", str(2 ** 33), "--seconds", "1", "--trace", "0"],
                       cwd=REPO, capture_output=True, text=True, timeout=120)
    assert p.returncode != 0 and p.stdout.strip() == ""
    assert "CUDA" in p.stderr


def test_verdict_fails_missing_and_non_finite_numbers():
    limits = {"numbers": {"a": {"limit": 1.0}, "b": {"limit": 1.0}}}
    assert harness.verdict({"a": 0.5, "b": 1.0}, limits)[0]
    assert not harness.verdict({"a": 0.5, "b": 1.5}, limits)[0]
    assert not harness.verdict({"a": 0.5}, limits)[0]
    assert not harness.verdict({"a": 0.5, "b": float("inf")}, limits)[0]
    json.dumps(harness.verdict({"a": float("nan"), "b": 0.0}, limits)[1])
