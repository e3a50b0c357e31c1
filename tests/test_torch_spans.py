"""The live system's spans (``utils/profiling._StageCtx`` and ``span``) on the
CPU.

A short live run (``make_multimover_frames(4)`` at the window test's
setting: ``test_torch_live.slice_config`` with the trailing-window and
joint window BA on, window of 3, a keyframe every frame, loop closing off)
records every span of the live path under its path, nested as the spans
are opened; its last frame runs under a CPU ``torch.profiler`` session, in
which each span is a ``mmt:`` range and the root ``track_rgbd`` is given
the frame index; on the frames before it no profiler range is opened.
Also: ``span`` outside every span, ``upload`` on a second thread, and the
cost of one span.
"""

import sys
import threading
import time

import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from multimot_track_tpu_torch import config as tconfig
from multimot_track_tpu_torch.io.synth import make_multimover_frames
from multimot_track_tpu_torch.io.synth import synth_camera_config as t_synth_cam
from multimot_track_tpu_torch.pipeline import step_graph
from multimot_track_tpu_torch.pipeline.system import MultiMotSystem
from multimot_track_tpu_torch.utils import profiling
from test_torch_live import slice_config

torch.set_num_threads(1)

CFG = slice_config(tconfig, t_synth_cam(), window_refine=True, joint_window_refine=True,
                   window_size=3)
# each span of the live path, under the span it opens in ("": a stage,
# named by its own name)
PARENT = {
    "upload": "", "dispatch_pair": "", "features": "", "refine_prep": "", "local_map": "",
    "window_refine": "", "fetch_result": "", "record": "", "keyframe_add": "", "joint_ba": "",
    **{f"dispatch_pair/{c}": "dispatch_pair"
       for c in ("frontend", "ego", "segment", "objects", "finish", "gt_eval")},
    "local_map/match": "local_map", "local_map/gn": "local_map",
    "window_refine/tracks": "window_refine", "window_refine/lm": "window_refine",
    **{f"joint_ba/{c}": "joint_ba" for c in ("problem", "jacobian", "solve", "fetch")},
}
# the names the stage timer had before the spans went inside the layers
STAGES = ("upload", "dispatch_pair", "features", "local_map", "window_refine",
          "fetch_result", "record", "keyframe_add", "joint_ba")
# a span's children cover at least this share of its host time
COVER = 0.9


class RangeLog:
    """``torch.profiler.record_function`` that logs (name, args) of every
    range opened and opens it."""

    def __init__(self, real):
        self.real, self.opened = real, []

    def __call__(self, name, args=None):
        self.opened.append((name, args))
        return self.real(name, args)


@pytest.fixture(scope="module")
def live():
    """The run: frames 0-2 with no profiler, frame 3 under a CPU profile."""
    frames = make_multimover_frames(n_frames=4)
    s = MultiMotSystem(CFG, keyframe_gap=1, enable_loop_closing=False, device="cpu")
    log = RangeLog(torch.profiler.record_function)
    mp = pytest.MonkeyPatch()
    mp.setattr(torch.profiler, "record_function", log)
    try:
        for fd in frames[:-1]:
            s.track_rgbd(fd)
        unprofiled = list(log.opened)
        with profile(activities=[ProfilerActivity.CPU]) as prof:
            s.track_rgbd(frames[-1])
        s.flush()
    finally:
        mp.undo()
    events = [(e.name(), e.start_ns(), e.start_ns() + e.duration_ns())
              for e in prof.profiler.kineto_results.events()
              if e.name().startswith(profiling.SPAN_PREFIX)]
    return s, unprofiled, log.opened, events


def test_span_paths_nest_as_the_live_path_opens_them(live):
    s = live[0]
    report = s.stage_report()
    assert set(PARENT) | {"track_rgbd"} <= set(report)
    assert report["track_rgbd"]["n"] == 4
    assert report["upload"]["n"] == 4                       # once a frame, not twice
    for path in report:
        head, _, _ = path.rpartition("/")
        assert head == PARENT.get(path, head), path
        assert head == "" or head in report, path


def test_every_stage_name_stays_and_no_name_without_calls(live):
    s = live[0]
    report = s.stage_report()
    assert set(STAGES) <= set(report)
    assert all(v["n"] > 0 for v in report.values())
    fresh = MultiMotSystem(CFG, device="cpu")
    assert fresh.stage_times == {"upload": []} and fresh.stage_report() == {}


def test_children_cover_their_parents_host_time(live):
    t = {k: sum(v) for k, v in live[0].stage_times.items()}
    for parent in ("dispatch_pair", "local_map", "window_refine", "joint_ba"):
        kids = sum(v for k, v in t.items() if k.rpartition("/")[0] == parent)
        assert kids >= COVER * t[parent], (parent, kids, t[parent])


def test_profiler_ranges_only_while_a_profiler_runs(live):
    _, unprofiled, opened, events = live
    assert unprofiled == []
    names = {n for n, _, _ in events}
    assert {profiling.SPAN_PREFIX + p for p in [*PARENT, "track_rgbd"]} <= names
    roots = [(n, a) for n, a in opened if n == "mmt:track_rgbd"]
    assert roots == [("mmt:track_rgbd", "3")]               # the frame index
    # every range lies inside the root's, and a child inside its parent's
    spans = {n: (a, b) for n, a, b in events}
    r0, r1 = spans["mmt:track_rgbd"]
    for n, a, b in events:
        assert r0 <= a and b <= r1, n
    p0, p1 = spans["mmt:dispatch_pair"]
    c0, c1 = spans["mmt:dispatch_pair/ego"]
    assert p0 <= c0 and c1 <= p1


def test_the_cpu_pair_step_runs_eagerly_on_every_frame(live):
    """The tape of CUDA graphs (``pipeline/step_graph``) engages on the card
    alone: on the CPU every pair counts ``replayed`` 0 under
    ``dispatch_pair`` and the tape holds no signature."""
    s = live[0]
    assert s.stage_counts["dispatch_pair/replayed"] == [0, 0, 0]
    assert s._step_tape._key is None and s._step_tape._tape is None
    assert step_graph._generators(s.sampler, None, []) is None     # a CPU generator


def test_span_outside_every_span_records_nothing_and_opens_no_range(monkeypatch):
    log = RangeLog(torch.profiler.record_function)
    monkeypatch.setattr(torch.profiler, "record_function", log)
    acc = {}
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        with profiling.span("stray"):
            torch.ones(4) + 1
        with profiling._StageCtx(acc, "stage"):
            with profiling.span("inner"):
                with profiling._StageCtx(acc, "stage_in_stage"):
                    pass
        with profiling.span("after"):
            pass
    assert profiling.span("x") is profiling.span("y")       # the one null context
    # a stage keeps its own name wherever it opens; span() nests
    assert set(acc) == {"stage", "stage/inner", "stage_in_stage"}
    names = [e.name() for e in prof.profiler.kineto_results.events()]
    assert "mmt:stray" not in names and "mmt:after" not in names
    assert [n for n, _ in log.opened] == ["mmt:stage", "mmt:stage/inner",
                                          "mmt:stage_in_stage"]


def test_upload_on_a_second_thread_while_the_live_thread_reads():
    """The prefetch thread's ``upload`` appends to ``stage_times`` while the
    live thread opens new spans and reads the dict, with a short switch
    interval: nothing raises, and every call is recorded once."""
    frames = make_multimover_frames(n_frames=1)
    s = MultiMotSystem(CFG, device="cpu")
    n, errors = 40, []

    def prefetch():
        try:
            for _ in range(n):
                s.upload(frames[0])
        except Exception as e:          # reported by the assertion below
            errors.append(e)

    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        th = threading.Thread(target=prefetch)
        th.start()
        k, deadline = 0, time.perf_counter() + 120
        while th.is_alive() and time.perf_counter() < deadline:
            with profiling._StageCtx(s.stage_times, "track_rgbd"):
                with s._stage(f"stage_{k % 50}"):
                    pass
            {name: len(v) for name, v in s.stage_times.items()}
            s.stage_report()
            k += 1
        th.join(timeout=60)
    finally:
        sys.setswitchinterval(old)
    assert not th.is_alive() and errors == []
    assert len(s.stage_times["upload"]) == n
    assert not any(name.endswith("/upload") for name in s.stage_times)


def test_one_span_costs_little():
    acc, n = {}, 20000
    with profiling._StageCtx(acc, "track_rgbd"):
        t0 = time.perf_counter()
        for _ in range(n):
            with profiling.span("x"):
                pass
        on = (time.perf_counter() - t0) / n * 1e6
    t0 = time.perf_counter()
    for _ in range(n):
        with profiling.span("x"):
            pass
    off = (time.perf_counter() - t0) / n * 1e6
    print(f"span enter and exit: {on:.2f} us recorded, {off:.2f} us outside every span")
    assert len(acc["track_rgbd/x"]) == n
    assert on < 50 and off < 50
