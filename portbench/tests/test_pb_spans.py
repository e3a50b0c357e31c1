"""The attribution of a traced slice to the program's spans
(``portbench/spans.py``) on synthetic event lists, the range reading of a
CPU profile, and on the card the exact counts of a span whose work is
known:

    python -m pytest -m gpu portbench/tests/test_pb_spans.py
"""

from __future__ import annotations

import pytest

from portbench import spans

MAIN, SIDE = 11, 22
# the live thread: track_rgbd [0, 100) holding dispatch_pair [10, 60), which
# holds dispatch_pair/ego [20, 40); local_map [70, 90)
RANGES = [(MAIN, 0, 100, "track_rgbd"), (MAIN, 10, 60, "dispatch_pair"),
          (MAIN, 20, 40, "dispatch_pair/ego"), (MAIN, 70, 90, "local_map")]


def call(t, name, corr, thread=MAIN, d=1):
    return (thread, t, t + d, name, corr)


def test_a_call_goes_to_the_innermost_span_of_its_thread():
    calls = [call(5, "cudaLaunchKernel", 1), call(15, "cudaLaunchKernel", 2),
             call(25, "cudaLaunchKernel", 3), call(30, "cudaLaunchKernelExC", 4),
             call(75, "cuLaunchKernel", 5), call(95, "cudaLaunchKernel", 6),
             call(120, "cudaLaunchKernel", 7)]
    by = spans.by_span(RANGES, calls, [])
    assert by["dispatch_pair/ego"]["launches"] == 2
    assert by["dispatch_pair"]["launches"] == 1
    assert by["dispatch_pair"]["launches_all"] == 3
    assert by["local_map"]["launches"] == by["local_map"]["launches_all"] == 1
    assert by["track_rgbd"]["launches"] == 2 and by["track_rgbd"]["launches_all"] == 6
    assert by[spans.NO_SPAN]["launches"] == 1


def test_calls_on_another_thread_are_not_the_spans():
    calls = [call(25, "cudaLaunchKernel", 1, thread=SIDE),
             call(26, "cudaMemcpyAsync", 2, thread=SIDE),
             call(27, "cudaLaunchKernel", 3)]
    by = spans.by_span(RANGES, calls, [])
    assert by["dispatch_pair/ego"]["launches"] == 1
    assert by["track_rgbd"]["launches_all"] == 1 and by["track_rgbd"]["copies_all"] == 0
    assert by[spans.NO_SPAN]["launches"] == 1 and by[spans.NO_SPAN]["copies"] == 1


def test_a_graph_launch_counts_one_and_its_kernels_count_as_device_time():
    calls = [call(25, "cudaGraphLaunch", 9)]
    device = [(200, 210, 9), (210, 230, 9), (240, 245, 8)]
    by = spans.by_span(RANGES, calls, device)
    assert by["dispatch_pair/ego"]["launches"] == 1
    assert by["dispatch_pair/ego"]["device_ms"] == pytest.approx(30 / 1e6)
    assert by[spans.NO_SPAN]["device_ms"] == 0


def test_syncs_copies_and_the_wait():
    calls = [call(21, "cudaMemcpyAsync", 1), call(22, "cudaStreamSynchronize", 2, d=5),
             call(28, "cudaMemcpy", 3, d=4), call(33, "cudaEventSynchronize", 4),
             call(72, "cudaDeviceSynchronize", 5, d=2), call(74, "cudaStreamIsCapturing", 6)]
    by = spans.by_span(RANGES, calls, [])
    ego = by["dispatch_pair/ego"]
    assert (ego["syncs"], ego["copies"], ego["launches"]) == (3, 2, 0)
    assert ego["sync_ms"] == pytest.approx(10 / 1e6)
    assert by["local_map"]["syncs"] == 1 and by["local_map"]["copies"] == 0
    assert by["track_rgbd"]["syncs_all"] == 4


def test_the_counts_add_up_to_the_slice():
    calls = [call(t, n, i, thread=MAIN if i % 3 else SIDE)
             for i, (t, n) in enumerate([(1, "cudaLaunchKernel"), (12, "cudaGraphLaunch"),
                                         (22, "cudaMemcpyAsync"), (23, "cudaStreamSynchronize"),
                                         (50, "cuLaunchKernel"), (80, "cudaMemcpy"),
                                         (99, "cudaLaunchKernel"), (150, "cudaLaunchKernel")])]
    device = [(300 + 10 * i, 305 + 10 * i, i) for i in range(8)]
    by = spans.by_span(RANGES, calls, device)
    tot = spans.totals(by)
    assert tot["launches"] == 5 and tot["syncs"] == 2 and tot["copies"] == 2
    assert tot["device_ms"] == pytest.approx(8 * 5 / 1e6)
    assert spans.named_share(by) == pytest.approx(1 - by[spans.NO_SPAN]["launches"] / 5)


def test_host_and_self_time_and_idle():
    by = spans.by_span(RANGES, [], [], idle_ns={"dispatch_pair/ego": 4e6, spans.NO_SPAN: 1e6})
    assert by["track_rgbd"]["host_ms"] == pytest.approx(100 / 1e6)
    assert by["track_rgbd"]["self_ms"] == pytest.approx(30 / 1e6)
    assert by["dispatch_pair"]["self_ms"] == pytest.approx(30 / 1e6)
    assert by["dispatch_pair/ego"]["idle_ms"] == pytest.approx(4.0)
    assert by[spans.NO_SPAN]["idle_ms"] == pytest.approx(1.0)
    assert all(by[p]["calls"] == 1 for p in ("track_rgbd", "dispatch_pair", "local_map"))


def test_the_program_ranges_of_a_cpu_profile():
    import torch
    from torch.profiler import ProfilerActivity, profile

    from multimot_track_tpu_torch.utils import profiling

    acc = {}
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        with profiling._StageCtx(acc, spans.ROOT, args="3"):
            with profiling._StageCtx(acc, "dispatch_pair"):
                with profiling.span("ego"):
                    torch.ones(64, 64) @ torch.ones(64, 64)
            with profiling.span("prep"):
                torch.ones(8) + 1
    by = spans.from_kineto(prof.profiler.kineto_results.events())
    assert {p for p in by if p != spans.NO_SPAN} == {
        "track_rgbd", "dispatch_pair", "dispatch_pair/ego", "track_rgbd/prep"}
    assert all(by[p]["calls"] == 1 for p in by if p != spans.NO_SPAN)
    root = by["track_rgbd"]
    assert 0 <= root["self_ms"] <= root["host_ms"]
    assert by["dispatch_pair"]["host_ms"] >= by["dispatch_pair/ego"]["host_ms"]
    assert spans.totals(by)["launches"] == 0


@pytest.mark.gpu
def test_a_known_span_reads_its_exact_launches_and_syncs(card):
    """Inside one program span: three elementwise ops and a sum (four
    kernels), ``.item()`` and ``.cpu()`` (a copy and a stream sync each)."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    from multimot_track_tpu_torch.utils import profiling

    x = torch.ones(1 << 16, device=card)

    def work():
        y = (x + 1) * 2
        y = y.exp()
        s = y.sum().item()
        return s, y.cpu()

    work()                                   # allocations and module loads
    torch.cuda.synchronize()
    acc = {}
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        with profiling._StageCtx(acc, spans.ROOT, args="0"):
            with profiling.span("work"):
                work()
            torch.ones(4, device=card).add_(1)
        torch.cuda.synchronize()
    by = spans.from_kineto(prof.profiler.kineto_results.events())
    w = by["track_rgbd/work"]
    print({k: w[k] for k in spans.COUNTS})
    assert (w["launches"], w["syncs"], w["copies"]) == (4, 2, 2)
    assert w["device_ms"] > 0
    assert by["track_rgbd"]["launches_all"] == 6       # ones() fills, add_ launches
    assert by["track_rgbd"]["syncs_all"] == 2
    # the synchronize outside the spans, and the profiler's own
    assert spans.totals(by)["syncs"] == 2 + by[spans.NO_SPAN]["syncs"] >= 3


def test_layer_counts_read_launches_under_each_layer():
    calls = [call(t, "cudaLaunchKernel", i) for i, t in enumerate((12, 25, 26, 72))]
    calls.append(call(30, "cudaStreamSynchronize", 9))
    by = spans.by_span(RANGES + [(MAIN, 200, 300, "track_rgbd")], calls, [])
    got = spans.layer_counts(by, frames=2)
    assert got == {"dispatch_pair_launches": 1.5, "local_map_launches": 0.5,
                   "window_refine_launches": None, "joint_ba_launches_per_kf": None,
                   "host_syncs_per_frame": 0.5}
    assert spans.per_frame(by, 2)["track_rgbd"]["calls"] == 1.0
