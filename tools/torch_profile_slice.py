"""Where the time goes in the PyTorch port's batched slice and live system,
on one GPU.

    python3 tools/torch_profile_slice.py [--frames 12] [--out build/profile]

Renders make_junction_frames(N) at the KITTI camera, runs
``run_sequence_batched`` at DEFAULT_CONFIG once to warm up, then:
  * splits one run into its frontend and pair-tracking halves with CUDA
    events (ms per pair of each);
  * profiles one run with torch.profiler: device-busy time against the
    wall clock (the device's idle share) and the top kernels and ops by
    device time.  The Chrome trace goes to ``--out``.
Then the same profile for the live system (``MultiMotSystem``, synchronous,
at DEFAULT_CONFIG with the trailing-window and joint window BA on and loop
closing off, after a warm-up run), with its per-stage host times and, per
span of the program (its ``mmt:`` profiler ranges, ``portbench/spans.py``),
the launches, syncs and copies it made and its device, host, self and
idle ms a frame.  Prints the card's name and power limit first.  Needs a
CUDA device.
"""

from __future__ import annotations

import argparse
import os
import subprocess
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--frames", type=int, default=12)
    ap.add_argument("--out", default="build/profile")
    args = ap.parse_args()

    import torch
    from torch.profiler import ProfilerActivity, profile

    from multimot_track_tpu_torch.config import DEFAULT_CONFIG as cfg
    from multimot_track_tpu_torch.io.synth import KITTI_SYNTH_CAM, make_junction_frames
    from multimot_track_tpu_torch.pipeline import batch
    from multimot_track_tpu_torch.solvers.ransac import MultinomialSampler

    if not torch.cuda.is_available():
        print("torch_profile_slice: no CUDA device", file=sys.stderr)
        return 2
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True,
                         timeout=60).stdout.strip(), flush=True)
    dev = torch.device("cuda", 0)
    frames = make_junction_frames(n_frames=args.frames, cam=dict(KITTI_SYNTH_CAM))
    n_pairs = len(frames) - 1
    batch.run_sequence_batched(frames, cfg, seed=0, device=dev)      # warm-up

    # ---- frontend vs pair tracking, CUDA events ----
    gray, depth, flow, sem, gts = batch.upload_frames(frames, cfg, dev)
    sampler = MultinomialSampler(torch.Generator(device=dev).manual_seed(0))
    ev = [torch.cuda.Event(enable_timing=True) for _ in range(3)]
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    ev[0].record()
    obs = batch.frontend_batch(gray, depth, flow, sem, gts, cfg)
    ev[1].record()
    batch.track_batch(obs, gray, depth, sem, gts, cfg, sampler, list(range(n_pairs)))
    ev[2].record()
    ev[2].synchronize()
    wall = (time.perf_counter() - t0) * 1e3
    fe, tr = ev[0].elapsed_time(ev[1]), ev[1].elapsed_time(ev[2])
    print(f"frontend {fe / n_pairs:.3f} ms/pair, tracking {tr / n_pairs:.3f} ms/pair, "
          f"wall {wall / n_pairs:.3f} ms/pair ({n_pairs} pairs, CUDA events)", flush=True)

    # ---- one profiled end-to-end run ----
    os.makedirs(args.out, exist_ok=True)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        batch.run_sequence_batched(frames, cfg, seed=0, device=dev)
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) * 1e3
    _report(prof, wall, os.path.join(args.out, "trace.json"), "profiled batched run")

    # ---- the live system: warm-up, then one profiled synchronous run ----
    from multimot_track_tpu_torch.pipeline.system import MultiMotSystem
    from multimot_track_tpu_torch.utils.profiling import SPAN_PREFIX
    from portbench import spans

    def live_run():
        s = MultiMotSystem(cfg, seed=0, enable_loop_closing=False, device=dev)
        for fd in frames:
            s.track_rgbd(fd)
        torch.cuda.synchronize()
        return s

    live_run()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        s = live_run()
        wall = (time.perf_counter() - t0) * 1e3
    events = prof.profiler.kineto_results.events()
    ranges = {e.name() for e in events if e.name().startswith(SPAN_PREFIX)}
    _report(prof, wall, os.path.join(args.out, "trace_live.json"),
            f"profiled live run ({len(frames)} frames)", ranges)
    by = spans.from_kineto(events)
    print(f"program spans a frame ({spans.named_share(by):.4f} of the launches under one):",
          flush=True)
    print(f"{'span':28s} {'calls':>6s} {'launches':>9s} {'with ch.':>9s} {'syncs':>6s} "
          f"{'copies':>6s} {'device':>8s} {'host':>8s} {'self':>8s} {'idle':>8s}", flush=True)
    for path, d in sorted(spans.per_frame(by, len(frames)).items()):
        print(f"{path:28s} {d.get('calls', 0):6.2f} {d['launches']:9.1f} "
              f"{d.get('launches_all', d['launches']):9.1f} {d['syncs']:6.2f} "
              f"{d['copies']:6.2f} {d['device_ms']:8.3f} {d.get('host_ms', 0):8.2f} "
              f"{d.get('self_ms', 0):8.2f} {d['idle_ms']:8.2f}", flush=True)
    print(f"live stages (host clock, profiled): {s.stage_report()}", flush=True)
    return 0


def _report(prof, wall, trace_path, what, ranges=()):
    """Device-busy share of ``wall`` and the top ops by device time.  The
    device-side spans of the ``record_function`` ranges named in ``ranges``
    are not device work and stay out of the busy time."""
    prof.export_chrome_trace(trace_path)
    busy, n_events = device_busy_ms(prof, ranges)
    print(f"{what}: wall {wall:.1f} ms, device busy {busy:.1f} ms, "
          f"idle share {1 - busy / wall:.3f}, {n_events} device events", flush=True)
    ka = prof.key_averages()
    attr = "device_time_total" if hasattr(ka[0], "device_time_total") else "cuda_time_total"
    print(ka.table(sort_by=attr, row_limit=25, max_name_column_width=60), flush=True)
    return busy


def device_busy_ms(prof, ranges=()):
    """(ms the device was busy, device events) of a finished profile: the
    union of the device events' spans, without the device-side spans of the
    ``record_function`` ranges named in ``ranges`` (they are not work)."""
    import torch

    events = [e for e in prof.profiler.kineto_results.events()
              if e.device_type() == torch.autograd.DeviceType.CUDA and e.name() not in ranges]
    return _union_ms([(e.start_ns() / 1e3, (e.start_ns() + e.duration_ns()) / 1e3)
                      for e in events]), len(events)


def _union_ms(intervals):
    """Total length (ms) of the union of (start, end) intervals in us."""
    total, end = 0.0, None
    for s, e in sorted(intervals):
        if end is None or s > end:
            total += e - s
            end = e
        elif e > end:
            total += e - end
            end = e
    return total / 1e3


if __name__ == "__main__":
    sys.exit(main())
