"""Where the time goes in the PyTorch port's batched slice, on one GPU.

    python3 tools/torch_profile_slice.py [--frames 12] [--out build/profile]

Renders make_junction_frames(N) at the KITTI camera, runs
``run_sequence_batched`` at DEFAULT_CONFIG once to warm up, then:
  * splits one run into its frontend and pair-tracking halves with CUDA
    events (ms per pair of each);
  * profiles one run with torch.profiler: device-busy time against the
    wall clock (the device's idle share) and the top kernels and ops by
    device time.  The Chrome trace goes to ``--out``.
Prints the card's name and power limit first.  Needs a CUDA device.
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
    prof.export_chrome_trace(os.path.join(args.out, "trace.json"))
    events = [e for e in prof.profiler.kineto_results.events()
              if e.device_type() == torch.autograd.DeviceType.CUDA]
    busy = _union_ms([(e.start_ns() / 1e3, (e.start_ns() + e.duration_ns()) / 1e3)
                      for e in events])
    print(f"profiled run: wall {wall:.1f} ms, device busy {busy:.1f} ms, "
          f"idle share {1 - busy / wall:.3f}, {len(events)} device events", flush=True)
    ka = prof.key_averages()
    attr = "device_time_total" if hasattr(ka[0], "device_time_total") else "cuda_time_total"
    print(ka.table(sort_by=attr, row_limit=25, max_name_column_width=60), flush=True)
    return 0


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
