"""Per-span launches, syncs, copies and device, host and idle time of a
benchmark cell's traced slice, per frame, on one GPU.

    python3 tools/span_table.py --workload live-junction --seed <n> \
        [--seconds 51] [--without-ranges] [--out chiprun_out/spans.jsonl]

Runs the cell as ``portbench/run.py --trace 1`` does (its set-up, window
and profiled slice of the window's last seconds), reads the program's
``mmt:`` spans from the slice (``portbench/spans.py``) and prints one JSON
line: the card, whether the window's answers were correct, ms a frame of
the window, of the frames before the slice and of the frames in it, the
stage spans' host ms a frame before the slice, and per span its counts and
times a frame of the slice with the per-layer counts they give, and each
system's ``dispatch_pair/replayed`` counts (whether its pair step replayed
its CUDA graphs, a frame at a time) as runs of equal values.  With
``--without-ranges`` the program opens no profiler range in the slice (its
spans still time the host), which measures what the ranges cost; the line
then holds no spans.  ``--out`` appends the line to a file too.
"""

from __future__ import annotations

import argparse
import json
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", default="live-junction")
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, default=51.0)
    ap.add_argument("--without-ranges", action="store_true")
    ap.add_argument("--out")
    args = ap.parse_args()

    from portbench import devtrace, harness, run, spans

    cell = harness.Cell(args.workload)
    harness.cuda_or_exit(cell.chips)
    power = harness.power_limit_w()
    read = {}
    summary = devtrace.Slice.summary

    def summary_with_spans(self, top=10):
        read["spans"] = spans.from_kineto(self.prof.profiler.kineto_results.events())
        return summary(self, top)

    devtrace.Slice.summary = summary_with_spans
    if args.without_ranges:
        from multimot_track_tpu_torch.utils import profiling
        profiling._profiler_enabled = lambda: False
    from multimot_track_tpu_torch.pipeline.system import MultiMotSystem

    counters, init = [], MultiMotSystem.__init__

    def counted_init(self, *a, **kw):
        init(self, *a, **kw)
        counters.append(self.stage_counts)

    MultiMotSystem.__init__ = counted_init

    runner, _ = run.prepare(cell, args.seed, True)
    rec = runner.window(args.seconds)
    del runner
    _, correct, _ = run.judge(cell, rec)
    frames = rec["frames"]
    sliced = [f for f in frames if f["profiled"]]
    before = [f for f in frames if not f["profiled"]]
    ms = lambda fs: 1e3 * sum(f["dt"] for f in fs) / len(fs) if fs else None
    stage_s = {}
    for f in before:
        for k, (t, _) in f["stages"].items():
            stage_s[k] = stage_s.get(k, 0.0) + t
    import torch

    out = {
        "workload": args.workload, "seed": args.seed, "ranges": not args.without_ranges,
        "device": torch.cuda.get_device_name(0), "power_limit": power, "correct": bool(correct),
        "frames": len(frames), "profiled_frames": len(sliced),
        "ms_per_frame": 1e3 * rec["wall_s"] / len(frames),
        "before_slice_ms_per_frame": ms(before), "slice_ms_per_frame": ms(sliced),
        "slice_busy_s": rec["profile"]["busy_s"], "slice_wall_s": rec["profile"]["wall_s"],
        "stage_ms_per_frame": {k: 1e3 * t / len(before) for k, t in sorted(stage_s.items())},
        "replayed_runs": [runs(c.get("dispatch_pair/replayed", [])) for c in counters],
    }
    by = read.get("spans")
    if by is not None and not args.without_ranges and sliced:
        out["spans_per_frame"] = spans.per_frame(by, len(sliced))
        out["layer_counts"] = spans.layer_counts(by, len(sliced))
        out["named_launch_share"] = spans.named_share(by)
        out["totals"] = spans.totals(by)
    line = json.dumps(out)
    if args.out:
        with open(args.out, "a") as f:
            f.write(line + "\n")
    print(line)
    return 0


def runs(values):
    """[[value, how many in a row], ...]."""
    out = []
    for v in values:
        if out and out[-1][0] == v:
            out[-1][1] += 1
        else:
            out.append([v, 1])
    return out


if __name__ == "__main__":
    sys.exit(main())
