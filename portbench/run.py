"""Run one cell of ``BENCHMARK.json`` once on the card and print its result.

    python3 portbench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

Set-up (loading the program, building its kernels at first use, the
cell's inputs from the seed, the warm-up of the cell's own shapes) is
``setup_s``; then the window measures for ``--seconds``.  After the window
the run reads the device's peak memory, frees the program's state, judges
what the window returned against the plain reference, prints each compared
number beside its limit on standard error, checks that no JAX module was
loaded, and prints one JSON line last on standard output.  ``--trace 0``
reports the cell's end-to-end metrics, ``--trace 1`` its per-layer metrics
from a profiled slice of the window.  Without the CUDA devices the cell
asks for, it exits non-zero and prints no result.
"""

from __future__ import annotations

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import gc  # noqa: E402
import json  # noqa: E402
import math  # noqa: E402
import os  # noqa: E402
import pathlib  # noqa: E402
import sys  # noqa: E402

ROOT = pathlib.Path(__file__).resolve().parent.parent
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

from portbench import harness  # noqa: E402


def process_age_s() -> float:
    """Seconds since this process started (the interpreter's start-up
    before this file ran included), from /proc; 0 where it is not there."""
    try:
        start_ticks = int(pathlib.Path("/proc/self/stat").read_text().rsplit(")", 1)[1].split()[19])
        uptime = float(pathlib.Path("/proc/uptime").read_text().split()[0])
        return max(0.0, uptime - start_ticks / os.sysconf("SC_CLK_TCK"))
    except (OSError, ValueError, IndexError):
        return 0.0


def parse_args(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True, help="a cell of BENCHMARK.json")
    ap.add_argument("--seed", type=int, required=True, help="inputs and draws (any int >= 0)")
    ap.add_argument("--seconds", type=float, required=True, help="length of the window")
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return ap.parse_args(argv)


def prepare(cell, seed: int, trace: bool, device: str = "cuda"):
    """Set-up: the inputs and the entry's system, warmed up.  Returns
    (entry object, notes)."""
    from portbench import inputs

    t0 = time.perf_counter()
    clean, source = inputs.clean_frames(cell)
    t1 = time.perf_counter()
    frames = inputs.noisy_frames(cell, clean, seed)
    del clean
    t2 = time.perf_counter()
    runner = cell.entry().make(cell, frames, seed, trace, device)
    runner.warm_up()
    t3 = time.perf_counter()
    return runner, {"frames": source, "setup_split_s": {"drive": t1 - t0, "noise": t2 - t1,
                                                       "program_and_warm_up": t3 - t2}}


def judge(cell, rec):
    """(numbers, correct, rows) of the window's answers against the
    reference, computed from the scene alone."""
    from portbench import reference

    numbers = reference.compare(rec["answers"], cell.scene().truth())
    if cell.limits is None:
        return numbers, False, []
    ok, rows = harness.verdict(numbers, cell.limits)
    return numbers, ok, rows


def metrics(cell, rec, kind: str, setup_s: float):
    """The cell's metrics of ``kind`` ('e2e' or 'layer'), each from its
    reader; a reader that finds nothing leaves its metric out."""
    out = {}
    for m in (cell.e2e if kind == "e2e" else cell.per_layer):
        if m["name"] == "setup_s":
            value = setup_s
        else:
            value = cell.reader(m).read(rec)
        if value is None:
            continue
        out[m["name"]] = {"value": float(value), "unit": m["unit"]}
    return out


def run_cell(cell, seed: int, seconds: float, trace: bool, device: str = "cuda",
             t0: float = None, **window_kw):
    """One run of ``cell``: set-up, window, verdict.  Returns (the result
    line's object, [[number, value, limit], ...]).  ``device`` and
    ``window_kw`` are for the CPU tests."""
    import torch

    t0 = time.perf_counter() if t0 is None else t0
    power = harness.power_limit_w() if device == "cuda" else None
    runner, notes = prepare(cell, seed, trace, device)
    setup_s = time.perf_counter() - t0
    rec = runner.window(seconds, **window_kw)
    if device == "cuda":
        dev = harness.device_record(cell.chips, power)
    else:
        dev = {"platform": "cpu", "kind": "cpu", "count": 1, "memory_peak_bytes": 0}
    del runner
    gc.collect()
    if device == "cuda":
        torch.cuda.empty_cache()
    numbers, correct, rows = judge(cell, rec)
    attempted = rec["attempted"]
    bad = numbers["answers_bad"]
    result = {
        "correct": bool(correct),
        "attempted": attempted,
        "failed": int(bad) if math.isfinite(bad) else attempted,
        "metrics": metrics(cell, rec, "layer" if trace else "e2e", setup_s),
        "device": dev,
    }
    if trace and rec.get("profile"):
        prof = rec["profile"]
        result["device"]["busy_s"] = prof["busy_s"]
        result["device"]["window_s"] = prof["wall_s"]
        if prof["breakdown"]:
            result["breakdown"] = prof["breakdown"]
    result["notes"] = {"inputs": notes["frames"], "setup_split_s": notes["setup_split_s"],
                       "window_s": rec["wall_s"], "keyframes_held": rec.get("keyframes_held"),
                       "stage_ms_per_frame": rec.get("stage_ms_per_frame"),
                       "numbers": {k: v if math.isfinite(v) else str(v)
                                   for k, v in numbers.items()}}
    result["checks"] = {name: {"value": v, "limit": lim} for name, v, lim in rows}
    return result, rows


def main(argv=None) -> int:
    args = parse_args(argv)
    cell = harness.Cell(args.workload)
    harness.cuda_or_exit(cell.chips)
    result, rows = run_cell(cell, args.seed, args.seconds, bool(args.trace),
                            t0=T_START - process_age_s())
    found = harness.forbidden_modules()
    if found:
        print(f"portbench: modules loaded that the port must not load: {found}",
              file=sys.stderr)
        return 3
    for name, v, lim in rows:
        print(f"check {name}: {v} (limit {lim})", file=sys.stderr)
    print(json.dumps(result))
    return 0


if __name__ == "__main__":
    sys.exit(main())
