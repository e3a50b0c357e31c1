"""Readings that set the limits of the stream cell's ``correct``: the
program's numbers over many seeds, and the controls' and the faults' over a
few, at the cell's own size, in one process.

    python3 portbench/calibrate_stream.py --workload stream-junction \
        --seeds S1 S2 ... [--controls k1-tf32-inputs k1-bf16-inputs tf32] \
        [--control-seeds C1 C2 C3] [--faults stream-stuck ...] [--out FILE]

Each reading is one whole pass on that seed's noisy inputs, taken as a run
takes it (the set-up's warm-up pass, then the entry's window for one pass)
and judged as a run's answers are: ``reference.compare`` against the
scene's truth, with the float64 re-solve's numbers of the pass's K1
problems.  The controls: ``k1-tf32-inputs`` and ``k1-bf16-inputs`` round
every float input of each K1 call to TF32's or bfloat16's mantissa;
``tf32`` switches TF32 products and convolutions on after the streaming
set-up.  Faults (``portbench/stream_faults.py``) are read on the control
seeds.  The benchmark's runs never run this file; several of its
processes may share the card, since its readings are not timed.
"""

from __future__ import annotations

import argparse
import json
import pathlib
import sys
import time

ROOT = pathlib.Path(__file__).resolve().parent.parent
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

from portbench import devtrace, harness, inputs, stream_faults  # noqa: E402

def reading(cell, entry, clean, seed: int, control: str = None, fault: str = None,
            device: str = "cuda"):
    """The judged numbers of one whole pass on ``seed``'s inputs."""
    from portbench import reference

    runner = entry.make(cell, inputs.noisy_frames(cell, clean, seed), seed, False, device)
    if control == "tf32":
        runner.tf32 = True
    elif control in entry.ROUNDINGS:
        runner.k1_round = control
    elif control is not None:
        raise SystemExit(f"unknown control {control!r}")
    patches = devtrace.Patches()
    if fault is not None:
        stream_faults.plant(fault, patches)
    try:
        runner.warm_up()
        rec = runner.window(0.0, max_frames=len(clean) - 1)
    finally:
        patches.restore()
    return reference.compare(rec["answers"], cell.scene().truth())


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, nargs="*", default=[])
    ap.add_argument("--controls", nargs="*", default=[])
    ap.add_argument("--control-seeds", type=int, nargs="*", default=[])
    ap.add_argument("--faults", nargs="*", default=[])
    ap.add_argument("--out", default=None)
    args = ap.parse_args(argv)

    cell = harness.Cell(args.workload)
    harness.cuda_or_exit(cell.chips)
    entry = cell.entry()
    clean, _ = inputs.clean_frames(cell)
    plan = ([("program", s, None, None) for s in args.seeds]
            + [(c, s, c, None) for c in args.controls for s in args.control_seeds]
            + [(f, s, None, f) for f in args.faults for s in args.control_seeds])
    rows = []
    for kind, seed, control, fault in plan:
        t0 = time.perf_counter()
        nums = reading(cell, entry, clean, seed, control, fault)
        row = dict(kind=kind, seed=seed, seconds=time.perf_counter() - t0, numbers=nums)
        rows.append(row)
        print(json.dumps(row), flush=True)
    if args.out:
        pathlib.Path(args.out).parent.mkdir(parents=True, exist_ok=True)
        pathlib.Path(args.out).write_text(json.dumps({"rows": rows}, indent=1))
    return 0


if __name__ == "__main__":
    sys.exit(main())
