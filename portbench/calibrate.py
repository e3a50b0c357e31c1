"""Readings that set the limits of ``correct``: the program's numbers over
many seeds, and the control's and the faults' over a few, at the cell's
own size, in one process.

    python3 portbench/calibrate.py --workload <cell> --seeds S1 S2 ... \
        [--controls tf32] [--control-seeds C1 C2 C3] \
        [--faults live-stuck ...] [--out FILE]

Each reading is one whole drive on that seed's noisy inputs, taken as a
run takes it (the set-up's warm-up, then the entry's window until the
drive ends) and judged by ``portbench/reference.py`` as a run's answers
are.  The control ``tf32`` is the program with TF32 products and
convolutions switched on (the precision below the configuration's float32
with TF32 off).  Faults (``portbench/faults.py``) are read on the control
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

from portbench import devtrace, faults, harness, inputs, reference  # noqa: E402


def reading(cell, entry, clean, seed: int, control: str = None, fault: str = None,
            device: str = "cuda"):
    """The reference's numbers of one whole drive on ``seed``'s inputs."""
    runner = entry.make(cell, inputs.noisy_frames(cell, clean, seed), seed, False, device)
    if control == "tf32":
        runner.tf32 = True
    elif control is not None:
        raise SystemExit(f"unknown control {control!r}")
    patches = devtrace.Patches()
    if fault is not None:
        faults.plant(fault, patches)
    try:
        runner.warm_up()
        rec = runner.window(0.0, max_frames=len(clean) - runner.first)
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
    rows = []
    plan = ([("program", s, None, None) for s in args.seeds]
            + [(c, s, c, None) for c in args.controls for s in args.control_seeds]
            + [(f, s, None, f) for f in args.faults for s in args.control_seeds])
    for kind, seed, control, fault in plan:
        t0 = time.perf_counter()
        nums = reading(cell, entry, clean, seed, control, fault)
        row = dict(kind=kind, seed=seed, seconds=time.perf_counter() - t0, numbers=nums)
        rows.append(row)
        print(json.dumps(row), flush=True)
    summary = {}
    prog = [r["numbers"] for r in rows if r["kind"] == "program"]
    for name in (prog[0] if prog else {}):
        s = {"program_max": max(p[name] for p in prog),
             "program_min": min(p[name] for p in prog)}
        for control in args.controls + args.faults:
            vals = [r["numbers"][name] for r in rows if r["kind"] == control]
            if vals:
                s[f"{control}_min"] = min(vals)
                s[f"{control}_max"] = max(vals)
        summary[name] = s
    print(json.dumps({"summary": summary}), flush=True)
    if args.out:
        pathlib.Path(args.out).parent.mkdir(parents=True, exist_ok=True)
        pathlib.Path(args.out).write_text(json.dumps({"rows": rows, "summary": summary},
                                                     indent=1))
    return 0


if __name__ == "__main__":
    sys.exit(main())
