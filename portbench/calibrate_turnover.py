"""Readings that set the limits of the turnover cell's ``correct``:
``portbench/calibrate.py`` with the faults of
``portbench/turnover_faults.py`` (``live-ids-stale`` besides the live
cell's four), on the same arguments, plus a window length.

    python3 portbench/calibrate_turnover.py --workload live-avenue \
        --seeds S1 S2 ... [--controls tf32] [--control-seeds C1 C2 C3] \
        [--faults live-stuck live-half live-altered live-ids live-ids-stale] \
        [--window-s SECONDS] [--out FILE]

Each reading is judged as a run's answers are: ``reference.compare`` with
the turnover judge's numbers (the cell's entry adds them).  It is one
window of the cell's entry: ``--window-s`` 0 (the default) takes drive 0
to its end, as ``calibrate.py`` does; a number of seconds takes the
window a run of that many seconds takes.  After each reading a line
``{"worst_raw": ...}`` gives the reading's 5 pairs of largest raw camera
t-RPE: drive, frame, the raw and the refined t-RPE, and the true step in
metres.
"""

from __future__ import annotations

import argparse
import json
import pathlib
import sys

ROOT = pathlib.Path(__file__).resolve().parent.parent
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

from portbench import calibrate, devtrace, inputs, reference, turnover_faults  # noqa: E402

import numpy as np  # noqa: E402


def worst_raw(runs, Twc_gt, n: int):
    """The ``n`` pairs of largest raw t-RPE over the runs' drives."""
    rows = []
    for d, run in enumerate(runs):
        k = int(run["n"])
        gt = np.asarray(Twc_gt[:k], np.float64)
        raw, _, _, tg = reference.camera_errors(np.asarray(run["Twc_raw"], np.float64), gt)
        ref = reference.camera_errors(np.asarray(run["Twc"], np.float64), gt)[0]
        rows += [[d, f + 1, float(raw[f]), float(ref[f]), float(np.linalg.norm(tg[f]))]
                 for f in range(len(raw))]
    return sorted(rows, key=lambda r: -r[2])[:n]


def timed_reading(window_s: float):
    def reading(cell, entry, clean, seed, control=None, fault=None, device="cuda"):
        runner = entry.make(cell, inputs.noisy_frames(cell, clean, seed), seed, False, device)
        if control == "tf32":
            runner.tf32 = True
        elif control is not None:
            raise SystemExit(f"unknown control {control!r}")
        patches = devtrace.Patches()
        if fault is not None:
            turnover_faults.plant(fault, patches)
        try:
            runner.warm_up()
            rec = runner.window(window_s)
        finally:
            patches.restore()
        truth = cell.scene().truth()
        print(json.dumps({"worst_raw": worst_raw(rec["answers"], truth[0], 5),
                          "seed": seed, "kind": control or fault or "program",
                          "window_s": window_s, "drives": rec["n_drives"]}), flush=True)
        return reference.compare(rec["answers"], truth)
    return reading


if __name__ == "__main__":
    ap = argparse.ArgumentParser(add_help=False)
    ap.add_argument("--window-s", type=float, default=0.0)
    own, rest = ap.parse_known_args()
    calibrate.reading = timed_reading(own.window_s)
    sys.exit(calibrate.main(rest))
