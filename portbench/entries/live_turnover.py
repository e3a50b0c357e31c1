"""Entry ``live_turnover``: the entry ``live`` unchanged (its ``Live``,
loaded from ``entries/live.py`` by path), on a drive where movers are born
and die, plus the program's slot counter and the turnover judge.

Every window runs drive 0 to its end, whatever ``seconds`` says, so that
each run meets every birth and reborn label of the drive (a faster program
then goes on into the next drive until ``seconds`` have passed).

The record gains ``counts``: the sum of the program's counter
``record/slots_active`` (``MultiMotSystem.stage_counts``, one entry a
pair) over the window's pairs, the warm-up's left out;
``counted_pairs``, those pairs; and ``slots_per_pair``, the object solve
slots of one pair step (the configuration's ``k_obj_solve``).  A program
without ``stage_counts`` gives none of them, and the reader of the counter
then finds nothing.  ``make`` extends ``reference.compare`` with the
numbers of ``portbench/turnover_ref.py`` (``with_turnover``); the
reference's own numbers are unchanged.
"""

from __future__ import annotations

import pathlib

from portbench import harness, turnover_ref

live = harness.load_module(pathlib.Path(__file__).with_name("live.py"), "entry")

COUNTER = "record/slots_active"


class LiveTurnover(live.Live):
    def __init__(self, *a, **kw):
        super().__init__(*a, **kw)
        self.counters = []          # [a drive's counter entries, entries to skip]

    def system(self, drive):
        s = super().system(drive)
        counts = getattr(s, "stage_counts", None)
        if counts is not None:
            self.counters.append([counts, 0])
        return s

    def warm_up(self):
        super().warm_up()
        for c in self.counters:
            c[1] = len(c[0].get(COUNTER, []))

    def window(self, seconds: float, max_frames: int = None):
        if max_frames is None:
            max_frames = len(self.fds) - self.first
        rec = super().window(seconds, max_frames=max_frames)
        if self.counters:
            kept = [v for counts, skip in self.counters for v in counts.get(COUNTER, [])[skip:]]
            pad = self.cfg.padding
            rec["counts"] = {COUNTER: sum(kept)}
            rec["counted_pairs"] = len(kept)
            rec["slots_per_pair"] = (pad.k_obj_solve if 0 < pad.k_obj_solve < pad.k_obj_max
                                     else pad.k_obj_max)
        self.counters = []
        return rec


def with_turnover(compare):
    """``reference.compare`` plus the turnover judge's numbers."""
    if getattr(compare, "adds_turnover", False):
        return compare

    def judged(runs, truth):
        numbers = compare(runs, truth)
        numbers.update(turnover_ref.judge(runs, truth[1]))
        return numbers

    judged.adds_turnover = True
    return judged


def make(cell, frames, seed, trace, device="cuda"):
    from portbench import reference

    reference.compare = with_turnover(reference.compare)
    return LiveTurnover(cell, frames, seed, trace, device)
