"""The plain turnover judge: track IDs where movers are born and die.

A mask label is handed on: when a mover leaves, a later one may carry its
label (the reference reads KITTI masks of three labels,
``rgbd_tum.cc:335``).  A mover born on such a label is a new track and must
get a track ID that no earlier record carried.  ``reference.compare``
judges IDs only between consecutive frames of one label, so it cannot see
an ID handed on across the gap; this file can.

Births come from the scene's truth alone: a label absent from the truth of
frame f - 1 and present in that of frame f (f >= 1) begins a lifespan that
lasts while the label stays present.  The program's records are read only
to be judged.  NumPy alone, like ``portbench/reference.py``; it imports
nothing of the program.
"""

from __future__ import annotations

import math


def lifespans(objs):
    """[(label, first frame, end frame)] of every run of frames in which
    the truth holds the label (``objs``: per frame {label: pose})."""
    out, open_ = [], {}
    for f, present in enumerate(objs):
        for label in list(open_):
            if label not in present:
                out.append((label, open_.pop(label), f))
        for label in present:
            open_.setdefault(label, f)
    out += [(label, f0, len(objs)) for label, f0 in open_.items()]
    return sorted(out, key=lambda s: (s[1], s[0]))


def judge(runs, objs) -> dict:
    """Over every drive of ``runs`` (dicts with ``n`` and ``records``:
    (frame, label, track_id, P_lc)): ``births_seen``, the births of the
    truth with a record in their lifespan; ``reborn_records``, the records
    of the lifespans born on a label that an earlier record of the drive
    carried; ``track_id_reborn_share``, the share of those whose track ID an
    earlier record of the drive (of any label) carried, NaN where there are
    none, so that a run which judged no reborn label fails."""
    births = [s for s in lifespans(objs) if s[1] >= 1]
    seen = reborn = reused = 0
    for run in runs:
        recs = [(int(f), int(label), int(tid)) for f, label, tid, _ in run["records"]]
        n = int(run["n"])
        for label, f0, f1 in births:
            if f0 >= n:
                continue
            mine = [tid for f, lab, tid in recs if lab == label and f0 <= f < f1]
            seen += bool(mine)
            if not any(lab == label and f < f0 for f, lab, _ in recs):
                continue
            earlier = {tid for f, _, tid in recs if f < f0}
            reborn += len(mine)
            reused += sum(tid in earlier for tid in mine)
    return {"track_id_reborn_share": reused / reborn if reborn else math.nan,
            "births_seen": float(seen), "reborn_records": float(reborn)}

