"""The faults of the turnover cell: those of ``portbench/faults.py``, and

* ``live-ids-stale``: each mask label keeps the last track ID it carried,
  across gaps, so a mover born on a label that an earlier mover carried
  inherits that mover's ID (the association by label alone).

``portbench/calibrate_turnover.py --faults`` reads them on the card,
``portbench/tests/test_pb_avenue.py`` on the CPU.  Each is installed with
``plant(name, patches)`` and taken out with ``patches.restore()``.
"""

from __future__ import annotations

from portbench import faults


def plant(name: str, patches, altered_frame: int = faults.ALTERED_FRAME):
    if name != "live-ids-stale":
        return faults.plant(name, patches, altered_frame=altered_frame)
    from multimot_track_tpu_torch.pipeline.system import MultiMotSystem

    record = MultiMotSystem._record

    def stale(self, *a, **kw):
        recs = self.map.obj_records
        n0 = len(recs)
        out = record(self, *a, **kw)
        last = self.__dict__.setdefault("_pb_label_ids", {})
        for r in recs[n0:]:
            tid = last.setdefault(r.sem_label, r.track_id)
            r.track_id = tid
            self._sem_to_track[r.sem_label] = tid
        return out
    patches.set(MultiMotSystem, "_record", stale)
