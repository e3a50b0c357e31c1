"""Faults planted under the timed path, to show that the comparison
catches them: ``portbench/tests/test_pb_faults.py`` runs them on the CPU,
``portbench/calibrate.py --faults`` reads them on the card at the cell's
own size.  Each is installed with ``plant(name, patches)`` and taken out
with ``patches.restore()``.

* ``live-stuck``: the pair step returns the camera's state unchanged (the
  pose of the frame before);
* ``live-half``: the pair step's second half of the solved object slots is
  left out, and the first half's mean motion stands in for it;
* ``live-altered``: the pair step's pose of one frame is moved 0.3 m;
* ``live-ids``: the track-ID association is left out, so every object
  record gets a new ID.

The cells run on one card, so no exchange between cards can be left out.
"""

from __future__ import annotations

ALTERED_FRAME = 20          # the frame altered
ALTER_M = 0.3


def plant(name: str, patches, altered_frame: int = ALTERED_FRAME):
    from multimot_track_tpu_torch.pipeline import tracker
    from multimot_track_tpu_torch.pipeline.system import MultiMotSystem

    full_step = tracker.full_step
    if name == "live-stuck":
        def stuck(*a, **kw):
            result, new_ctx, obs = full_step(*a, **kw)
            ctx = a[8]
            return (result._replace(Tcw_cur=ctx.Tcw_last.clone()),
                    new_ctx._replace(Tcw_last=ctx.Tcw_last.clone()), obs)
        patches.set(tracker, "full_step", stuck)
    elif name == "live-half":
        def half(*a, **kw):
            result, new_ctx, obs = full_step(*a, **kw)
            H = result.objects.H.clone()
            solved = result.objects.active.nonzero().flatten()
            h = (len(solved) + 1) // 2
            if len(solved) > 1:
                H[solved[h:]] = H[solved[:h]].mean(0)
            return result._replace(objects=result.objects._replace(H=H)), new_ctx, obs
        patches.set(tracker, "full_step", half)
    elif name == "live-altered":
        def altered(sampler, frame_idx, *a, **kw):
            result, new_ctx, obs = full_step(sampler, frame_idx, *a, **kw)
            if frame_idx == altered_frame:
                T = result.Tcw_cur.clone()
                T[0, 3] += ALTER_M
                result = result._replace(Tcw_cur=T)
            return result, new_ctx, obs
        patches.set(tracker, "full_step", altered)
    elif name == "live-ids":
        record = MultiMotSystem._record

        def forgetful(self, *a, **kw):
            self._sem_to_track = {}
            return record(self, *a, **kw)
        patches.set(MultiMotSystem, "_record", forgetful)
    else:
        raise ValueError(f"unknown fault {name!r}")
