"""Faults planted under the streaming call's timed path, to show that the
comparison catches them: ``portbench/tests/test_pb_stream_faults.py`` runs
them on the CPU, ``portbench/calibrate_stream.py --faults`` reads them on
the card at the cell's own size.  The live faults (``portbench/faults.py``)
patch ``full_step`` and ``_record``, which this path never calls.  Each is
installed with ``plant(name, patches)`` and taken out with
``patches.restore()``.

* ``stream-stuck``: the batched pair step returns the camera's state
  unchanged (each pair's motion is the carried identity);
* ``stream-half``: the second half of each chunk's pairs and of its solved
  object slots is left out, and the first half's mean camera motion and
  mean object motion stand in for it;
* ``stream-altered``: the pair step's camera motion of one pair is moved
  0.3 m where it is produced;
* ``stream-ids``: the host post-pass's track-ID association is left out,
  so every object record gets a new ID.

The cell runs on one card, so no exchange between cards can be left out.
"""

from __future__ import annotations

ALTERED_PAIR = 20           # the pair (frames 20 -> 21) altered
ALTER_M = 0.3


def plant(name: str, patches, altered_pair: int = ALTERED_PAIR):
    from multimot_track_tpu_torch.pipeline import batch, tracker

    track_pairs = tracker.track_pairs
    if name == "stream-stuck":
        def stuck(pair, ctx, *a, **kw):
            res = track_pairs(pair, ctx, *a, **kw)
            return res._replace(Tcw_cur=ctx.Tcw_last.clone())
        patches.set(tracker, "track_pairs", stuck)
    elif name == "stream-half":
        def half(*a, **kw):
            res = track_pairs(*a, **kw)
            T, H = res.Tcw_cur.clone(), res.objects.H.clone()
            h = (T.shape[0] + 1) // 2
            if T.shape[0] > 1:
                T[h:] = T[:h].mean(0)
            solved = res.objects.active.reshape(-1).nonzero().flatten()
            Hf = H.reshape(-1, 4, 4)
            h = (len(solved) + 1) // 2
            if len(solved) > 1:
                Hf[solved[h:]] = Hf[solved[:h]].mean(0)
            return res._replace(Tcw_cur=T, objects=res.objects._replace(H=H))
        patches.set(tracker, "track_pairs", half)
    elif name == "stream-altered":
        def altered(pair, ctx, cfg, sampler, pair_ids, *a, **kw):
            res = track_pairs(pair, ctx, cfg, sampler, pair_ids, *a, **kw)
            if altered_pair in pair_ids:
                T = res.Tcw_cur.clone()
                T[list(pair_ids).index(altered_pair), 0, 3] += ALTER_M
                res = res._replace(Tcw_cur=T)
            return res
        patches.set(tracker, "track_pairs", altered)
    elif name == "stream-ids":
        compose = batch._compose_batch_outputs

        def forgetful(*a, **kw):
            Tcw, res, records = compose(*a, **kw)
            for i, r in enumerate(records):
                r["track_id"] = i + 1
            return Tcw, res, records
        patches.set(batch, "_compose_batch_outputs", forgetful)
    else:
        raise ValueError(f"unknown fault {name!r}")
