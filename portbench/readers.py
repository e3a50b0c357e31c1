"""Arithmetic shared by the metric readers in ``portbench/metrics/``.

A reader returns None where its run has nothing to read, and the harness
then leaves the metric out of the result line; a roofline share is never
made up as 0."""

from __future__ import annotations

from portbench import harness


def unprofiled(rec):
    """The live window's frames outside the profiled slice, which closes
    the window (the profiler slows the host, so stage times are read only
    before it ran)."""
    return [f for f in rec["frames"] if not f["profiled"]]


def stage_ms_per_frame(rec, stage: str):
    """A program stage's host milliseconds per frame of the window."""
    if rec.get("kind") != "live":
        return None
    frames = unprofiled(rec)
    if not any(stage in f["stages"] for f in frames):
        return None                      # the stage never ran in the window
    return 1e3 * sum(f["stages"].get(stage, (0.0, 0))[0] for f in frames) / len(frames)


def stage_ms_per_call(rec, stage: str):
    """A program stage's host milliseconds per call in the window."""
    if rec.get("kind") != "live":
        return None
    total = calls = 0
    for f in unprofiled(rec):
        s, n = f["stages"].get(stage, (0.0, 0))
        total, calls = total + s, calls + n
    return 1e3 * total / calls if calls else None


def roofline_pct(rec, kernel: str):
    """Sum of the kernel's per-call bounds over the sum of its per-call
    device times in the profiled slice, in %; None unless every call the
    wrapper saw has its one device kernel in the trace."""
    prof = rec.get("profile")
    bounds = rec.get(f"{kernel}_bounds_us")
    if not prof or not bounds:
        return None
    times = prof[f"{kernel}_us"]
    if len(times) != len(bounds) or sum(times) <= 0:
        return None
    return 100.0 * sum(bounds) / sum(times)


def idle_pct(rec):
    prof = rec.get("profile")
    if not prof or not prof["wall_s"] or prof["n_device_events"] == 0:
        return None
    return 100.0 * (1.0 - prof["busy_s"] / prof["wall_s"])


def p90_ms(values_s):
    return 1e3 * harness.nearest_rank(values_s, 0.9)
