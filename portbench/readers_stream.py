"""Arithmetic shared by the stream cell's metric readers (records of
``kind == "stream"``, from ``portbench/entries/stream.py``).  A reader
returns None where its run has nothing to read."""

from __future__ import annotations


def unprofiled(rec):
    """The window's passes outside the profiled slice, which closes the
    window (the profiler slows the host, so host times are read only
    before it ran)."""
    return [p for p in rec["passes"] if not p["profiled"]]


def host_ms_per_pair(rec, key: str):
    """The benchmark's own host timing ``key`` of each pass, in ms per pair
    over the passes outside the profiled slice."""
    if rec.get("kind") != "stream":
        return None
    passes = unprofiled(rec)
    pairs = sum(p["pairs"] for p in passes)
    return 1e3 * sum(p[key] for p in passes) / pairs if pairs else None
