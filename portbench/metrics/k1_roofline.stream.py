"""k1_roofline.stream: K1's share of its roofline in the profiled slice of
the streaming passes: the sum of its calls' bounds (portbench/bounds.py)
over the sum of their device times in the trace."""

from portbench import readers


def read(rec):
    if rec.get("kind") != "stream":
        return None
    return readers.roofline_pct(rec, "k1")
