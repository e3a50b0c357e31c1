"""k2_roofline: K2's share of its roofline in the profiled slice of the
live window: the sum of its calls' bounds over their device times."""

from portbench import readers


def read(rec):
    if rec.get("kind") != "live":
        return None
    return readers.roofline_pct(rec, "k2")
