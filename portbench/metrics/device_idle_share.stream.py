"""device_idle_share.stream: the share of the profiled slice's wall time
in which no operation ran on the card (union of the device events)."""

from portbench import readers


def read(rec):
    if rec.get("kind") != "stream":
        return None
    return readers.idle_pct(rec)
