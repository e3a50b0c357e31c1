"""local_map_ms: the program's ``local_map`` stage (TrackLocalMap) in
host ms per frame of the window."""

from portbench import readers


def read(rec):
    return readers.stage_ms_per_frame(rec, "local_map")
