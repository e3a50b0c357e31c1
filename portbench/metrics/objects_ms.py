"""objects_ms: the program's ``dispatch_pair/objects`` span (the
pair step's object branch: RANSAC and K1 over every solve slot) in host ms
per frame of the window."""

from portbench import readers


def read(rec):
    return readers.stage_ms_per_frame(rec, "dispatch_pair/objects")
