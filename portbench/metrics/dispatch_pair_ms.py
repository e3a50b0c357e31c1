"""dispatch_pair_ms: the program's ``dispatch_pair`` stage (the B = 1 pair
step) in host ms per frame of the window."""

from portbench import readers


def read(rec):
    return readers.stage_ms_per_frame(rec, "dispatch_pair")
