"""window_refine_ms: the program's ``window_refine`` stage (the trailing
window BA) in host ms per frame of the window."""

from portbench import readers


def read(rec):
    return readers.stage_ms_per_frame(rec, "window_refine")
