"""joint_ba_ms_per_kf: the program's ``joint_ba`` stage (the joint window
BA, at keyframe cadence) in host ms per call."""

from portbench import readers


def read(rec):
    return readers.stage_ms_per_call(rec, "joint_ba")
