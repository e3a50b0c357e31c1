"""live_ms_per_frame: the window's wall time over the frames the live
system took in it."""


def read(rec):
    if rec.get("kind") != "live" or not rec["frames"]:
        return None
    return 1e3 * rec["wall_s"] / len(rec["frames"])
