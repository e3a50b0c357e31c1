"""live_frame_ms_p90: the 90th percentile (nearest rank), over the live
window's frames outside the profiled slice, of the time from the return of
the frame before to the return of this frame (its wait on the prefetched
upload included): the stall a live user feels on keyframe frames."""

from portbench import readers


def read(rec):
    if rec.get("kind") != "live":
        return None
    frames = readers.unprofiled(rec)
    return readers.p90_ms([f["dt"] for f in frames]) if frames else None
