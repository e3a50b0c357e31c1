"""upload_ms.live: host ms of ``MultiMotSystem.upload`` (packing and the
copy to the card) per frame, timed by the benchmark around the call on
the prefetch thread, outside the profiled slice."""

from portbench import readers


def read(rec):
    if rec.get("kind") != "live":
        return None
    frames = readers.unprofiled(rec)
    return 1e3 * sum(f["upload_s"] for f in frames) / len(frames) if frames else None
