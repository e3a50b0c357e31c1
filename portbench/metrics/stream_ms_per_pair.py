"""stream_ms_per_pair: the window's wall time over the frame pairs that
``run_sequence_streaming`` returned in it (whole passes, back to back)."""


def read(rec):
    if rec.get("kind") != "stream" or not rec["attempted"]:
        return None
    return 1e3 * rec["wall_s"] / rec["attempted"]
