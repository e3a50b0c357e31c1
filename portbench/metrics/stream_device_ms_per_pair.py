"""stream_device_ms_per_pair: the device's busy time in the profiled slice
(the union of its operations) over the pairs of the slice's passes."""


def read(rec):
    prof = rec.get("profile")
    if rec.get("kind") != "stream" or not prof or prof["n_device_events"] == 0:
        return None
    return 1e3 * prof["busy_s"] / rec["profiled_pairs"]
