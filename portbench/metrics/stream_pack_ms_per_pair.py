"""stream_pack_ms_per_pair: host ms of the up-front packing of
``run_sequence_streaming`` (``batch.stream_chunks``: wire images and GT
tables of every chunk) per pair, timed by the benchmark around the call,
outside the profiled slice."""

from portbench import readers_stream


def read(rec):
    return readers_stream.host_ms_per_pair(rec, "pack_s")
