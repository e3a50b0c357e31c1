"""stream_drain_ms_per_pair: host ms of the one drain of
``run_sequence_streaming`` per pair: ``state.result_to_numpy`` (it waits
for the card's last chunk, then copies every result back) plus the host
post-pass ``batch._compose_batch_outputs``, timed by the benchmark around
the calls, outside the profiled slice."""

from portbench import readers_stream


def read(rec):
    return readers_stream.host_ms_per_pair(rec, "drain_s")
