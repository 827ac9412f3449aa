"""The share of the traced window (one pass over the pool of query batches)
in which no kernel, copy or memset ran on the device, in percent."""

SOURCE = "device_trace"
LAYER = "device"
MOVES = "query_kmers_per_s"


def read(obs):
    if obs.trace is None or obs.trace.window_us <= 0:
        return None
    return 100.0 * (1.0 - obs.trace.busy_us() / obs.trace.window_us)
