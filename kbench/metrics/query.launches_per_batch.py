"""CUDA kernels that ran in the traced window over the query batches in
it: the launches one `count()` batch costs the host."""

SOURCE = "device_trace"
LAYER = "query"
MOVES = "query_batch_p95_ms"


def read(obs):
    if obs.trace is None or not obs.window.calls:
        return None
    n = obs.trace.kernel_count()
    return n / len(obs.window.calls) if n else None
