"""Milliseconds a `count()` batch spent in the index's "count.lookup"
phase (the routing and per-run lookups, enqueued with no sync on one
shard), over the traced batches."""

SOURCE = "program_span"
LAYER = "query"
MOVES = "query_batch_p95_ms"


def read(obs):
    if not obs.window.calls or "count.lookup" not in obs.phases:
        return None
    return obs.phases["count.lookup"] * 1e3 / len(obs.window.calls)
