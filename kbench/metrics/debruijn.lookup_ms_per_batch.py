"""Milliseconds a `node_counts()` batch spent in the graph's
"query.lookup" phase (the routing and every run's lookup, enqueued with
no sync on one shard but for each run's host read of its search depth),
over the traced batches."""

SOURCE = "program_span"
LAYER = "query"
MOVES = "query_batch_p95_ms"


def read(obs):
    if not obs.window.calls or "query.lookup" not in obs.phases:
        return None
    return obs.phases["query.lookup"] * 1e3 / len(obs.window.calls)
