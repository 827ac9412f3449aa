"""Milliseconds a `node_counts()` batch spent in the graph's
"query.reply" phase (the int32[m, 9] counters gathered in query order and
copied to the host, which waits for the lookups to finish on the
device), over the traced batches."""

SOURCE = "program_span"
LAYER = "query"
MOVES = "query_batch_p95_ms"


def read(obs):
    if not obs.window.calls or "query.reply" not in obs.phases:
        return None
    return obs.phases["query.reply"] * 1e3 / len(obs.window.calls)
