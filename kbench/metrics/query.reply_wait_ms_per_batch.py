"""Milliseconds a `count()` batch spent in the index's "count.reply"
phase (the replies gathered in query order and copied to the host,
which waits for the lookups to finish on the device), over the traced
batches."""

SOURCE = "program_span"
LAYER = "query"
MOVES = "query_batch_p95_ms"


def read(obs):
    if not obs.window.calls or "count.reply" not in obs.phases:
        return None
    return obs.phases["count.reply"] * 1e3 / len(obs.window.calls)
