"""Milliseconds a `count()` batch spent in the index's "rows" phase
(`_query_words`: the host copy of the query words, their host-to-device
copy and the canonicalisation launches), over the traced batches."""

SOURCE = "program_span"
LAYER = "query"
MOVES = "query_batch_p95_ms"


def read(obs):
    if not obs.window.calls or "rows" not in obs.phases:
        return None
    return obs.phases["rows"] * 1e3 / len(obs.window.calls)
