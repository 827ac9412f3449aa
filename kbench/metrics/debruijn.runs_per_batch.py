"""Runs a `node_counts()` batch searched: the times the graph entered its
"query.lookup.run" phase (once per run and shard searched) over the
window, per batch."""

SOURCE = "program_counter"
LAYER = "query"
MOVES = "query_batch_p95_ms"


def read(obs):
    runs = obs.counts.get("phases", {}).get("query.lookup.run", 0)
    if not obs.window.calls or not runs:
        return None
    return runs / len(obs.window.calls)
