"""Milliseconds a `find()` batch spent in the multimap's "find.reply"
phase (the answer's id halves, qualities and mask copied to the host and
the 64-bit ids composed there), over the traced batches."""

SOURCE = "program_span"
LAYER = "query"
MOVES = "query_batch_p95_ms"


def read(obs):
    if not obs.window.calls or "find.reply" not in obs.phases:
        return None
    return obs.phases["find.reply"] * 1e3 / len(obs.window.calls)
