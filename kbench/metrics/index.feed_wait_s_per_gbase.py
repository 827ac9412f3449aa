"""Seconds the main thread waited for the feeding thread's next chunk
(the index's "feed_wait" phase, around the future's result in
`_stream_chunks_iter`) per 10^9 bases the traced builds parsed: the
build's time that the parse and the marshal hold up the device's feed."""

SOURCE = "program_span"
LAYER = "index.api"
MOVES = "build_kmers_per_s"


def read(obs):
    if not obs.bases or "feed_wait" not in obs.phases:
        return None
    return obs.phases["feed_wait"] / (obs.bases / 1e9)
