"""Seconds of the index's "marshal" phase (the host's per-chunk copy of
the parsed columns into pooled buffers, on the feeding thread) per 10^9
bases the traced builds parsed: busy time, overlapped with the main
thread's copies and launches."""

SOURCE = "program_span"
LAYER = "index.api"
MOVES = "build_kmers_per_s"


def read(obs):
    if not obs.bases or "marshal" not in obs.phases:
        return None
    return obs.phases["marshal"] / (obs.bases / 1e9)
