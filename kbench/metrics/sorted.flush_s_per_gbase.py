"""Seconds of the sort-based count map's "sorted.flush" phase
(`SortedCountIndex._flush`, one entry an attempt: every pending chunk's
rows and the store's rows routed by splitter, sorted once and summed,
ending on the distinct-key read) per 10^9 bases the traced builds
parsed."""

SOURCE = "program_span"
LAYER = "index.api"
MOVES = "build_kmers_per_s"


def read(obs):
    if not obs.bases or "sorted.flush" not in obs.phases:
        return None
    return obs.phases["sorted.flush"] / (obs.bases / 1e9)
