"""Seconds of the multimap's "flush" phase (`PositionIndex._flush`: the
pending tuples concatenated, the capacity read and grown, and the K2
merge, which ends on its overflow read) per 10^9 bases the traced builds
parsed."""

SOURCE = "program_span"
LAYER = "index.api"
MOVES = "build_kmers_per_s"


def read(obs):
    if not obs.bases or "flush" not in obs.phases:
        return None
    return obs.phases["flush"] / (obs.bases / 1e9)
