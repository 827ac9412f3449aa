"""Seconds of the index's "h2d" phase (`_to_device`: the main thread's
pageable host-to-device copies of a chunk's columns, which return once
the host buffer is read) per 10^9 bases the traced builds parsed."""

SOURCE = "program_span"
LAYER = "index.api"
MOVES = "build_kmers_per_s"


def read(obs):
    if not obs.bases or "h2d" not in obs.phases:
        return None
    return obs.phases["h2d"] / (obs.bases / 1e9)
