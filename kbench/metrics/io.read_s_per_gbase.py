"""Seconds of the index's "read" phase (the host parse of the FASTQ's
blocks, `PhaseTimer` through the index's `timer=`) per 10^9 bases the
traced builds parsed."""

SOURCE = "program_span"
LAYER = "io"
MOVES = "build_kmers_per_s"


def read(obs):
    if not obs.bases or "read" not in obs.phases:
        return None
    return obs.phases["read"] / (obs.bases / 1e9)
