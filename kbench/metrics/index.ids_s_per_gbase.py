"""Seconds of the index's "marshal.ids" phase (the 64-bit position ids
computed into a pooled buffer, `_pooled_ids`, on the feeding thread;
a child of "marshal") per 10^9 bases the traced builds parsed."""

SOURCE = "program_span"
LAYER = "index.api"
MOVES = "build_kmers_per_s"


def read(obs):
    if not obs.bases or "marshal.ids" not in obs.phases:
        return None
    return obs.phases["marshal.ids"] / (obs.bases / 1e9)
