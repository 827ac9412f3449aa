"""Seconds of the Bimolecule map's "bimol.flush" phase
(`BimoleculeCountIndex._flush` with rows pending: every pending run
adopted (K3), then merged with the store two smallest first (K2, 4
payloads), ending on the compaction check's distinct-key read) per 10^9
bases the traced builds parsed."""

SOURCE = "program_span"
LAYER = "index.api"
MOVES = "build_kmers_per_s"


def read(obs):
    if not obs.bases or "bimol.flush" not in obs.phases:
        return None
    return obs.phases["bimol.flush"] / (obs.bases / 1e9)
