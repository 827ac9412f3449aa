"""Flushes a Bimolecule build made: the times the map entered its
"bimol.flush" phase over the window, per call (a call is a whole build
and its first answer)."""

SOURCE = "program_counter"
LAYER = "index.api"
MOVES = "build_kmers_per_s"


def read(obs):
    n = obs.counts.get("phases", {}).get("bimol.flush", 0)
    if not obs.window.calls or not n:
        return None
    return n / len(obs.window.calls)
