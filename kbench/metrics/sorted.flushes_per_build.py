"""Flush attempts a sort-based count map build made: the times the map
entered its "sorted.flush" phase over the window, per call (a call is a
whole build and its first answer).  1 when the first exchange bucket
capacity holds; each overflow retry adds 1."""

SOURCE = "program_counter"
LAYER = "index.api"
MOVES = "build_kmers_per_s"


def read(obs):
    n = obs.counts.get("phases", {}).get("sorted.flush", 0)
    if not obs.window.calls or not n:
        return None
    return n / len(obs.window.calls)
