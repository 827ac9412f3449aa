"""Bytes of the traced window's host-to-device copies over their device
time, in 10^9 bytes a second."""

SOURCE = "device_trace"
LAYER = "index.api"
MOVES = "build_kmers_per_s"


def read(obs):
    if obs.trace is None:
        return None
    nbytes, us = obs.trace.memcpy("HtoD")
    if not nbytes or us <= 0:
        return None
    return nbytes / us / 1e3
