"""Seconds from the process's start to the window's first call: imports,
the reads and their FASTQ, the warm-up (and in a fresh checkout the
kernels' build)."""

SOURCE = "host_clock"


def read(obs):
    return obs.setup_s
