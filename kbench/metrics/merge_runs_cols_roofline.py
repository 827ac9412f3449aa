"""K2 (`kernels.merge_runs_cols`): the least time its traced calls could
take (`roofline.kernel_bytes` of each call's shapes over the HBM rate)
over the device time of its partition and tile kernels, in percent."""

from kbench import roofline

SOURCE = "device_trace"
LAYER = "kernels"
MOVES = "build_kmers_per_s"
PATTERN = r"\bmerge_(partition|tiles)_kernel\b"


def read(obs):
    calls = obs.kernel_calls.get("merge_runs_cols")
    if obs.trace is None or not calls:
        return None
    us = obs.trace.kernel_us(PATTERN)
    if us <= 0:
        return None
    nbytes = sum(roofline.kernel_bytes("merge_runs_cols", **c)
                 for c in calls)
    return 100.0 * roofline.bound_ms(nbytes) / (us / 1e3)
