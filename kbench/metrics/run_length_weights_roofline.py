"""K4 (`kernels.run_length_weights`): the least time its traced calls
could take (`roofline.kernel_bytes` of each call's shapes over the HBM
rate) over the device time of its two kernels, in percent.

The harness records K1's call shapes, not K4's.  A sort-based count map's
ingest runs K4 once on the sorted rows of each K1 call (`sorted_dist.
local_ingest_step`), so each K1 call's (n, nwords) is a K4 call's (n,
w): read only where the window's launch counters show as many K4
launches as K1 launches and K1 calls."""

from kbench import roofline

SOURCE = "device_trace"
LAYER = "kernels"
MOVES = "build_kmers_per_s"
PATTERN = r"\brl_(tiles|carry)\b"


def read(obs):
    calls = obs.kernel_calls.get("extract_canonical")
    launches = obs.counts.get("launches", {})
    if obs.trace is None or not calls or not (
            launches.get("run_length_weights")
            == launches.get("extract_canonical") == len(calls)):
        return None
    us = obs.trace.kernel_us(PATTERN)
    if us <= 0:
        return None
    nbytes = sum(roofline.kernel_bytes("run_length_weights", n=c["n"],
                                       w=c["nwords"]) for c in calls)
    return 100.0 * roofline.bound_ms(nbytes) / (us / 1e3)
