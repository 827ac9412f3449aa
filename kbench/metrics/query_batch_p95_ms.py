"""The 95th percentile (numpy's linear interpolation) of every batch's
latency in the window, from the `count()` call to its answer on the
host, in milliseconds."""

import numpy as np

SOURCE = "host_clock"


def read(obs):
    win = obs.window
    if not win.calls:
        return None
    return float(np.percentile([t1 - t0 for t0, t1, _ in win.calls], 95)
                 * 1e3)
