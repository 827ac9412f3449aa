"""The representative minimum's share of the device's busy time in the
traced window, in percent: the device time of the items launched inside
the program's ranges of its two callers -- "kmerind/bimol.min_rep"
(`BimoleculeCountIndex._compact_step`, before every compaction a flush
starts) and "kmerind/bimol.strands" (`_strands`, the stored-orientation
column a find reads): `store.run_bimol_min_rep`'s scatter_reduce passes
and gathers -- matched to their launches by the trace's correlation ids
(``kbench/launches.py``; the loop keeps them as the window's
`launches`), over the union of all device items."""

from kbench import launches

SOURCE = "device_trace"
LAYER = "index.api"
MOVES = "build_kmers_per_s"
RANGES = ("kmerind/bimol.min_rep", "kmerind/bimol.strands")


def read(obs):
    events = getattr(obs.window, "launches", None)
    if obs.trace is None or events is None:
        return None
    us = launches.range_device_us(events, *RANGES)
    busy = obs.trace.busy_us()
    if not us or busy <= 0:
        return None
    return 100.0 * us / busy
