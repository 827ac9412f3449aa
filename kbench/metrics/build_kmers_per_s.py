"""All k-mer windows of the window's whole builds over the time from
the window's start to the end of the last one (each call is a build of
the FASTQ and the first answer on the host)."""

SOURCE = "host_clock"


def read(obs):
    win = obs.window
    if not win.calls:
        return None
    return win.work / (win.end - win.start)
