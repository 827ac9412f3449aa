"""All queries answered in the window over all the window's time."""

SOURCE = "host_clock"


def read(obs):
    win = obs.window
    if not win.calls:
        return None
    return win.work / (win.end - win.start)
