"""The window's milliseconds on the host's clock over the collectives
completed in it: the time a client waits for each allreduce, all of the data
plane's host path included."""


def read(r):
    w = r.window
    return w.seconds * 1e3 / w.completed if w.completed else None
