"""Shared by the readers of the program's own always-on counters
(``LocalCluster.stats``, read at the window's start and close: the port's
hand-off timers in ``core/store.py`` and ``task_seconds``).  A counter the
program does not have reads as None, not as a zero."""


def delta(r, key: str):
    """The counter's change over the window, or None where it is absent."""
    w = r.window
    if w.stats0 is None or key not in w.stats0 or key not in w.stats1:
        return None
    return w.stats1[key] - w.stats0[key]


def seconds_delta(r, key: str, stage: str):
    """The change of one entry of a seconds dict (``task_seconds``)."""
    w = r.window
    if w.stats0 is None or key not in w.stats0 or key not in w.stats1:
        return None
    return w.stats1[key].get(stage, 0.0) - w.stats0[key].get(stage, 0.0)
