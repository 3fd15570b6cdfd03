"""Transfer windows the data plane drained (``LocalCluster.stats["windows"]``,
copy and fold windows, ``core/store.py``) over the window, per collective
completed in it."""


def read(r):
    w = r.window
    if not w.completed or w.stats0 is None:
        return None
    return (w.stats1["windows"] - w.stats0["windows"]) / w.completed
