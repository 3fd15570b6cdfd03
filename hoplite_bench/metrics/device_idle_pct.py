"""100 minus the share of the traced window in which any operation ran on
the card (the union of the profiler's device intervals).  Read for
``device_idle_pct.collective`` and ``device_idle_pct.asgd`` alike: each
per-layer metric names one end-to-end metric it moves, so the share is split
by the cells that report it."""


def read(r):
    t = r.trace
    if t is None or t.window_s <= 0 or t.busy_s <= 0:
        return None
    return 100.0 * (1.0 - t.busy_s / t.window_s)
