"""Time threads spent blocked on the contended directory lock
(``stats["dir_lock_wait_seconds"]``; uncontended acquisitions are not timed),
over the window, in ms per collective completed."""

from hoplite_bench.metrics._counters import delta


def read(r):
    waited = delta(r, "dir_lock_wait_seconds")
    if waited is None or not r.window.completed:
        return None
    return waited * 1e3 / r.window.completed
