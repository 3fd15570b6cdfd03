"""Time ``Runtime`` tasks waited from ``remote()`` for an executor slot
(``stats["task_seconds"]["task-queued"]``), over the window, in ms per round
completed."""

from hoplite_bench.metrics._counters import seconds_delta


def read(r):
    queued = seconds_delta(r, "task_seconds", "task-queued")
    if queued is None or not r.window.completed:
        return None
    return queued * 1e3 / r.window.completed
