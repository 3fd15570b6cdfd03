"""Time ``Runtime`` tasks spent on the object store: Getting their ObjectRef
arguments and Putting their results (``stats["task_seconds"]``, ``task-args``
plus ``task-put``), over the window, in ms per round completed."""

from hoplite_bench.metrics._counters import seconds_delta


def read(r):
    args = seconds_delta(r, "task_seconds", "task-args")
    put = seconds_delta(r, "task_seconds", "task-put")
    if args is None or put is None or not r.window.completed:
        return None
    return (args + put) * 1e3 / r.window.completed
