"""The host's issue time of one transfer window: from holding every input's
watermark to the window's own advance (the checks, the copy or fold launches,
``write_chunk``), the mean over the window's copy and fold windows
(``stats["window_issue_seconds"]`` over ``stats["windows"]``), in us."""

from hoplite_bench.metrics._counters import delta


def read(r):
    issue, n = delta(r, "window_issue_seconds"), delta(r, "windows")
    if issue is None or not n:
        return None
    return issue * 1e6 / n
