"""The time the server spent in ``Runtime.wait`` for the first finishers, a
span the benchmark records around each call, in ms per round completed in the
window."""


def read(r):
    w = r.window
    if not w.completed:
        return None
    spans = r.spans.within("wait", w.start, w.close)
    return sum(b - a for a, b in spans) * 1e3 / w.completed
