"""The data plane's wake lag: from the watermark advance that could release a
blocked reader (``ChunkedBuffer.write_chunk``) to the reader's return from
``wait_for_bytes``, its lock, the GIL and the scheduler included; the mean
over the window's signalled wake-ups (``stats["wake_lag_seconds"]`` over
``stats["woken"]``), in us.  Read for ``wake_lag_us.collective`` and
``wake_lag_us.asgd`` alike."""

from hoplite_bench.metrics._counters import delta


def read(r):
    lag, n = delta(r, "wake_lag_seconds"), delta(r, "woken")
    if lag is None or not n:
        return None
    return lag * 1e6 / n
