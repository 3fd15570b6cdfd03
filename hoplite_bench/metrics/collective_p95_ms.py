"""The 95th percentile of the collectives' own latencies, issue to
completion (the card included), over every collective completed in the
window: the benchmark's exact samples, host clock."""

from hoplite_bench.harness import percentile


def read(r):
    return percentile(r.window.samples_ms, 95)
