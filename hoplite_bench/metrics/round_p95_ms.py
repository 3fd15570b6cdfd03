"""The 95th percentile of the rounds' own durations (the card included),
over every round completed in the window: exact samples, host clock."""

from hoplite_bench.harness import percentile


def read(r):
    return percentile(r.window.samples_ms, 95)
