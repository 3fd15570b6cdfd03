"""Seconds the collectives' operations waited for a producer's watermark
(the ``producer-wait`` stage of ``stats["stage_seconds"]``), over the window,
in ms per collective completed."""

from hoplite_bench.metrics._stages import stage_ms_per_op


def read(r):
    return stage_ms_per_op(r, "producer-wait")
