"""Seconds the collectives' operations spent planning (the ``plan`` stage of
``stats["stage_seconds"]``: directory, scheduler and planner), over the
window, in ms per collective completed."""

from hoplite_bench.metrics._stages import stage_ms_per_op


def read(r):
    return stage_ms_per_op(r, "plan")
