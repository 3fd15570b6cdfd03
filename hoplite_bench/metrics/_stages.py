"""Shared by the readers of ``LocalCluster``'s critical-path stages
(``stats["stage_seconds"]``, ``core/trace.StageClock``)."""


def stage_ms_per_op(r, stage: str):
    w = r.window
    if not w.completed or w.stats0 is None:
        return None
    s0, s1 = w.stats0["stage_seconds"], w.stats1["stage_seconds"]
    return (s1.get(stage, 0.0) - s0.get(stage, 0.0)) * 1e3 / w.completed
