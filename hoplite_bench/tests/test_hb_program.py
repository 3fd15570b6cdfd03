"""The program's always-on counters of its hand-offs and of ``Runtime``'s
tasks (``core/store.py``'s ``DataPlaneStats``), read by the per-layer metrics
of a traced run on the CPU at small sizes."""

import pytest

from hoplite_bench.tests.conftest import run_small


@pytest.mark.parametrize("workload, counters", [
    ("allreduce-1gib", {"wake_lag_us.collective", "window_issue_us", "dir_lock_wait_ms"}),
    ("asgd-resnet50", {"wake_lag_us.asgd", "task_queued_ms", "task_io_ms"}),
])
def test_traced_run_reports_the_programs_counters(workload, counters):
    out = run_small(workload, trace=True)
    assert out["correct"]
    names = set(out["metrics"])
    assert counters <= names, names
    assert all(out["metrics"][n]["value"] >= 0 for n in counters)
    assert list(out)[-1] == "checks" and "breakdown" in out

