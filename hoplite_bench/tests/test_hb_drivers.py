"""Each traffic driver on ``LocalCluster(device="cpu")`` at small sizes, driven
through the whole run, and held by the plain reference."""

import pytest

from hoplite_bench.tests.conftest import run_small


@pytest.mark.parametrize("op", ["allreduce", "reduce", "broadcast"])
@pytest.mark.parametrize("in_flight", [1, 2])
def test_collective_driver_is_correct(op, in_flight):
    out = run_small("allreduce-1gib", op=op, in_flight=in_flight)
    assert out["correct"], out["checks"]
    assert out["attempted"] >= out["failed"] == 0
    checks = out["checks"]
    assert list(out)[-1] == "checks"
    assert {"missing_results", "mismatched_elements", "aliased_buffers"} == set(checks)
    assert all(c["value"] == 0 for c in checks.values())
    # The profiler sees no device on the CPU: the card's time is left out.
    assert set(out["metrics"]) == {"setup_s"} and out["metrics"]["setup_s"]["value"] > 0


def test_parameter_server_driver_is_correct():
    out = run_small("asgd-resnet50")
    assert out["correct"], out["checks"]
    assert out["checks"]["param_rel_err"]["value"] < out["checks"]["param_rel_err"]["limit"]
    assert out["metrics"]["round_ms"]["value"] > 0


@pytest.mark.parametrize("workload", ["allreduce-1gib", "asgd-resnet50"])
def test_traced_run_reports_the_trace(workload):
    """On the CPU the profiler sees no device: the device's metrics are left
    out of the line, and those read from counters and spans stay."""
    out = run_small(workload, trace=True)
    assert out["correct"]
    assert out["device"]["window_s"] > 0 and out["device"]["busy_s"] == 0
    assert "breakdown" in out and out["breakdown"]["device_ops"] == []
    names = set(out["metrics"])
    assert not names & {"chunk_reduce_roofline", "collective_hbm_pct", "round_hbm_pct",
                        "device_idle_pct.collective", "device_idle_pct.asgd"}
    if workload == "allreduce-1gib":
        assert {"collective_wall_ms", "windows_per_collective", "plan_ms", "producer_wait_ms"} <= names
    else:
        assert "wait_ms" in names


def test_the_same_seed_draws_the_same_inputs():
    import torch

    from hoplite_bench import inputs

    a = list(inputs.integer_objects(2 ** 31 + 5, "cpu", 3, 1024, -1000, 1000))
    b = list(inputs.integer_objects(2 ** 31 + 5, "cpu", 3, 1024, -1000, 1000))
    c = list(inputs.integer_objects(2 ** 31 + 6, "cpu", 3, 1024, -1000, 1000))
    assert all(torch.equal(x, y) for x, y in zip(a, b))
    assert not torch.equal(a[0], c[0])
    assert all(float(x.abs().max()) <= 1000 and torch.equal(x, x.round()) for x in a)


def test_parameter_server_groups_change_from_round_to_round():
    """The workers' delays, at the cell's own 20-120 ms, spread their
    finishing times: the first 4 of 8 form different groups, on gradients of
    different ages."""
    import ast
    import re

    lines = []
    out = run_small("asgd-resnet50", seconds=2.0, log=lines.append, delay_ms=[20, 120])
    assert out["correct"], out["checks"]
    line = next(s for s in lines if "distinct groups" in s)
    rounds, groups = map(int, re.search(r"(\d+) rounds reduced (\d+) distinct groups", line).groups())
    ages = ast.literal_eval(line.split("versions behind: ")[1])
    assert rounds >= 10 and groups >= 5, line
    assert len(ages) >= 2 and sum(ages.values()) == 4 * rounds, line


def test_a_result_of_another_collective_reads_wrong(monkeypatch):
    """Each collective takes each node's input from one of two sets, so an
    allreduce that always sums the first set is caught."""
    from repro_torch.core.local import LocalCluster

    orig = LocalCluster.allreduce

    def first_set(self, nodes, target, sources, op, **kw):
        firsts = []
        for s in sources:
            client, _, node = s.split(".")
            firsts.append(f"{client}.0.{node}")
        return orig(self, nodes, target, firsts, op, **kw)

    monkeypatch.setattr(LocalCluster, "allreduce", first_set)
    out = run_small("allreduce-1gib", reservoir=4)
    assert not out["correct"] and out["checks"]["mismatched_elements"]["value"] > 0, out["checks"]
