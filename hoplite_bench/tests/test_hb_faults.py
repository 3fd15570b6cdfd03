"""The judge fails a run whose timed path is broken underneath, once for each
fault the cells can have, and fails every control: the plain reference in a
precision below the configuration's, put in the program's place.

Each fault (``hoplite_bench/faults.py``) is planted in the program
(``LocalCluster`` or ``Runtime``) for the whole run, which goes through
set-up, the window, the drain and the judge as ``run.py`` drives it, on the
CPU, past the check for a card."""

import pytest

from hoplite_bench import faults
from hoplite_bench.tests.conftest import run_small


@pytest.fixture
def planted():
    undo = []
    yield lambda driver, name: undo.append(faults.plant(driver, name))
    for u in reversed(undo):
        u()


@pytest.mark.parametrize("fault", faults.NAMES)
def test_allreduce_faults_are_not_correct(planted, fault):
    planted("collective", fault)
    out = run_small("allreduce-1gib")
    assert not out["correct"], out["checks"]


@pytest.mark.parametrize("fault", sorted(faults.NAMES))
def test_parameter_server_faults_are_not_correct(planted, fault):
    planted("parameter_server", fault)
    out = run_small("asgd-resnet50")
    assert not out["correct"], out["checks"]


@pytest.mark.parametrize("workload", ["allreduce-1gib", "asgd-resnet50"])
def test_the_control_is_not_correct(workload):
    out = run_small(workload, control=True)
    assert out["correct"]
    assert out["control"]
    for name, readings in out["control"].items():
        assert any(c["value"] > c["limit"] for c in readings.values()), (name, readings)
    if workload == "asgd-resnet50":
        assert set(out["control"]) == {"tf32_products", "bf16_reduce"}
        for readings in out["control"].values():
            ratio = readings["param_rel_err"]["value"] / out["checks"]["param_rel_err"]["value"]
            assert ratio > 100, out


def test_a_planted_fault_is_taken_out_again():
    from repro_torch.core.local import LocalCluster
    from repro_torch.runtime import Runtime

    before = (LocalCluster.__dict__["allreduce"], LocalCluster.__dict__["reduce"], Runtime.__dict__["reduce"])
    for driver in ("collective", "parameter_server"):
        for name in faults.NAMES:
            faults.plant(driver, name)()
    assert (LocalCluster.__dict__["allreduce"], LocalCluster.__dict__["reduce"], Runtime.__dict__["reduce"]) == before
