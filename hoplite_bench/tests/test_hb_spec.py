"""BENCHMARK.json and every file it names: they parse, resolve by name and
keep to the characters and shapes the benchmark's contract allows."""

import json
import re
import shutil

import pytest

from hoplite_bench import harness
from hoplite_bench.tests.conftest import ROOT, run_small

SPEC = json.loads((ROOT / "BENCHMARK.json").read_text())
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
LINE = re.compile(r"^[^\t\n]{1,200}$")


def test_top_level_keys():
    assert set(SPEC) == {"command", "paths", "run_seconds", "configs", "workloads", "end_to_end", "per_layer"}
    assert SPEC["paths"] == ["hoplite_bench"]
    assert SPEC["command"] == ["python3", "hoplite_bench/run.py"]
    assert isinstance(SPEC["run_seconds"], int) and 1 <= SPEC["run_seconds"] <= 51
    assert len(json.dumps(SPEC)) < 64 * 1024


def test_names_units_and_lines():
    names = []
    for group in ("configs", "workloads", "end_to_end", "per_layer"):
        for entry in SPEC[group]:
            assert NAME.match(entry["name"]), entry["name"]
            names.append(entry["name"])
            for key in ("why", "layer", "source"):
                if key in entry and group != "end_to_end" and not (group == "per_layer" and key == "source"):
                    assert LINE.match(entry[key]), (entry["name"], key)
            if "unit" in entry:
                assert UNIT.match(entry["unit"]), entry["unit"]
                assert entry["better"] in ("lower", "higher")
    for group in ("configs", "workloads", "end_to_end", "per_layer"):
        group_names = [e["name"] for e in SPEC[group]]
        assert len(group_names) == len(set(group_names)), group
    for w in SPEC["workloads"]:
        assert NAME.match(w["config"]) and NAME.match(w["traffic"])
    for c in SPEC["configs"]:
        assert all(NAME.match(k) for k in c["reduced"]) and len(c["reduced"]) <= 16


def test_entry_keys():
    for c in SPEC["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
    for w in SPEC["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"} and w["chips"] in (1, 4)
    for m in SPEC["end_to_end"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "bound", "source"}
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
    for m in SPEC["per_layer"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "source", "layer", "moves"}
        assert m["source"] in ("device_trace", "program_span", "program_counter", "host_clock")
    assert any(m["name"] == "setup_s" and "workloads" not in m for m in SPEC["end_to_end"])


def test_every_file_resolves_by_name():
    bench = harness.Bench(ROOT)
    config_files = [c["file"] for c in SPEC["configs"]]
    assert len(config_files) == len(set(config_files))
    for c in SPEC["configs"]:
        assert c["file"].startswith("hoplite_bench/")
        data = bench.config(c["name"])
        assert data["name"] == c["name"] and data["source"] == c["source"]
        assert set(data["reduced"]) == set(c["reduced"])
        assert {"guarantees", "limits", "assumed"} <= set(data)
        assert any(w["config"] == c["name"] for w in SPEC["workloads"])
    for w in SPEC["workloads"]:
        cell = bench.cell(w["name"])
        driver = bench.driver(cell.traffic["driver"])
        assert hasattr(driver, "Driver") and hasattr(driver, "REFERENCE")
        bench.reference(driver.REFERENCE)
        e2e = {m["name"] for m in cell.end_to_end}
        assert "setup_s" in e2e and len(e2e) >= 2, w["name"]
        assert cell.per_layer, w["name"]
    e2e_names = {m["name"] for m in SPEC["end_to_end"]}
    for m in SPEC["per_layer"]:
        assert m["moves"] in e2e_names
        assert callable(bench.reader(m["name"]).read)
        for cell in m["workloads"]:
            moved = next(e for e in SPEC["end_to_end"] if e["name"] == m["moves"])
            assert cell in moved.get("workloads", [cell])


def test_one_layer_one_name():
    """Metrics of one layer give the layer letter for letter."""
    layers = {m["layer"] for m in SPEC["per_layer"]}
    for layer in layers:
        assert layer == layer.strip() and "  " not in layer


def test_a_workload_added_as_data_alone_resolves_and_runs(tmp_path):
    """A later cell (a broadcast of 1 GiB, 2 in flight) needs one traffic
    file and one entry in BENCHMARK.json, and no edit of any file there."""
    shutil.copytree(ROOT / "hoplite_bench", tmp_path / "hoplite_bench")
    spec = json.loads(json.dumps(SPEC))
    (tmp_path / "hoplite_bench" / "traffic" / "broadcast-1gib.json").write_text(json.dumps(
        {"driver": "collective", "op": "broadcast", "object_bytes": 1 << 30, "in_flight": 2, "reservoir": 1}))
    spec["workloads"].append({"name": "broadcast-1gib", "config": "hoplite-8n-f32", "traffic": "broadcast-1gib",
                              "chips": 1, "why": "closed loop, 2 broadcasts of 1 GiB from node 0 to 7 in flight"})
    spec["end_to_end"].append({"name": "broadcast_ms", "unit": "ms", "better": "lower", "bound": 0.25,
                               "source": "host_clock", "workloads": ["broadcast-1gib"]})
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(spec))
    before = {p: p.read_bytes() for p in (ROOT / "hoplite_bench").rglob("*") if p.is_file()
              and "__pycache__" not in p.parts}
    cell = harness.Bench(tmp_path).cell("broadcast-1gib")
    assert cell.traffic["op"] == "broadcast" and cell.config["name"] == "hoplite-8n-f32"
    out = run_small("broadcast-1gib", root=tmp_path, object_bytes=1 << 16)
    assert out["correct"] and out["checks"]["mismatched_elements"]["value"] == 0
    assert all(p.read_bytes() == b for p, b in before.items())


@pytest.mark.parametrize("path", sorted(str(p.relative_to(ROOT)) for p in (ROOT / "hoplite_bench").rglob("*")
                                        if p.is_file() and "__pycache__" not in p.parts))
def test_file_names_are_made_of_name_characters(path):
    assert re.match(r"^[A-Za-z0-9_./-]+$", path) and len(path) <= 200
