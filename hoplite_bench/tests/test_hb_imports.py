"""What the benchmark runs loads neither JAX nor the JAX package, and the
plain reference loads nothing of the program."""

import ast
import json
import subprocess
import sys

from hoplite_bench import harness
from hoplite_bench.tests.conftest import ROOT

PROBE = """
import json, sys
sys.path[:0] = [{src!r}, {root!r}]
from hoplite_bench import harness
for w in ("allreduce-1gib", "asgd-resnet50"):
    ov = {{"allreduce-1gib": {{"object_bytes": 65536, "reservoir": 1}}, "asgd-resnet50": {{"dim": 1024, "samples": 4}}}}[w]
    harness.run_cell({root!r}, w, 7, 0.3, True, device="cpu", overrides=ov, log=lambda m: None)
print(json.dumps(sorted(sys.modules)))
"""


def test_top_level_names_are_compared_whole():
    assert harness.forbidden_modules(["repro_torch", "repro_torch.core.local", "torch", "jaxtyping"]) == []
    assert harness.forbidden_modules(["repro", "repro.core", "jax.numpy", "jaxlib", "flax.linen"]) == \
        ["flax.linen", "jax.numpy", "jaxlib", "repro", "repro.core"]


def test_a_run_loads_no_jax_and_no_repro():
    out = subprocess.run([sys.executable, "-c", PROBE.format(src=str(ROOT / "src"), root=str(ROOT))],
                         capture_output=True, text=True, timeout=300, cwd=ROOT)
    assert out.returncode == 0, out.stderr[-3000:]
    modules = json.loads(out.stdout.strip().splitlines()[-1])
    assert "repro_torch.core.local" in modules
    assert harness.forbidden_modules(modules) == []
    assert not any(m.split(".")[0] == "benchmarks" for m in modules)


def test_the_reference_imports_nothing_of_the_program():
    for path in sorted((ROOT / "hoplite_bench" / "reference").glob("*.py")) + [ROOT / "hoplite_bench" / "inputs.py"]:
        tree = ast.parse(path.read_text())
        for node in ast.walk(tree):
            names = []
            if isinstance(node, ast.Import):
                names = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom):
                names = [node.module or ""]
            for n in names:
                assert n.split(".")[0] in {"torch", "__future__", "hoplite_bench"}, (path, n)
    probe = (f"import sys; sys.path[:0] = [{str(ROOT)!r}]\n"
             "from hoplite_bench import harness\n"
             "b = harness.Bench(sys.path[0])\n"
             "[b.reference(n) for n in ('collective', 'parameter_server')]\n"
             "print(sorted(m for m in sys.modules if m.split('.')[0] in ('repro_torch', 'repro', 'jax')))")
    out = subprocess.run([sys.executable, "-c", probe], capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr[-2000:]
    assert out.stdout.strip() == "[]"


def test_nothing_reads_the_old_benchmark():
    for path in (ROOT / "hoplite_bench").rglob("*.py"):
        if "tests" in path.parts:
            continue
        text = path.read_text()
        assert "BENCH_core" not in text and "from benchmarks" not in text and "import benchmarks" not in text
