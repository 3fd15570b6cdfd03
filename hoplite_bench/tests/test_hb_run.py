"""``run.py`` refuses to run without a card, and without the program beside it."""

import json
import shutil
import subprocess
import sys

import pytest

from hoplite_bench.tests.conftest import ROOT


def run(cwd, *extra):
    return subprocess.run([sys.executable, "hoplite_bench/run.py", "--workload", "allreduce-1gib", "--seed",
                           "3000000001", "--seconds", "1", "--trace", "0", *extra],
                          capture_output=True, text=True, timeout=300, cwd=cwd)


def test_without_a_card_it_fails_and_prints_no_result():
    import torch

    if torch.cuda.is_available():
        pytest.skip("a card is present")
    out = run(ROOT)
    assert out.returncode != 0
    assert out.stdout.strip() == ""
    assert "no CUDA device" in out.stderr


def test_without_the_program_it_fails_and_prints_no_result(tmp_path):
    shutil.copy(ROOT / "BENCHMARK.json", tmp_path)
    shutil.copytree(ROOT / "hoplite_bench", tmp_path / "hoplite_bench")
    out = run(tmp_path)
    assert out.returncode != 0
    assert out.stdout.strip() == ""


@pytest.mark.gpu
def test_a_short_run_on_the_card_is_correct(cuda):
    out = run(ROOT)
    assert out.returncode == 0, out.stderr[-3000:]
    line = json.loads(out.stdout.strip().splitlines()[-1])
    assert line["correct"] and line["device"]["platform"] == "gpu"
    assert list(line) == ["correct", "attempted", "failed", "metrics", "device", "checks"]
    assert out.stderr.strip().splitlines()[-1].startswith("check aliased_buffers")
