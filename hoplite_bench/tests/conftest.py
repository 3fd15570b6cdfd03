"""Shared by the benchmark's tests: the checkout's root on the path, the
``gpu`` marker, and a cell run on the CPU at a small size."""

import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[2]
for p in (str(ROOT / "src"), str(ROOT)):
    if p not in sys.path:
        sys.path.insert(0, p)

# Small sizes at which every cell runs on the CPU in about a second, with
# every object above the 64 KB that the directory would hold inline; the
# workers' delays shrink with the round's work.
SMALL = {"allreduce-1gib": {"object_bytes": 1 << 16, "reservoir": 2},
         "asgd-resnet50": {"dim": 32768, "samples": 4, "delay_ms": [2, 12]}}


def pytest_configure(config):
    config.addinivalue_line("markers", "gpu: needs a CUDA device; skips when torch.cuda.is_available() is False")


@pytest.fixture
def cuda():
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")


def run_small(workload: str, seed: int = 2147483659, seconds: float = 0.5, trace: bool = False,
              root: Path = ROOT, control: bool = False, log=None, **overrides) -> dict:
    from hoplite_bench import harness

    ov = dict(SMALL.get(workload, {}))
    ov.update(overrides)
    return harness.run_cell(root, workload, seed, seconds, trace, device="cpu", overrides=ov,
                            log=log or (lambda msg: None), control=control)
