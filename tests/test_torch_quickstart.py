"""The port's quickstart (``repro_torch.examples.quickstart``) on the CPU:
the object store on 8 nodes, a float32 reduce through ``chunk_reduce``'s
plain version, and the chain schedules on 8 rank processes against
``core.group.psum``.  Without ``--device`` it wants the card, and raises
where there is none."""

import os
import subprocess
import sys
from pathlib import Path

import pytest
import torch

from repro_torch.examples import quickstart

ROOT = Path(__file__).resolve().parents[1]


def test_quickstart_without_device_and_no_cuda_raises(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        quickstart.main([])


def test_quickstart_on_the_cpu_runs_to_ok():
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    out = subprocess.run([sys.executable, "-m", "repro_torch.examples.quickstart", "--device", "cpu"],
                         cwd=ROOT, env=env, capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stdout[-2000:] + out.stderr[-4000:]
    lines = out.stdout.splitlines()
    assert lines[-1] == "quickstart OK"
    assert any("fold windows through chunk_reduce (0 kernel launches on cpu)" in l for l in lines)
    assert sum("== group.psum" in l for l in lines) == 3
    assert all("HOST_STAGED_LINK" in l for l in lines if "nBL>S" in l)
