"""Build the port's CUDA kernels at first use and load them with ctypes.

Each ``csrc/<name>.cu`` is compiled by ``nvcc`` for ``sm_90a`` into a shared
library with a plain C interface, under ``build/repro_torch_kernels/<hash>/``
at the root of the checkout, keyed by a hash of the flags, the sources and
every header (``csrc/*.cuh``).  All
libraries missing from the cache are compiled in parallel, one ``nvcc`` per
source.  A missing ``nvcc`` or a failed build raises; nothing is fetched.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path
from typing import Dict, Iterable

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_ROOT = Path(__file__).resolve().parents[3] / "build" / "repro_torch_kernels"
SOURCES = ("rmsnorm", "flash_attention", "flash_attention_sm90", "chunk_reduce")
TOOLKIT_NVCC = "/usr/local/cuda/bin/nvcc"
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)

_lock = threading.Lock()
_libs: Dict[str, ctypes.CDLL] = {}


def find_nvcc() -> str:
    """Path of ``nvcc``: ``$CUDA_HOME/bin``, then ``PATH``, then the toolkit's default."""
    candidates = []
    if os.environ.get("CUDA_HOME"):
        candidates.append(os.path.join(os.environ["CUDA_HOME"], "bin", "nvcc"))
    candidates.append(shutil.which("nvcc"))
    candidates.append(TOOLKIT_NVCC)
    for c in candidates:
        if c and os.path.isfile(c) and os.access(c, os.X_OK):
            return c
    raise RuntimeError(
        "nvcc not found (looked in $CUDA_HOME/bin, PATH and /usr/local/cuda/bin); "
        "the port's CUDA kernels are built from source and need the CUDA toolkit"
    )


def _build_dir() -> Path:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for path in [CSRC / f"{name}.cu" for name in SOURCES] + sorted(CSRC.glob("*.cuh")):
        h.update(path.name.encode())
        h.update(path.read_bytes())
    return BUILD_ROOT / h.hexdigest()[:16]


def build(names: Iterable[str] = SOURCES) -> Dict[str, str]:
    """Compile the named libraries that are not built yet, all at once.

    Returns the compiler's report (``-Xptxas -v``: registers, shared memory,
    spills) for each library built by this call.  Raises ``RuntimeError`` if
    ``nvcc`` is missing or any build fails.
    """
    out_dir = _build_dir()
    todo = [n for n in names if not (out_dir / f"lib{n}.so").exists()]
    if not todo:
        return {}
    nvcc = find_nvcc()
    out_dir.mkdir(parents=True, exist_ok=True)
    procs = {}
    try:
        for n in todo:
            tmp = out_dir / f"lib{n}.so.{os.getpid()}.tmp"
            cmd = [nvcc, *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{n}.cu")]
            procs[n] = (tmp, subprocess.Popen(
                cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
        reports, failed = {}, []
        for n, (tmp, p) in procs.items():
            log, _ = p.communicate()
            reports[n] = log
            if p.returncode != 0:
                failed.append(f"{n}.cu (exit {p.returncode}):\n{log}")
            else:
                (out_dir / f"lib{n}.log").write_text(log)
                os.replace(tmp, out_dir / f"lib{n}.so")  # atomic: concurrent builds agree
    finally:
        for tmp, p in procs.values():
            if p.poll() is None:
                p.kill()
                p.wait()
            tmp.unlink(missing_ok=True)
    if failed:
        raise RuntimeError("nvcc failed to build " + "\n".join(failed))
    return reports


def report(name: str) -> str:
    """The compiler's report for ``lib<name>.so`` (registers, shared memory,
    spills per kernel), kept beside it when it was built; built first if need be."""
    build([name])
    return (_build_dir() / f"lib{name}.log").read_text()


def load(name: str) -> ctypes.CDLL:
    """The loaded library ``lib<name>.so``, built first if need be."""
    with _lock:
        if name not in _libs:
            build([name])
            _libs[name] = ctypes.CDLL(str(_build_dir() / f"lib{name}.so"))
        return _libs[name]
