"""Run one cell of the benchmark of ``repro_torch`` once, on the card, and
print its result as the last line of standard output.

    python3 hoplite_bench/run.py --workload allreduce-1gib --seed 7 --seconds 30 --trace 0

from the root of a checkout (``src/repro_torch`` beside this folder).
``--trace 0`` reports the cell's end-to-end metrics, ``--trace 1`` its
per-layer metrics, read from a ``torch.profiler`` trace of the window.  The
numbers compared against the plain reference are printed beside their limits
as the last lines of standard error, and under ``checks``, last in the line.
Without a CUDA device, with fewer devices than the cell asks for, without the
program beside this folder, or with JAX or the JAX package loaded once the
window has closed, it exits with a code other than 0 and prints no result.
"""

import time

T_PROCESS = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

BENCH_DIR = Path(__file__).resolve().parent
ROOT = BENCH_DIR.parent
# Every build and kernel cache at a fixed path inside the checkout (the
# program builds its CUDA libraries under build/repro_torch_kernels/ itself).
CACHES = {"TORCH_EXTENSIONS_DIR": "build/torch_extensions", "TRITON_CACHE_DIR": "build/triton"}


def fail(msg: str, code: int) -> int:
    print(f"hoplite_bench: {msg}", file=sys.stderr, flush=True)
    return code


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    a = p.parse_args(argv)
    for var, path in CACHES.items():
        os.environ[var] = str(ROOT / path)
    sys.path.insert(0, str(ROOT))
    sys.path.insert(0, str(ROOT / "src"))
    import torch

    from hoplite_bench import harness

    harness.phase("imported torch", T_PROCESS)

    cell = harness.Bench(ROOT).cell(a.workload)
    if not torch.cuda.is_available():
        return fail("no CUDA device: the benchmark runs only on the card", 3)
    if torch.cuda.device_count() < cell.chips:
        return fail(f"{a.workload} needs {cell.chips} devices, {torch.cuda.device_count()} present", 3)
    try:
        import repro_torch
    except ImportError as e:
        return fail(f"the program is not beside the benchmark: {e}", 4)
    if not Path(repro_torch.__file__).resolve().is_relative_to(ROOT / "src"):
        return fail(f"repro_torch was imported from {repro_torch.__file__}, not from {ROOT / 'src'}", 4)
    torch.cuda.init()
    harness.phase("CUDA context", T_PROCESS)
    try:
        out = harness.run_cell(ROOT, a.workload, a.seed, a.seconds, bool(a.trace), t_process=T_PROCESS)
    except harness.ForbiddenImport as e:
        return fail(str(e), 5)
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
