"""The readings that set the limits of ``correct``: the program's, the
controls', and the planted faults', on the card at a cell's own size, over
several seeds in one process.

    python3 hoplite_bench/control.py --workload asgd-resnet50 --seeds 1,2,3 --seconds 51
    python3 hoplite_bench/control.py --workload asgd-resnet50 --seeds 1,2,3 --seconds 10 --fault half

For each seed it runs the cell as ``run.py`` does (set-up, a window of
``--seconds``, the drain, the judge) and then puts each control in the
program's place: the plain reference computed in a precision below the
configuration's (``CONTROLS`` or ``CONTROL_DTYPE`` in ``reference/``), on
the same inputs and, for the parameter server, the same membership of
rounds.  With ``--fault`` the run's program carries that fault of
``faults.py``, planted anew for each seed.  It prints one JSON line a seed
with the readings beside the limits.  The benchmark's own runs never run the
controls or the faults.
"""

import argparse
import gc
import json
import sys
from pathlib import Path

BENCH_DIR = Path(__file__).resolve().parent
ROOT = BENCH_DIR.parent


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", required=True, help="comma-separated")
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--device", default="cuda")
    p.add_argument("--fault", default=None, help="one of faults.NAMES")
    a = p.parse_args(argv)
    sys.path[:0] = [str(ROOT / "src"), str(ROOT)]
    import torch

    from hoplite_bench import faults, harness

    if a.device == "cuda" and not torch.cuda.is_available():
        print("control: no CUDA device", file=sys.stderr)
        return 3
    driver = harness.Bench(ROOT).cell(a.workload).traffic["driver"]
    for seed in (int(s) for s in a.seeds.split(",")):
        undo = faults.plant(driver, a.fault) if a.fault else (lambda: None)
        try:
            out = harness.run_cell(ROOT, a.workload, seed, a.seconds, False, device=a.device,
                                   control=not a.fault)
        finally:
            undo()
        print(json.dumps({"workload": a.workload, "seed": seed, "fault": a.fault, "correct": out["correct"],
                          "program": out["checks"], "control": out.get("control"),
                          "metrics": out["metrics"], "device": out["device"]}), flush=True)
        del out
        gc.collect()
        if a.device == "cuda":
            torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
