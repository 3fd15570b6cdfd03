"""Does the port's fused allreduce overlap its receivers with the reduce?

Runs the allreduce of ``tests/test_torch_dataplane_cluster.py``'s overlap
test (4 nodes, 64,000 f64 a source, 64 KB chunks, 3 ms a window) ``--runs``
times in each of ``--procs`` processes, while ``--burners`` processes keep
every core busy with torch products.  After each run it reads the stores'
recorded window times: the lead is the first receiver window's time less
the root's last window's time, and a run with no negative lead is store and
forward.  ``--intra-op-copies`` moves the store's host windows with torch's
``copy_`` and zero their buffers with ``torch.zeros`` again (as before
``store.copy_bytes`` and ``store.zero_bytes``).

    python3 dataplane_overlap_probe.py --burners 6 --procs 6
    python3 dataplane_overlap_probe.py --device cuda

Prints one JSON line: the runs, how many were store and forward, and the
leads in ms.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time

HERE = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, os.path.join(HERE, "src"))


def burn(seconds: float) -> None:
    import torch

    a = torch.randn(1500, 1500)
    end = time.time() + seconds
    while time.time() < end:
        a = (a @ a).tanh()


def leads(runs: int, device: str, intra_op_copies: bool, seed: int) -> list:
    import numpy as np
    import torch

    from repro_torch.core import store
    from repro_torch.core.local import LocalCluster

    if intra_op_copies:
        store.copy_bytes = lambda dst, src: dst.copy_(src)
        store.zero_bytes = lambda size, dev: torch.zeros(size, dtype=torch.uint8, device=dev)
    out = []
    for r in range(runs):
        rng = np.random.RandomState(seed + r)
        c = LocalCluster(4, chunk_size=64 << 10, pace=0.003, device=device)
        try:
            for i in range(4):
                c.put(i, f"g{i}", torch.from_numpy(rng.randn(64_000)))
            c.allreduce(list(range(4)), "ar", [f"g{i}" for i in range(4)], timeout=60.0)
            last = c.stores[0].get("ar").last_window_at
            out.append(min(c.stores[i].get("ar").first_window_at for i in (1, 2, 3)) - last)
        finally:
            c.shutdown()
    return out


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--device", default="cpu")
    ap.add_argument("--runs", type=int, default=20, help="allreduces in each process")
    ap.add_argument("--procs", type=int, default=1)
    ap.add_argument("--burners", type=int, default=0)
    ap.add_argument("--intra-op-copies", action="store_true")
    ap.add_argument("--worker", type=int, default=None, help=argparse.SUPPRESS)
    ap.add_argument("--burn", type=float, default=None, help=argparse.SUPPRESS)
    a = ap.parse_args()
    if a.burn is not None:
        burn(a.burn)
        return 0
    if a.worker is not None:
        print(json.dumps(leads(a.runs, a.device, a.intra_op_copies, 1000 * a.worker)))
        return 0
    me = [sys.executable, os.path.abspath(__file__)]
    burners = [subprocess.Popen(me + ["--burn", "3600"]) for _ in range(a.burners)]
    try:
        flags = ["--device", a.device, "--runs", str(a.runs)] + (
            ["--intra-op-copies"] if a.intra_op_copies else [])
        workers = [subprocess.Popen(me + flags + ["--worker", str(w)], stdout=subprocess.PIPE, text=True)
                   for w in range(a.procs)]
        got = []
        for w in workers:
            out, _ = w.communicate()
            if w.returncode != 0:
                raise SystemExit(f"worker failed with exit code {w.returncode}")
            got += json.loads(out.strip().splitlines()[-1])
    finally:
        for b in burners:
            b.kill()
            b.wait()
    ms = sorted(x * 1e3 for x in got)
    print(json.dumps({"device": a.device, "burners": a.burners, "procs": a.procs,
                      "intra_op_copies": a.intra_op_copies, "runs": len(ms),
                      "store_and_forward": sum(x >= 0 for x in ms),
                      "lead_ms_min": ms[0], "lead_ms_median": ms[len(ms) // 2], "lead_ms_max": ms[-1]}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
