"""Whether full-width qwen3-14b training fits the one card as 8 mesh ranks.

    python3 chip_mesh_fit.py

On (data 4, model 2) and on (pod 2, data 2, model 2), at the smallest depth
and microbatch count (1 layer, 1 microbatch) and the mesh phase's 4 x 2048
tokens, it prints the dry run's peak a rank (``chip_smoke.mesh_peak_prediction``,
fake ``cuda`` tensors on a fake mesh) and the card's free memory, then runs
``chip_smoke.mesh_train`` (``launch.train.run`` on the mesh, after one
process took the same steps and was freed) without ``chip_smoke.mesh_fits``'
guard, and prints how each run ended: its records, or the failing rank's
out-of-memory line (what that rank had allocated and what the card had in
use).  This is why ``chip_smoke.py``'s mesh phase trains qwen3-14b's layer
widths with the vocabulary cut to ``MESH_VOCAB``.  Needs the card; exits
non-zero if a run fails for another reason than the card's memory.
"""

from __future__ import annotations

import sys
import time
from pathlib import Path

SIZES = ((1, 1, False, ("gspmd",)), (1, 1, True, ("hoplite_chain",)))  # layers, microbatches, multi-pod, syncs


def main() -> int:
    import torch

    root = Path(__file__).resolve().parent
    sys.path[:0] = [str(root / "src"), str(root)]
    import chip_smoke as CS
    from repro_torch.configs import get_config
    from repro_torch.kernels import _build

    if not torch.cuda.is_available():
        print("chip_mesh_fit: no CUDA device", file=sys.stderr)
        return 1
    card = CS.card_line()
    print(f"[fit] {card}", flush=True)
    _build.build()
    full = get_config(CS.ARCH)
    CS.mesh_fits = lambda torch_, per_rank, what: CS.log(
        f"[fit] {what}: the dry run's peak {per_rank / 1e9:.3f} GB a rank, {CS.MESH_RANKS} ranks "
        f"{CS.MESH_RANKS * per_rank / 1e9:.2f} GB; the card has {torch.cuda.mem_get_info()[0] / 1e9:.2f} of "
        f"{torch.cuda.mem_get_info()[1] / 1e9:.2f} GB free; run without the guard")
    for layers, micro, multi_pod, syncs in SIZES:
        t0 = time.perf_counter()
        try:
            CS.mesh_train(torch, card, full, layers, micro, multi_pod, syncs, lambda _: None)
            print(f"[fit] {layers} layer(s), {micro} microbatch(es), multi-pod {multi_pod}: ran "
                  f"({time.perf_counter() - t0:.1f} s)", flush=True)
        except RuntimeError as e:
            oom = [line for line in str(e).splitlines() if "OutOfMemoryError" in line]
            if not oom:
                raise
            print(f"[fit] {layers} layer(s), {micro} microbatch(es), multi-pod {multi_pod}: out of the card's "
                  f"memory after {time.perf_counter() - t0:.1f} s: {oom[0]}", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
