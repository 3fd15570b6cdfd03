"""Batched serving of a small model with the KV-cache engine on an 8-rank
FSDP x TP mesh (port of ``examples/serve_batched.py``).

Reduced gemma3-27b (its local:global pattern and tail) on the debug mesh,
(data 4, model 2), as 8 rank processes that share the device
(``core.group.run_ranks`` with the ``staged`` backend): prefill plus greedy
decode must reproduce the full forward on the first generated token (the
strongest property a cache path can satisfy), then the slot-based
continuous batching loop serves a queue of requests.

    PYTHONPATH=src python -m repro_torch.examples.serve_batched [--device cpu]
"""

from __future__ import annotations

import argparse
import os
import time

import numpy as np
import torch
import torch.distributed as dist

from repro_torch.configs import ARCHS, reduced_config
from repro_torch.core import group as G
from repro_torch.device import resolve_device
from repro_torch.launch.mesh import make_debug_mesh
from repro_torch.launch.serve import build_engine
from repro_torch.serving.engine import BatchingLoop, Request, ServeOptions

MAX_NEW = 6


def _rank(dev: torch.device, requests: int):
    cfg = reduced_config(ARCHS["gemma3-27b"])  # local:global pattern + tail
    mesh = make_debug_mesh(device=dev)
    if dev.type == "cpu":  # the ranks share the host's cores
        torch.set_num_threads(max(1, (os.cpu_count() or 1) // mesh.size()))
    eng = build_engine(cfg, dev, 0, ServeOptions(max_seq=64, batch_size=4), mesh)
    rng = np.random.RandomState(0)
    batch = {"tokens": rng.randint(0, cfg.vocab_size, (4, 12)).astype(np.int32)}

    # consistency: prefill+decode must reproduce the full forward
    toks = eng.generate(batch, 8)
    first = eng.forward(batch)[:, -1, : cfg.vocab_size].argmax(-1).cpu().numpy()
    np.testing.assert_array_equal(toks[:, 0], first)

    loop = BatchingLoop(eng)
    for rid in range(requests):
        plen = int(rng.randint(4, 13))
        loop.submit(Request(rid, rng.randint(0, cfg.vocab_size, plen), max_new=MAX_NEW))
    t0 = time.time()
    completed = loop.run()
    dt = time.time() - t0
    if dist.get_rank() != 0:
        return None
    return {"tokens": toks, "completed": [(r.rid, r.done, list(map(int, r.output))) for r in completed],
            "seconds": dt}


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--requests", type=int, default=10, help="requests queued for the batching loop")
    ap.add_argument("--device", default=None, help="default: cuda (raises when absent)")
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)
    out = G.run_ranks(_rank, 8, dev, args.requests, timeout=900.0)[0]
    print("prefill/decode == full forward on the first generated token")
    total = sum(len(o) for _, _, o in out["completed"])
    print(f"continuous batching: {len(out['completed'])} requests, {total} tokens in {out['seconds']:.2f}s "
          f"({total / out['seconds']:.1f} tok/s)")
    assert len(out["completed"]) == args.requests and all(done for _, done, _ in out["completed"])
    print("serve_batched OK")
    return out


if __name__ == "__main__":
    main()
