"""Quickstart: Hoplite in 60 seconds, on the card (port of
``examples/quickstart.py``).

1. An in-process Hoplite cluster whose 8 nodes' stores lie on the device:
   Put / Get / Reduce with real bytes -- watch the receiver-driven broadcast
   tree emerge and the reduce chain stream partial results.  The float64
   reduce sums with ``torch.add``; a float32 reduce folds every window with
   the ``chunk_reduce`` kernel.
2. The same schedules as collectives of 8 rank processes that share the
   device (``core.group.run_ranks``, the port's counterpart of
   ``shard_map``): the paper's chain allreduce, the 2-D chain and the ring
   against ``core.group.psum``.  The nBL>S rule is shown on the port's
   measured host-staged link, ``HOST_STAGED_LINK``.

Run:  PYTHONPATH=src python -m repro_torch.examples.quickstart [--device cpu]
"""

from __future__ import annotations

import argparse

import numpy as np
import torch

from repro_torch.device import resolve_device

RANKS = 8


def object_store_demo(device: torch.device) -> None:
    from repro_torch.core.api import SUM
    from repro_torch.core.local import LocalCluster
    from repro_torch.kernels import ops

    print(f"== Hoplite object store (8 in-process nodes, stores on {device}) ==")
    cluster = LocalCluster(8, chunk_size=8192, pace=0.0002, device=device)

    # Put once, Get from 7 receivers: the broadcast tree builds itself.
    x = torch.from_numpy(np.random.RandomState(0).rand(200_000).astype(np.float32)).to(device)
    cluster.put(0, "weights", x)
    futs = [cluster.get_async(i, "weights") for i in range(1, 8)]
    for f in futs:
        assert torch.equal(f.result(timeout=30), x)
    relays = [i for i, b in enumerate(cluster.bytes_sent_per_node) if b > 0 and i != 0]
    print(f"   broadcast delivered to 7 receivers; relay nodes (not the "
          f"producer!): {relays}")
    print(f"   per-node egress bytes: {cluster.bytes_sent_per_node}")

    # Dynamic reduce: contributions arrive in arbitrary order, chain adapts.
    grads = [np.random.RandomState(i).rand(50_000).astype(np.float64) for i in range(8)]
    for i, g in enumerate(grads):
        cluster.put(i, f"grad{i}", g)
    cluster.reduce(3, "sum", [f"grad{i}" for i in range(8)])
    np.testing.assert_allclose(cluster.get(3, "sum").cpu().numpy(), sum(grads), rtol=1e-12)
    print("   chained Reduce across 8 nodes (float64, torch.add): exact")

    # The same chain in float32: every fold window is chunk_reduce.
    SUM.reset_counts()
    launches = ops.launch_counts()["chunk_reduce"]
    for i, g in enumerate(grads):
        cluster.put(i, f"grad32-{i}", g.astype(np.float32))
    cluster.reduce(5, "sum32", [f"grad32-{i}" for i in range(8)])
    got = cluster.get(5, "sum32").cpu().numpy()
    np.testing.assert_allclose(got, sum(g.astype(np.float32).astype(np.float64) for g in grads), rtol=2e-6)
    folds = SUM.counts.get("chunk_reduce", 0)
    assert folds >= 7 and SUM.counts == {"chunk_reduce": folds}
    launched = ops.launch_counts()["chunk_reduce"] - launches
    assert launched == (folds if device.type == "cuda" else 0)
    print(f"   chained Reduce in float32: {folds} fold windows through chunk_reduce "
          f"({launched} kernel launches on {device})")

    # Fault tolerance: kill a node holding the only extra copy; re-fetch.
    cluster.fail_node(1)
    y = cluster.get(5, "weights", timeout=30)
    assert torch.equal(y, x)
    print("   node 1 killed mid-flight; Get(5) recovered from surviving copies")
    cluster.shutdown()


def _collectives_rank(device: torch.device, x: np.ndarray) -> dict:
    """One rank of part 2: its row of ``x`` through each schedule."""
    import torch.distributed as dist

    from repro_torch.core import collectives as C
    from repro_torch.core import group as G

    a = torch.from_numpy(x[dist.get_rank()][None]).to(device)
    return {"psum": G.psum(a), "fused chain (paper)": C.chain_allreduce(a, num_chunks=8),
            "2-D chain": C.two_level_allreduce(a, num_chunks=8), "ring RS+AG": C.rs_ag_allreduce(a)}


def collectives_demo(device: torch.device) -> None:
    from repro_torch.core import group as G
    from repro_torch.core.planner import HOST_STAGED_LINK, use_two_dimensional

    print(f"== Hoplite chain schedules as collectives ({RANKS} rank processes on {device}) ==")
    x = np.random.RandomState(1).rand(RANKS, 4096).astype(np.float32)
    outs = G.run_ranks(_collectives_rank, RANKS, str(device), x, timeout=300.0)
    for r, out in enumerate(outs):
        psum = out["psum"].numpy()
        for name in ("fused chain (paper)", "2-D chain", "ring RS+AG"):
            got = out[name].numpy()
            np.testing.assert_allclose(got, psum, rtol=1e-5)
            if r == 0:
                print(f"   {name:20s} == group.psum  (max |diff| {np.abs(got - psum).max():.2e})")
    print(f"   every rank of {RANKS} agrees")
    for size, n in [(64 << 10, 256), (64 << 20, 256)]:
        sel = "2-D" if use_two_dimensional(n, HOST_STAGED_LINK, size) else "1-D"
        print(f"   nBL>S rule on HOST_STAGED_LINK (the port's measured host-staged link, "
              f"not a TPU link): {size >> 10} KiB over {n} ranks -> {sel} chain")


def main(argv=None) -> None:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--device", default=None, help="default: cuda")
    a = p.parse_args(argv)
    device = resolve_device(a.device)
    object_store_demo(device)
    collectives_demo(device)
    print("quickstart OK")


if __name__ == "__main__":
    main()
