"""The paper's flagship application: an ASYNCHRONOUS parameter server on
the dynamic-task runtime over Hoplite (paper Figure 1b / section 6.3); port
of ``examples/async_parameter_server.py``.

A real linear-regression model is trained: workers compute gradients on
their own data shards at heterogeneous speeds; the server applies the
FIRST HALF of finishers via a Hoplite Reduce and broadcasts the new
parameters to exactly those workers -- the dynamic group pattern that
static collectives cannot express.  Mid-run, a NODE IS KILLED;
lineage reconstruction re-executes its lost tasks and training completes
with the loss still decreasing.

The JAX example kills the last node, which at its sizes loses nothing that
is needed again (objects under 64 KB live in the directory too).  This one
kills the node that holds the newest parameters, Put a moment before and
fetched by no one yet: above the inline size their only copy is lost, and
the next round's tasks re-execute the Put from its lineage.  At the
defaults nothing is lost, as in the JAX example.  ``run`` waits for the
tasks still in flight before it returns.

Parameters, gradients and shards are tensors on the runtime's device (the
card unless ``--device cpu``), and every fold of a gradient reduce is the
``chunk_reduce`` kernel there.  The defaults are the JAX example's
constants, and its data: numpy draws from the same seeds.  ``--dim`` and
``--samples`` size the model and the shards; past ``samples`` parameters
the learning rate scales by ``samples / dim`` (the gradient's curvature
grows as ``dim / samples`` there).  ``--data device`` draws the shards on
the device instead, from the same seeds, for sizes numpy would take
minutes to draw.

Run:  PYTHONPATH=src python -m repro_torch.examples.async_parameter_server [--device cpu]
"""

from __future__ import annotations

import argparse
import time
from typing import Callable, Dict, List, Optional

import numpy as np
import torch

from repro_torch.core.api import SUM
from repro_torch.device import resolve_device
from repro_torch.runtime import Runtime

DIM = 200
NUM_NODES = 4
NUM_WORKERS = 6
ROUNDS = 12
LR = 0.3
SAMPLES = 1000
W_SEED = 42


def learning_rate(dim: int, samples: int, lr: float = LR) -> float:
    """``lr``, scaled by ``samples / dim`` once the model has more parameters
    than a shard has samples."""
    return lr if dim <= samples else lr * samples / dim


def make_shards(workers: int, dim: int, samples: int, device: torch.device,
                data: str = "numpy") -> List[tuple]:
    """Shard ``s`` is ``(X, y)``, ``X`` of ``samples x dim`` standard normals
    drawn from seed ``s`` and ``y = X @ w_true``, ``w_true`` from seed 42.
    ``data="numpy"`` draws them as the JAX example does (the same arrays);
    ``data="device"`` draws them with torch generators on the device."""
    if data == "numpy":
        w_true = np.random.RandomState(W_SEED).randn(dim).astype(np.float32)
        shards = []
        for s in range(workers):
            X = np.random.RandomState(s).randn(samples, dim).astype(np.float32)
            shards.append((torch.from_numpy(X).to(device), torch.from_numpy(X @ w_true).to(device)))
        return shards
    if data != "device":
        raise ValueError(f"data is 'numpy' or 'device', not {data!r}")

    def normal(seed, *shape):
        g = torch.Generator(device=device).manual_seed(seed)
        return torch.randn(*shape, generator=g, device=device, dtype=torch.float32)

    w_true = normal(W_SEED, dim)
    shards = []
    for s in range(workers):
        X = normal(s, samples, dim)
        shards.append((X, X @ w_true))
    return shards


def run(nodes: int = NUM_NODES, workers: int = NUM_WORKERS, dim: int = DIM,
        samples: int = SAMPLES, rounds: int = ROUNDS, lr: Optional[float] = None,
        device=None, data: str = "numpy", log: Callable[[str], None] = print,
        runtime: Optional[Runtime] = None) -> Dict[str, object]:
    """Train for ``rounds`` rounds, killing (and restarting) the node that
    holds the newest parameters after round ``rounds // 2``.  Returns the losses (the first before any
    round), each round's seconds, the task counts and the runtime."""
    device = resolve_device(device)
    lr = learning_rate(dim, samples) if lr is None else lr
    rt = runtime or Runtime(num_nodes=nodes, executors_per_node=4, device=device)
    shards = make_shards(workers, dim, samples, device, data)
    w = torch.zeros(dim, dtype=torch.float32, device=device)
    w_ref = rt.put(w)

    def grad_task(w, shard_id, delay):
        X, y = shards[int(shard_id)]
        time.sleep(float(delay))  # heterogeneous rollout/compute time
        resid = X @ w - y
        return X.T @ resid / len(y)

    def loss_of(w):
        return float(torch.stack([torch.mean((X @ w - y) ** 2) for X, y in shards]).mean())

    rng = np.random.RandomState(0)
    losses = [loss_of(w)]
    round_s: List[float] = []
    inflight = [
        rt.remote(grad_task, w_ref, i, rng.uniform(0.005, 0.05), node=i % nodes)
        for i in range(workers)
    ]
    half = workers // 2
    killed = False
    for rnd in range(rounds):
        t0 = time.perf_counter()
        # ray.wait semantics: take the first `half` finishers
        done, inflight = rt.wait(inflight, num_returns=half, timeout=60)
        # Hoplite chained Reduce over the dynamic group
        gsum = rt.reduce(done, SUM)
        w = rt.get(gsum) / half * (-lr) + rt.get(w_ref)
        w_ref = rt.put(w)
        losses.append(loss_of(w))
        round_s.append(time.perf_counter() - t0)
        log(f"round {rnd+1}: applied {half} grads, loss={losses[-1]:.4f}, {round_s[-1]:.3f} s")
        if rnd == rounds // 2 and not killed:
            victim = rt.placement_of(w_ref)
            orphaned = rt.cluster.fail_node(victim)
            rt.cluster.restart_node(victim)
            killed = True
            log(f"  !! killed node {victim} (orphaned objects: {len(orphaned)}; "
                f"lineage will re-execute)")
        # finished workers start the next round with the new params
        for d in done:
            sid = rng.randint(0, workers)
            inflight.append(rt.remote(grad_task, w_ref, sid, rng.uniform(0.005, 0.05)))
    rt.wait(inflight, num_returns=len(inflight), timeout=60)
    return {"losses": losses, "round_s": round_s, "tasks_executed": rt.tasks_executed,
            "tasks_reexecuted": rt.tasks_reexecuted, "runtime": rt, "lr": lr}


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--nodes", type=int, default=NUM_NODES)
    p.add_argument("--workers", type=int, default=NUM_WORKERS)
    p.add_argument("--dim", type=int, default=DIM)
    p.add_argument("--samples", type=int, default=SAMPLES, help="samples per shard")
    p.add_argument("--rounds", type=int, default=ROUNDS)
    p.add_argument("--data", choices=("numpy", "device"), default="numpy")
    p.add_argument("--device", default=None, help="default: cuda")
    a = p.parse_args(argv)
    out = run(a.nodes, a.workers, a.dim, a.samples, a.rounds, device=a.device, data=a.data)
    losses = out["losses"]
    assert losses[-1] < losses[0] * 0.7, (losses[0], losses[-1])
    print(f"async PS OK: loss {losses[0]:.3f} -> {losses[-1]:.3f}; "
          f"tasks executed={out['tasks_executed']}, re-executed after failure="
          f"{out['tasks_reexecuted']}")
    out["runtime"].cluster.shutdown()


if __name__ == "__main__":
    main()
