"""Rank code of the port's multi-rank tests, run in the processes that
``repro_torch.core.group.run_ranks`` spawns (tests/test_torch_collectives.py on
the CPU, tests/test_torch_gpu.py on the card).  It imports only the port, and
torch and numpy: a rank process never loads JAX.

Each function runs every case in one process group and returns the outputs,
so a test file pays for one spawn.  Beside each output it records how many
``group.exchange`` steps and ``ops.chunk_reduce`` hops the case made in this
rank (counted by wrapping both functions in this process), how many
kernel launches ``ops.launch_counts`` saw, and where the output lay.
"""

from __future__ import annotations

import time

import numpy as np
import torch
import torch.distributed as dist

from repro_torch import convert
from repro_torch.configs import get_config, reduced_config
from repro_torch.core import collectives as C
from repro_torch.core import group as G
from repro_torch.kernels import ops
from repro_torch.tree import leaves
from repro_torch.train.step import TrainOptions, _pod_sync_fn, make_train_step

GRAD_METHODS = ("psum", "hoplite", "chain", "chain2d", "rs_ag")
POD_SYNCS = ("hoplite_chain", "hoplite_2d", "psum")


class _Recorder:
    """Outputs and per-case counts of one rank."""

    def __init__(self):
        self.out, self.calls = {}, {}
        self._n = {"exchange": 0, "chunk_reduce": 0}
        exchange, chunk_reduce = G.exchange, ops.chunk_reduce

        def counted_exchange(*a, **k):
            self._n["exchange"] += 1
            return exchange(*a, **k)

        def counted_chunk_reduce(*a, **k):
            self._n["chunk_reduce"] += 1
            return chunk_reduce(*a, **k)

        G.exchange, ops.chunk_reduce = counted_exchange, counted_chunk_reduce

    def case(self, name, fn):
        self._n.update(exchange=0, chunk_reduce=0)
        ops.reset_launch_counts()
        self.out[name] = fn()
        self.calls[name] = dict(self._n, launches=ops.launch_counts()["chunk_reduce"],
                                devices=sorted({t.device.type for t in leaves(self.out[name])}))

    def result(self):
        return {"out": self.out, "calls": self.calls}


def _tree(x: np.ndarray, r: int, dev):
    return {"a": torch.from_numpy(x[r:r + 1]).to(dev),
            "b": torch.from_numpy(x[r:r + 1, :17] * 2).to(dev)}


def collective_cases(dev, x: np.ndarray, xx: np.ndarray, ref_config: C.CollectiveConfig):
    """The cases of tests/test_collectives_multidev.py and more, on 8 ranks:
    ``x`` (8, 1536) holds row r for rank r; ``xx`` (2, 4, 32) feeds the four
    pairs (i, i + 4) that make groups of n = 2; ``ref_config`` carries the
    reference's ICI link values where a schedule's dispatch depends on them."""
    r = dist.get_rank()
    rec = _Recorder()
    a = torch.from_numpy(x[r:r + 1]).to(dev)
    for c in (4, 16):
        rec.case(f"chain_allreduce/{c}", lambda c=c: C.chain_allreduce(a, None, c))
    rec.case("two_level_allreduce/4", lambda: C.two_level_allreduce(a, None, 4))
    rec.case("rs_ag_allreduce", lambda: C.rs_ag_allreduce(a))
    rec.case("hoplite_psum", lambda: C.hoplite_psum(a, None, ref_config))
    rec.case("chain_reduce/4", lambda: C.chain_reduce(a, None, 4))
    y = torch.full((1, 64), 2.5 if r == 7 else 0.0, device=dev)
    rec.case("chain_broadcast/last", lambda: C.chain_broadcast(y, None, 4))
    y0 = torch.full((1, 64), -1.5 if r == 0 else 0.0, device=dev)
    rec.case("chain_broadcast/first", lambda: C.chain_broadcast(y0, None, 4, root="first"))
    for root in (0, 3, 7):
        z = torch.full((1, 16), root + 1.0 if r == root else 0.0, device=dev)
        rec.case(f"binomial_broadcast/{root}", lambda z=z, root=root: C.binomial_broadcast(z, None, root))

    pairs = [dist.new_group([i, i + 4]) for i in range(4)]  # every rank makes every group
    pair = pairs[r % 4]
    b = torch.from_numpy(xx[r // 4, r % 4][None]).to(dev)
    rec.case("n2/chain_allreduce", lambda: C.chain_allreduce(b, pair, 8))
    rec.case("n2/two_level_allreduce", lambda: C.two_level_allreduce(b, pair, 4))
    rec.case("n2/rs_ag_allreduce", lambda: C.rs_ag_allreduce(b, pair))
    rec.case("n2/chain_reduce", lambda: C.chain_reduce(b, pair, 4))

    tree = _tree(x, r, dev)
    for method in GRAD_METHODS:
        rec.case(f"grad_sync/{method}", lambda m=method: C.grad_sync(tree, None, m, ref_config))
    for pod_sync in POD_SYNCS:
        for comp in (False, True):
            sync = _pod_sync_fn(TrainOptions(pod_sync=pod_sync, pod_compression=comp))
            rec.case(f"pod_sync/{pod_sync}/{'int8' if comp else 'raw'}", lambda s=sync: s(tree))
    return rec.result()


def card_cases(dev, x: np.ndarray):
    """A few allreduces of ``x`` (n, 1536), row r on rank r, with the launches
    of the hop kernel that each made in this rank."""
    r = dist.get_rank()
    rec = _Recorder()
    a = torch.from_numpy(x[r:r + 1]).to(dev)
    rec.case("chain_allreduce/4", lambda: C.chain_allreduce(a, None, 4))
    rec.case("two_level_allreduce/4", lambda: C.two_level_allreduce(a, None, 4))
    rec.case("rs_ag_allreduce", lambda: C.rs_ag_allreduce(a))
    rec.case("pod_sync/hoplite_chain/raw", lambda: _pod_sync_fn(TrainOptions())(_tree(x, r, dev)))
    return rec.result()


def train_pod_steps(dev, state_np, batches, options: TrainOptions):
    """Train steps of reduced qwen3-14b with every rank a pod: rank r takes
    the r-th share of each global batch (numpy), the gradients meet by
    ``options.pod_sync`` over the world group.  Returns the state and the
    metrics of each step."""
    r, n = dist.get_rank(), dist.get_world_size()
    cfg = reduced_config(get_config("qwen3-14b"))
    state = convert.state_from_jax(state_np, cfg, dev)
    step = make_train_step(cfg, options, pod=dist.group.WORLD)
    metrics = []
    for b in batches:
        share = b["tokens"].shape[0] // n
        mine = {k: torch.from_numpy(v[r * share:(r + 1) * share]).to(dev) for k, v in b.items()}
        state, m = step(state, mine)
        metrics.append({k: float(v) for k, v in m.items()})
    return {"state": state, "metrics": metrics}


def fail_on_rank_1(dev):
    if dist.get_rank() == 1:
        raise ValueError("rank 1 fails")
    return dist.get_rank()


def hang(dev):
    time.sleep(600)
