"""Faults planted underneath a cell's timed path, each of which the judge has
to find: a step that leaves the state unchanged, half of the inputs left
out, the exchange between nodes left out, and an answer altered where it is
produced.  The CPU tests plant them at small sizes (``tests/test_hb_faults.py``)
and ``control.py --fault <name>`` at a cell's own size on the card.

``plant(name)`` patches the program's class for the rest of the process, or
until the function it returns is called; a fault that breaks the ``n``-th
call counts its calls from the planting.
"""

from __future__ import annotations

import torch


def _allreduce_faults(orig):
    def unchanged(self, nodes, target, sources, op, **kw):
        """Every node's result is its own input, as if no step ran."""
        for node, src in zip(nodes, sources):
            self.put(node, target, self.get(node, src))
        return target

    def half(self, nodes, target, sources, op, **kw):
        """Half of the inputs left out of the sum."""
        return orig(self, nodes, target, list(sources)[: len(sources) // 2], op, **kw)

    def no_exchange(self, nodes, target, sources, op, **kw):
        """The sum reaches the root and no other node."""
        return self.reduce(nodes[0], target, sources, op)

    def altered(self, nodes, target, sources, op, **kw):
        """One element of one node's result altered where it is produced."""
        out = orig(self, nodes, target, sources, op, **kw)
        self.stores[nodes[3]].get(target).data.view(torch.float32)[7] += 1
        return out

    return {"unchanged": unchanged, "half": half, "no_exchange": no_exchange, "altered": altered}


def _nth_reduce(orig, n, how):
    """``LocalCluster.reduce`` that breaks its ``n``-th call's result."""
    calls = []

    def reduce(cluster, node, target, *a, **kw):
        out = orig(cluster, node, target, *a, **kw)
        calls.append(target)
        if len(calls) == n:
            how(cluster.stores[node].get(target).data.view(torch.float32))
        return out
    return reduce


def _runtime_reduce_keep(orig, k):
    def reduce(self, refs, op, *a, **kw):
        return orig(self, list(refs)[:k], op, *a, **kw)
    return reduce


NAMES = ("unchanged", "half", "no_exchange", "altered")


def plant(driver: str, name: str):
    """Plant fault ``name`` of a cell whose traffic ``driver`` is
    ``collective`` (its allreduce) or ``parameter_server``; returns the
    function that takes it out."""
    from repro_torch.core.local import LocalCluster
    from repro_torch.runtime import Runtime

    if driver == "collective":
        cls, attr = LocalCluster, "allreduce"
        fn = _allreduce_faults(LocalCluster.allreduce)[name]
    elif driver == "parameter_server":
        cls, attr = (LocalCluster, "reduce") if name in ("unchanged", "altered") else (Runtime, "reduce")
        orig = getattr(cls, attr)
        fn = {
            # a round that leaves the parameters as they were: its gradient sum zeroed
            "unchanged": lambda: _nth_reduce(orig, 8, lambda t: t.zero_()),
            # half of the gradients taken left out of the sum
            "half": lambda: _runtime_reduce_keep(orig, 2),
            # no exchange: one worker's gradient stands for the round's
            "no_exchange": lambda: _runtime_reduce_keep(orig, 1),
            # a gradient sum altered where it is produced: its sign flipped once
            "altered": lambda: _nth_reduce(orig, 8, lambda t: t.neg_()),
        }[name]()
    else:
        raise KeyError(f"no faults for driver {driver!r}")
    saved = cls.__dict__[attr]
    setattr(cls, attr, fn)
    return lambda: setattr(cls, attr, saved)
