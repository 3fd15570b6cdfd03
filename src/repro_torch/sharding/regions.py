"""Local regions of a DTensor program: ``local_map`` that a trace can count.

``local_region(fn, ...)`` is ``torch.distributed.tensor.experimental.local_map``:
``fn`` runs on each device's local blocks of its DTensor arguments.  Beside
that it records how many distinct blocks of work the region's devices do:
the product of the sizes of the mesh dims on which an input is split (a
replicated mesh dim repeats the same work).  ``launch.op_cost`` reads it, so
that the unsharded program's FLOPs of a region are its local FLOPs times that
count.  The count holds while ``fn`` runs, and in the backward for the
autograd nodes ``fn`` made (their ``metadata["region_shards"]``), recomputed
chunks of a checkpoint included.
"""

from __future__ import annotations

import functools
import math
from typing import Callable, List

import torch
from torch.distributed.tensor import DTensor, Partial, Replicate, Shard
from torch.distributed.tensor.experimental import local_map

_SHARDS: List[int] = []


def shards_now() -> int:
    """The region count of the operation running now: the innermost region's
    in its forward, the autograd node's in a backward, else 1."""
    if _SHARDS:
        return _SHARDS[-1]
    node = torch._C._current_autograd_node()
    return node.metadata.get("region_shards", 1) if node is not None else 1


def _tag(outputs, inputs, shards: int) -> None:
    """Mark the autograd nodes between ``inputs`` and ``outputs`` with ``shards``."""
    stop = {id(t.grad_fn) for t in inputs if isinstance(t, torch.Tensor) and t.grad_fn is not None}
    todo = [t.grad_fn for t in outputs if isinstance(t, torch.Tensor) and t.grad_fn is not None]
    seen = set()
    while todo:
        node = todo.pop()
        if node is None or id(node) in seen or id(node) in stop:
            continue
        seen.add(id(node))
        node.metadata["region_shards"] = shards
        todo.extend(n for n, _ in node.next_functions)


def _counted(fn: Callable, shards: int) -> Callable:
    @functools.wraps(fn)
    def run(*args):
        _SHARDS.append(shards)
        try:
            out = fn(*args)
        finally:
            _SHARDS.pop()
        if shards > 1 and torch.is_grad_enabled():
            flat = out if isinstance(out, (tuple, list)) else (out,)
            _tag(flat, args, shards)
        return out

    return run


class _GradPartialOver(torch.autograd.Function):
    """Identity forward; backward, the gradient's placements on ``dims`` read
    as partial sums: a tensor whole on a mesh dim that splits a region's work
    gets, from each device, the gradient of that device's part only."""

    @staticmethod
    def forward(ctx, x, dims):
        ctx.dims = dims
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        places = [Partial() if i in ctx.dims else p for i, p in enumerate(g.placements)]
        return DTensor.from_local(g.to_local(), g.device_mesh, places, run_check=False,
                                  shape=g.shape, stride=g.stride()), None


def local_region(fn: Callable, out_placements, in_placements, mesh) -> Callable:
    """``local_map(fn, out_placements, in_placements, redistribute_inputs=True,
    device_mesh=mesh)``, counted as a region (module docstring).  One thing
    more: an input whole on a mesh dim where another input is split gets the
    sum over that dim's devices as its gradient, where ``local_map`` would
    take one device's part for the whole (``_GradPartialOver``)."""
    split = [any(isinstance(places[i], Shard) for places in in_placements if places is not None)
             for i in range(mesh.ndim)]
    shards = math.prod(n for n, s in zip(mesh.shape, split) if s)
    mapped = local_map(_counted(fn, shards), out_placements=out_placements, in_placements=in_placements,
                       redistribute_inputs=True, device_mesh=mesh)

    def place(a, places):
        if places is None or not isinstance(a, DTensor) or not (a.requires_grad and torch.is_grad_enabled()):
            return a
        a = a.redistribute(mesh, places)
        dims = tuple(i for i, (s, p) in enumerate(zip(split, places)) if s and isinstance(p, Replicate))
        return _GradPartialOver.apply(a, dims) if dims else a

    return lambda *args: mapped(*(place(a, p) for a, p in zip(args, in_placements)))
