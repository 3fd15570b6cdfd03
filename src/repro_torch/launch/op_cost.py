"""Per-device cost of a traced step (counterpart of ``repro.launch.hlo_cost``).

``hlo_cost`` walks compiled XLA HLO, which the port does not have.  Here the
walker is a pair of ``TorchDispatchMode``s over the aten operations a step
dispatches, run with the step (on DTensors of a ``fake_mesh`` under
``FakeTensorMode`` in the dry run, or on plain tensors):

  * below DTensor (``_DeviceCounter``, which lets DTensor desugar first, as
    ``MemTracker`` and ``CommDebugMode`` do, and skips the operations DTensor's
    sharding propagation runs on fakes of its own, as ``MemTracker`` does) it
    sees the operations one device runs, on local shapes: their FLOPs (``torch.utils.flop_counter``'s
    formulas, the port's custom ops' included), their bytes, and the
    ``_c10d_functional`` collectives DTensor's redistributions call;
  * above DTensor (``_GlobalCounter``) it sees each DTensor operation on its
    global shapes: the unsharded program's FLOPs, ``flops_global``.  An
    operation of a ``sharding.regions.local_region`` runs on local tensors;
    its global FLOPs are its local ones times the region's count of distinct
    blocks (``regions.shards_now``).

``analyze`` returns ``hlo_cost.analyze``'s keys, per device:

  * ``flops``: 2·m·k·n per matrix product and the registered formulas of the
    custom ops (the flash kernels over their visible pairs); no flop for an
    elementwise operation (``hlo_cost`` adds one per fusion output element);
  * ``bytes``: each operation's local input and output bytes, summed, views
    excluded.  Unfused: every operation reads and writes memory, where XLA's
    fusions keep their insides in registers;
  * ``collective_link_bytes`` and ``collectives_by_kind``: each collective's
    local bytes and group size turned into the bytes that cross links by
    ``dryrun.link_bytes`` (``repro.launch.dryrun.parse_collectives``' ring
    formulas), plus the Hoplite exchanges' bytes (``core.group.exchange``) as
    "collective-permute", the kind the JAX chain lowers to.  Kinds are spelled
    in full; ``hlo_cost`` cuts them with ``rstrip`` ("all-gath").

and ``flops_global`` beside them; ``collectives`` is the record's own
``parse_collectives``-shaped summary (per kind: link bytes and counts).
"""

from __future__ import annotations

import contextlib
from typing import Any, Dict

import torch
from torch._guards import active_fake_mode
from torch.distributed.tensor import DTensor
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_flatten
from torch.utils.flop_counter import flop_registry

from repro_torch.core import group as G
from repro_torch.sharding import regions

_F = torch.ops._c10d_functional
# collective op -> its kind: the functional collectives DTensor calls, and
# the c10d ops of a direct ``dist`` call (``core.group.psum``), by name
_FUNCTIONAL = {
    _F.all_gather_into_tensor.default: "all-gather",
    _F.reduce_scatter_tensor.default: "reduce-scatter",
    _F.all_reduce.default: "all-reduce",
    _F.all_reduce_.default: "all-reduce",
    _F.all_to_all_single.default: "all-to-all",
    _F.broadcast.default: "broadcast",
}
_C10D = {"allreduce_": "all-reduce", "allgather_": "all-gather", "_allgather_base_": "all-gather",
         "reduce_scatter_": "reduce-scatter", "_reduce_scatter_base_": "reduce-scatter",
         "alltoall_": "all-to-all", "alltoall_base_": "all-to-all", "broadcast_": "broadcast"}
# the exchange's own sends and receives, counted by core.group
_P2P = {"send", "recv_", "recv_any_source_"}


def link_bytes(kind: str, size: float, n: int) -> float:
    """Bytes that cross links per device for one collective whose result
    (``size`` bytes; for reduce-scatter the scattered shard) spans a group of
    ``n``: ``repro.launch.dryrun.parse_collectives``' ring formulas."""
    if kind == "all-reduce":
        return 2 * size * (n - 1) / max(1, n)
    if kind in ("all-gather", "all-to-all"):
        return size * (n - 1) / max(1, n)
    if kind == "reduce-scatter":
        return size * (n - 1)
    return size  # collective-permute, broadcast


def _nbytes(t) -> int:
    if isinstance(t, DTensor):
        t = t.to_local()
    return t.numel() * t.element_size() if isinstance(t, torch.Tensor) else 0


def _group_size(func, args, kwargs) -> int:
    """The group size a collective's arguments name: its ``group_size``, its
    ``group_name`` resolved, or its ProcessGroup's size."""
    from torch.distributed.distributed_c10d import _resolve_process_group

    named = dict(zip((a.name for a in func._schema.arguments), args), **kwargs)
    if "group_size" in named:
        return int(named["group_size"])
    if "group_name" in named:
        return _resolve_process_group(named["group_name"]).size()
    return torch._C._distributed_c10d.ProcessGroup.unbox(named["process_group"]).size()


class Cost:
    """Counts of one traced region (``analyze`` reads them)."""

    def __init__(self) -> None:
        self.flops = 0.0
        self.flops_global = 0.0
        self.bytes = 0.0
        self.link: Dict[str, float] = {}
        self.count: Dict[str, int] = {}
        self.ops = 0
        self.flops_by_op: Dict[str, float] = {}
        self.inside_dtensor = 0
        self._sent0 = G.exchange_counts()

    def collective(self, kind: str, size: float, n: int) -> None:
        self.link[kind] = self.link.get(kind, 0.0) + link_bytes(kind, size, n)
        self.count[kind] = self.count.get(kind, 0) + 1

    def analyze(self) -> Dict[str, Any]:
        sent = G.exchange_counts()
        link, count = dict(self.link), dict(self.count)
        sent_bytes = sent["bytes"] - self._sent0["bytes"]
        if sent_bytes:
            link["collective-permute"] = link.get("collective-permute", 0.0) + sent_bytes
            count["collective-permute"] = count.get("collective-permute", 0) + sent["sends"] - self._sent0["sends"]
        total = sum(link.values())
        return {
            "walker": {"flops": self.flops, "flops_global": self.flops_global, "bytes": self.bytes,
                       "collective_link_bytes": total, "collectives_by_kind": link},
            "collectives": {"per_kind_bytes": link, "per_kind_count": count, "total_link_bytes": total},
            "ops": self.ops,
            "flops_by_op": dict(sorted(self.flops_by_op.items(), key=lambda kv: -kv[1])),
        }


def _flops(func, args, kwargs, out) -> float:
    formula = flop_registry.get(func._overloadpacket)
    return float(formula(*args, **kwargs, out_val=out)) if formula is not None else 0.0


class _DeviceCounter(TorchDispatchMode):
    """The operations one device runs (DTensor desugars before this mode)."""

    def __init__(self, cost: Cost):
        super().__init__()
        self.cost = cost
        self._fake_mode = active_fake_mode()

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        if any(issubclass(t, DTensor) for t in types):
            return NotImplemented
        kwargs = kwargs or {}
        out = func(*args, **kwargs)
        if active_fake_mode() is not self._fake_mode:
            return out  # DTensor's sharding propagation, on fakes of its own
        c = self.cost
        c.ops += 1
        kind = _FUNCTIONAL.get(func)
        if kind is None and func.namespace == "c10d":
            if func._opname in _P2P:
                return out
            kind = _C10D.get(func._opname)
        if kind is not None:
            res = [t for t in tree_flatten(out)[0] if isinstance(t, torch.Tensor)]
            c.collective(kind, sum(_nbytes(t) for t in res), _group_size(func, args, kwargs))
            return out
        if func is _F.wait_tensor.default:
            return out
        flops = _flops(func, args, kwargs, out)
        c.flops += flops
        if flops:
            name = str(func.overloadpacket)
            c.flops_by_op[name] = c.flops_by_op.get(name, 0.0) + flops
        if not c.inside_dtensor:  # a plain program's, or a local region's operation
            c.flops_global += flops * regions.shards_now()
        if not func.is_view:
            c.bytes += sum(_nbytes(t) for t in tree_flatten((args, kwargs, out))[0] if isinstance(t, torch.Tensor))
        return out


class _GlobalCounter(TorchDispatchMode):
    """Each DTensor operation on its global shapes."""

    def __init__(self, cost: Cost):
        super().__init__()
        self.cost = cost

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        if not any(issubclass(t, DTensor) for t in types):
            return func(*args, **kwargs)
        self.cost.inside_dtensor += 1
        try:
            out = func(*args, **kwargs)
        finally:
            self.cost.inside_dtensor -= 1
        self.cost.flops_global += _flops(func, args, kwargs, out)
        return out


@contextlib.contextmanager
def dtensor_beside_fake_mode():
    """Two spots where DTensor's own bookkeeping meets the trace's
    ``FakeTensorMode``, set right while the trace runs:

      * its sharding propagation runs each operation once more on global
        shapes to learn the output's metadata, under the active fake mode if
        there is one: in the trace's own, ``MemTracker`` and ``op_cost`` would
        count those global tensors as this device's.  It gets a fake mode of
        its own, which both skip;
      * it computes a ``_StridedShard``'s local indices with a small
        ``torch.arange`` and ``tolist``, which a fake tensor cannot give: that
        index arithmetic runs on real tensors (a few integers)."""
    from torch._subclasses.fake_tensor import unset_fake_temporarily
    from torch.distributed.tensor._sharding_prop import ShardingPropagator
    from torch.distributed.tensor.placement_types import _StridedShard

    def unfaked(fn):
        def run(*args, **kwargs):
            with unset_fake_temporarily():
                return fn(*args, **kwargs)
        return run

    patched = [(ShardingPropagator, "_propagate_tensor_meta_non_cached"), (_StridedShard, "local_shard_size_and_offset")]
    saved = [getattr(cls, name) for cls, name in patched]
    for (cls, name), fn in zip(patched, saved):
        setattr(cls, name, unfaked(fn))
    try:
        yield
    finally:
        for (cls, name), fn in zip(patched, saved):
            setattr(cls, name, fn)


class count:
    """``with op_cost.count() as cost: step(...)``, then ``cost.analyze()``.
    Enter it inside ``FakeTensorMode`` (and ``MemTracker``, under
    ``dtensor_beside_fake_mode``) when they are used: its modes must sit
    above them."""

    def __enter__(self) -> Cost:
        self.cost = Cost()
        self._patch = dtensor_beside_fake_mode()
        self._patch.__enter__()
        self._modes = [_DeviceCounter(self.cost), _GlobalCounter(self.cost)]
        for m in self._modes:
            m.__enter__()
        return self.cost

    def __exit__(self, *exc) -> None:
        for m in reversed(self._modes):
            m.__exit__(*exc)
        self._patch.__exit__(*exc)
