"""Logical-axis -> mesh-axis sharding rules (port of
``repro.sharding.partitioning``), as DTensor placements.

Production meshes:  (data=16, model=16)  and  (pod=2, data=16, model=16).

  * weights:  FSDP -- "embed" over data; TP -- "mlp"/"heads"/"kv"/"vocab"/
    "ssm" over model; "expert" over model when E % tp == 0 (then the
    expert-internal "mlp" dim stays unsharded); replicated across pods
    (the pod axis is pure DP: gradients cross pods via Hoplite chains).
  * optimizer state shards exactly like its parameter.
  * batch dims shard over (pod, data) when divisible (train/prefill/
    decode); long_500k (batch=1) replicates batch and shards the cache
    length over (pod, data, model) instead.

Every mapping is divisibility-checked per tensor; a non-divisible dim
falls back to replication and is recorded in a module-level list that only
grows, as the JAX package's does.

A spec is kept as the JAX package writes it (``PartitionSpec``, the port's
own type): one entry per tensor dim, each ``None``, one mesh axis name or a
tuple of names, trailing ``None``s implicit.  ``placements(spec, mesh)``
turns it into DTensor placements, one per mesh dim: ``Shard(d)`` where the
mesh axis appears in entry ``d``, else ``Replicate()``.  Several mesh axes on
one tensor dim split it in mesh order (the first axis outermost), as JAX
splits a tuple; a tuple out of mesh order would need ``_StridedShard`` and
raises ``NotImplementedError`` (no config and no default option reaches it).

A mesh here is anything with ``mesh_dim_names`` and a ``shape`` tuple: a
``torch.distributed.DeviceMesh`` or ``launch.mesh.AbstractMesh``, which
holds no process group.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Dict, List, Optional, Sequence, Tuple

from torch.distributed.tensor import Replicate, Shard

from repro_torch.configs.base import ModelConfig
from repro_torch.models.common import Param, is_param


class PartitionSpec(tuple):
    """Mesh axes per tensor dim: ``None``, an axis name, or a tuple of names."""

    def __new__(cls, *entries):
        return super().__new__(cls, entries)

    def __repr__(self) -> str:
        return f"PartitionSpec{tuple.__repr__(self)}"


P = PartitionSpec


@dataclasses.dataclass(frozen=True)
class ShardingOptions:
    fsdp_axis: str = "data"
    tp_axis: str = "model"
    dp_axes: Tuple[str, ...] = ("pod", "data")  # batch dims (subset present)
    # hillclimb knobs
    shard_embed_over_pod: bool = False  # FSDP over (pod,data) instead of DP
    sequence_parallel: bool = False  # shard activation seq dim over model


def mesh_axes(mesh) -> Dict[str, int]:
    """{axis name: size}, in mesh order."""
    return dict(zip(mesh.mesh_dim_names, mesh.shape))


def _axes_of(entry) -> Tuple[str, ...]:
    if entry is None:
        return ()
    return tuple(entry) if isinstance(entry, tuple) else (entry,)


def placements(spec: Sequence, mesh) -> tuple:
    """DTensor placements of ``spec`` on ``mesh``: for each mesh dim, in
    order, ``Shard(d)`` if its axis is in the spec's entry ``d``, else
    ``Replicate()``."""
    names = list(mesh.mesh_dim_names)
    dim_of: Dict[str, int] = {}
    for d, entry in enumerate(spec):
        axes = _axes_of(entry)
        for a in axes:
            if a not in names:
                raise ValueError(f"{spec}: axis {a!r} is not on the mesh {tuple(names)}")
            if a in dim_of:
                raise ValueError(f"{spec}: axis {a!r} shards two tensor dims")
            dim_of[a] = d
        order = [names.index(a) for a in axes]
        if order != sorted(order):
            raise NotImplementedError(
                f"{spec}: the axes {axes} of dim {d} are out of the mesh's order {tuple(names)}; "
                "DTensor would need _StridedShard for that")
    return tuple(Shard(dim_of[a]) if a in dim_of else Replicate() for a in names)


def local_slices(shape: Sequence[int], places: Sequence, mesh, coordinate: Sequence[int]) -> Tuple[slice, ...]:
    """The block of a tensor of ``shape`` that the device at ``coordinate``
    holds under ``places``: each tensor dim split by its ``Shard`` mesh dims
    in mesh order, the first outermost (even splits, as every spec of
    ``param_specs``, ``batch_specs`` and ``cache_specs`` divides)."""
    start, size = [0] * len(shape), list(shape)
    for n, c, pl in zip(mesh.shape, coordinate, places):
        if isinstance(pl, Shard):
            d = pl.dim
            if size[d] % n:
                raise ValueError(f"dim {d} of {tuple(shape)} does not split in {n}")
            size[d] //= n
            start[d] += c * size[d]
    return tuple(slice(s, s + k) for s, k in zip(start, size))


def expert_parallel(cfg: ModelConfig, mesh, opts: ShardingOptions) -> bool:
    tp = mesh_axes(mesh)[opts.tp_axis]
    return cfg.num_experts > 0 and cfg.num_experts % tp == 0


def logical_rules(cfg: ModelConfig, mesh, opts: ShardingOptions) -> Dict[str, object]:
    ep = expert_parallel(cfg, mesh, opts)
    fsdp: object = opts.fsdp_axis
    if opts.shard_embed_over_pod and "pod" in mesh.mesh_dim_names:
        fsdp = ("pod", opts.fsdp_axis)
    return {
        "embed": fsdp,
        "mlp": None if ep else opts.tp_axis,  # EP owns the model axis
        "heads": opts.tp_axis,
        "kv": opts.tp_axis,
        "vocab": opts.tp_axis,
        "ssm": opts.tp_axis,
        "expert": opts.tp_axis if ep else None,
        "layers": None,
    }


_REPLICATION_FALLBACKS: List[str] = []


def spec_for_param(p: Param, rules: Dict[str, object], mesh) -> PartitionSpec:
    """PartitionSpec with per-dim divisibility checks."""
    sizes = mesh_axes(mesh)
    entries = []
    for dim, ax in zip(p.shape, p.axes):
        mesh_ax = rules.get(ax) if ax is not None else None
        if mesh_ax is None:
            entries.append(None)
            continue
        size = math.prod(sizes[a] for a in _axes_of(mesh_ax))
        if dim % size != 0:
            _REPLICATION_FALLBACKS.append(f"{ax}:{dim}%{size}")
            entries.append(None)
        else:
            entries.append(mesh_ax)
    return P(*entries)


def _map_in_jax_order(fn, skel):
    """``fn`` on every ``Param``, called in JAX's flatten order (a dict's keys
    sorted), so that the fallbacks are listed in the JAX package's order; the
    tree keeps the skeleton's own order."""
    if is_param(skel):
        return fn(skel)
    if isinstance(skel, dict):
        done = {k: _map_in_jax_order(fn, skel[k]) for k in sorted(skel)}
        return {k: done[k] for k in skel}
    return type(skel)(_map_in_jax_order(fn, v) for v in skel)


def param_specs(cfg: ModelConfig, skel, mesh, opts: ShardingOptions = ShardingOptions()):
    """PartitionSpec tree matching a model/optimizer skeleton.

    MoE expert FFN weights carry both "expert" and "mlp" axes; when EP is
    on, "mlp" must not also claim the model axis (the rules table), but a
    dense FFN's "mlp" (no "expert" axis) still takes it: TP on mlp."""
    rules = logical_rules(cfg, mesh, opts)
    ep = expert_parallel(cfg, mesh, opts)

    def one(p: Param) -> PartitionSpec:
        r = rules
        if ep and "expert" not in p.axes and "mlp" in p.axes:
            r = dict(rules, mlp=opts.tp_axis)
        return spec_for_param(p, r, mesh)

    return _map_in_jax_order(one, skel)


def param_placements(cfg: ModelConfig, skel, mesh, opts: ShardingOptions = ShardingOptions()):
    """The tree of DTensor placements of ``param_specs`` (the JAX package's
    ``param_shardings``)."""
    specs = param_specs(cfg, skel, mesh, opts)
    return tree_map_specs(lambda s: placements(s, mesh), specs)


def tree_map_specs(fn, tree):
    """``fn`` on every ``PartitionSpec`` of a tree of dicts and lists."""
    if isinstance(tree, PartitionSpec):
        return fn(tree)
    if isinstance(tree, dict):
        return {k: tree_map_specs(fn, v) for k, v in tree.items()}
    return type(tree)(tree_map_specs(fn, v) for v in tree)


# ---------------------------------------------------------------------------
# batch / cache shardings per shape cell
# ---------------------------------------------------------------------------


def _batch_axes(mesh, batch: int, opts: ShardingOptions) -> Optional[Tuple[str, ...]]:
    sizes = mesh_axes(mesh)
    axes = [a for a in opts.dp_axes if a in sizes]
    size = math.prod(sizes[a] for a in axes)
    while axes and batch % size != 0:
        axes = axes[1:]
        size = math.prod(sizes[a] for a in axes)
    return tuple(axes) or None


def batch_specs(cfg: ModelConfig, mesh, shape, opts: ShardingOptions = ShardingOptions()):
    """PartitionSpec dict for a training/prefill batch."""
    b_ax = _batch_axes(mesh, shape.global_batch, opts)
    seq_ax = opts.tp_axis if opts.sequence_parallel else None
    out = {"tokens": P(b_ax, seq_ax), "labels": P(b_ax, seq_ax)}
    if cfg.rope == "mrope":
        out["positions_3d"] = P(None, b_ax, seq_ax)
    if cfg.is_encoder_decoder:
        out["encoder_frames"] = P(b_ax, None, None)
    return out


def cache_specs(cfg: ModelConfig, mesh, batch: int, opts: ShardingOptions = ShardingOptions()):
    """PartitionSpec tree for decode caches, mirroring ``cache_skel``.

    KV caches (layers, B, C, K, D): batch over (pod,data) when divisible;
    cache length C over model -- flash-decoding-style partial softmax.
    long_500k (batch=1): C over (pod, data, model).  SSM states: batch
    over dp axes; inner dim over model."""
    from repro_torch.models.transformer import cache_spec_skel

    b_ax = _batch_axes(mesh, batch, opts)
    if b_ax is None:
        seq_ax: object = tuple(a for a in ("pod", "data", "model") if a in mesh.mesh_dim_names)
    else:
        seq_ax = opts.tp_axis
    return cache_spec_skel(cfg, b_ax, seq_ax, opts.tp_axis)


def token_batch_spec(mesh, batch: int, opts: ShardingOptions = ShardingOptions()) -> PartitionSpec:
    return P(_batch_axes(mesh, batch, opts), None)


def replication_fallbacks() -> List[str]:
    return list(_REPLICATION_FALLBACKS)
