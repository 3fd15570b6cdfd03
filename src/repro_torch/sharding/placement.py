"""Real tensors placed on a mesh by the partitioning rules: the port's
counterpart of ``jax.device_put(x, NamedSharding(mesh, spec))`` and
``jax.make_array_from_callback``.

Each leaf becomes a DTensor whose local block is this device's part under
``partitioning.placements(spec, mesh)``; where ``on`` is a sub-mesh of
``mesh`` (a pod's (data, model) mesh under a Hoplite pod sync) the block is
still cut on the whole mesh, and the DTensor keeps the placements of the
sub-mesh's dims (the pod's share is its global tensor).  Where a block comes
from, by ``source``:

  * ``"root"``: rank ``root`` makes the whole leaf (draws it, loads it) and
    sends every other rank its block, one rank after another, before the next
    leaf is made.  No rank holds more than one whole leaf at a time, and only
    the root holds one at all: the way to place a state at full width.
  * ``"block"``: every rank makes only its block (``make(slices)``), from
    numbers every rank can compute or read: a batch's rows, zero moments, a
    checkpoint's file read in place.
  * ``"each"``: every rank makes the whole leaf and cuts its block (the dry
    run, whose fake tensors hold no storage, and tests that draw the same
    whole tensors on every rank).

``gather_to_root`` is the other way: a DTensor whole on the root, on the
host, one leaf at a time (a checkpoint's write).  Every block is checked to
lie on the mesh's device (``check_on_mesh``): torch's ``DTensor.from_local``
would move it there without a word.
"""

from __future__ import annotations

import dataclasses
import weakref
from typing import Any, Callable, Dict, Optional, Tuple

import numpy as np
import torch
import torch.distributed as dist
from torch.distributed.tensor import DTensor

from repro_torch.core import group as G
from repro_torch.device import resolve_device
from repro_torch.models.common import draw_param
from repro_torch.sharding import partitioning
from repro_torch.sharding.partitioning import local_slices, tree_map_specs
from repro_torch.tree import leaves, tree_map

# Whole leaves this process holds now and held at most at once while placing
# ("root" and "each" sources), for the witness that a placement holds one.
_WHOLE = {"live": 0, "most": 0}


def whole_leaves_held() -> Dict[str, int]:
    """{"live", "most"}: whole leaves held by ``place`` in this process now and
    at most at once since ``reset_whole_leaves``."""
    return dict(_WHOLE)


def reset_whole_leaves() -> None:
    _WHOLE["most"] = _WHOLE["live"]


def _held(t: torch.Tensor) -> torch.Tensor:
    """Count ``t`` as a whole leaf until it is freed."""
    _WHOLE["live"] += 1
    _WHOLE["most"] = max(_WHOLE["most"], _WHOLE["live"])
    weakref.finalize(t, lambda: _WHOLE.__setitem__("live", _WHOLE["live"] - 1))
    return t


def mesh_device(device=None) -> torch.device:
    """The device of a mesh's ranks: ``device`` if given, else the one
    ``run_ranks`` gave this rank, else the host for the ``fake`` backend's
    ranks (which hold no device), else the card (``resolve_device``)."""
    if device is None and G.rank_device() is not None:
        return G.rank_device()
    if device is None and dist.is_initialized() and dist.get_backend() == "fake":
        return torch.device("cpu")
    return resolve_device(device)


def check_on_mesh(t: torch.Tensor, mesh) -> torch.Tensor:
    """``t`` (a local block) if it lies on ``mesh``'s device type; raises
    where ``DTensor.from_local`` would move it there."""
    if t.device.type != mesh.device_type:
        raise RuntimeError(f"a block on {t.device} for a mesh on {mesh.device_type}: "
                           "it would be moved, not computed where it was asked for")
    return t


def coordinates(mesh) -> Dict[int, Tuple[int, ...]]:
    """Global rank -> its coordinate on ``mesh``."""
    ranks = mesh.mesh.cpu().numpy()
    return {int(r): tuple(int(i) for i in idx) for idx, r in np.ndenumerate(ranks)}


def _keep(places, mesh, on) -> list:
    return [p for name, p in zip(mesh.mesh_dim_names, places) if name in on.mesh_dim_names]


def _from_root(make: Callable[[], torch.Tensor], shape, dtype, device, block, root: int) -> torch.Tensor:
    """This rank's block of the whole tensor that ``root`` makes: the root
    sends each other rank its block in rank order."""
    me = dist.get_rank()
    if me != root:
        out = torch.empty(tuple(s.stop - s.start for s in block(me)), dtype=dtype, device=device)
        dist.recv(out, src=root)
        return out
    whole = _held(make())
    if tuple(whole.shape) != tuple(shape) or whole.dtype != dtype:
        raise ValueError(f"made {tuple(whole.shape)} {whole.dtype}, the leaf is {tuple(shape)} {dtype}")
    for r in range(dist.get_world_size()):
        if r != root:
            dist.send(whole[block(r)].contiguous(), dst=r)
    mine = whole[block(me)].clone()
    del whole
    return mine


def place(like: torch.Tensor, spec, mesh, make: Callable, *, source: str = "root", on=None,
          root: int = 0) -> DTensor:
    """A DTensor on ``on`` (default ``mesh``) holding this rank's block of a
    tensor shaped and typed like ``like`` under ``spec`` on ``mesh``, made by
    ``make`` as ``source`` says (module docstring): ``make()`` is the whole
    tensor, ``make(slices)`` (``"block"``) this rank's block.  A received
    block is put on the mesh's device."""
    on = mesh if on is None else on
    shape = tuple(like.shape)
    places = partitioning.placements(spec, mesh)
    if source == "root":
        coords = coordinates(mesh)
        block = lambda r: local_slices(shape, places, mesh, coords[r])
        local = _from_root(make, shape, like.dtype, torch.device(mesh.device_type), block, root)
    else:
        mine = local_slices(shape, places, mesh, mesh.get_coordinate())
        if source == "block":
            local = make(mine)
        elif source == "each":
            whole = _held(make())
            local = whole[mine].contiguous()
            del whole
        else:
            raise ValueError(f"source {source!r}: one of 'root', 'block', 'each'")
    return DTensor.from_local(check_on_mesh(local, on), on, _keep(places, mesh, on), run_check=False)


@dataclasses.dataclass(frozen=True)
class Sharding:
    """Where a leaf goes (``jax.sharding.NamedSharding``): its spec on
    ``mesh``, held on the sub-mesh ``on`` (default ``mesh``)."""

    mesh: Any
    spec: partitioning.PartitionSpec
    on: Any = None


def shardings(specs, mesh, on=None):
    """A tree of ``Sharding`` from a tree of specs (``Checkpointer.restore``'s
    ``placements``)."""
    return tree_map_specs(lambda sp: Sharding(mesh, sp, on), specs)


class _SpecLeaf:
    """A spec as a leaf of ``tree.tree_map``, which would walk its tuple."""

    def __init__(self, spec):
        self.spec = spec


def spec_leaves(specs):
    """A tree of specs with each spec wrapped as one leaf (``place_tree``'s input)."""
    return tree_map_specs(_SpecLeaf, specs)


def place_tree(tree, specs, mesh, make: Callable, *, source: str = "root", on=None, root: int = 0):
    """``place`` on every leaf of ``tree`` (tensors, or ``meta`` tensors for
    their shapes and types) under the spec at the same place in ``specs``
    (a tree of ``PartitionSpec`` as ``param_specs``, ``batch_specs`` and
    ``cache_specs`` give them); ``make(leaf, ...)`` is called with the leaf
    before ``place``'s own arguments.  Leaves are placed one at a time, in
    the tree's order."""
    return tree_map(lambda t, s: place(t, s.spec, mesh, lambda *a: make(t, *a), source=source, on=on, root=root),
                    tree, spec_leaves(specs))


def init_params(skel, specs, mesh, generator: torch.Generator, device, dtype_override=None, on=None):
    """``common.init_params`` placed by ``specs`` on ``mesh``: rank 0 draws
    each parameter whole, from the stream one process draws, and sends every
    rank its block before it draws the next (``source="root"``)."""
    dtype = lambda p: getattr(torch, dtype_override or p.dtype)
    return tree_map(lambda p, s: place(torch.empty(p.shape, dtype=dtype(p), device="meta"), s.spec, mesh,
                                       lambda: draw_param(p, generator, device, dtype_override), on=on),
                    skel, spec_leaves(specs))


def gather_to_root(t: torch.Tensor, root: int = 0) -> Optional[torch.Tensor]:
    """The whole of DTensor ``t`` on the host of global rank ``root``
    (``None`` on every other rank), gathered without a collective: each
    distinct block of the (sub-)mesh that holds ``root`` is sent once, by the
    lowest rank holding it.  A rank on a sub-mesh without ``root`` (another
    pod's replica) sends nothing.  A plain tensor comes back on the host."""
    if not isinstance(t, DTensor):
        return t.detach().cpu() if dist.get_rank() == root else None
    mesh = t.device_mesh
    coords = coordinates(mesh)
    if root not in coords:
        return None
    shape = tuple(t.shape)
    blocks: Dict[Tuple, int] = {}
    for r in sorted(coords):
        sl = local_slices(shape, t.placements, mesh, coords[r])
        blocks.setdefault(tuple((s.start, s.stop) for s in sl), r)
    me, local = dist.get_rank(), t.to_local().detach()
    if me != root:
        if me in blocks.values():
            dist.send(local.contiguous(), dst=root)
        return None
    whole = torch.empty(shape, dtype=t.dtype)
    for key, r in blocks.items():
        sl = tuple(slice(a, b) for a, b in key)
        if r == root:
            whole[sl] = local.cpu()
        else:
            part = torch.empty(tuple(b - a for a, b in key), dtype=t.dtype)
            dist.recv(part, src=r)
            whole[sl] = part
    return whole


def check_tree_on(tree, device) -> None:
    """Raise unless every tensor of ``tree`` (a DTensor's local block) lies on
    ``device``'s type."""
    want = torch.device(device).type
    for t in leaves(tree):
        if isinstance(t, torch.Tensor):
            local = t.to_local() if isinstance(t, DTensor) else t
            if local.device.type != want:
                raise RuntimeError(f"a block of {tuple(t.shape)} lies on {local.device}, not on {want}")
