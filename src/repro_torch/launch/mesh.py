"""Production and debug meshes (port of ``repro.launch.mesh``).

Functions, not module-level constants: importing this module starts no
process group and touches no device.

``make_production_mesh`` and ``make_debug_mesh`` return a ``DeviceMesh``
over the default process group, which must already hold as many ranks as
the mesh has devices: (data=16, model=16), or (pod=2, data=16, model=16)
with ``multi_pod``; the debug meshes are (4, 2) and (2, 2, 2) with the same
axis names.  ``AbstractMesh`` is the shape alone (the counterpart of
``jax.sharding.AbstractMesh``), which the partitioning rules read as they
read a ``DeviceMesh``.  ``fake_mesh`` holds a whole production or debug
mesh in one process through torch's ``fake`` backend, whose collectives do
nothing: with ``FakeTensorMode`` a DTensor on it has its local shape and no
storage.
"""

from __future__ import annotations

import contextlib
import dataclasses
import math
from typing import Iterator, Tuple

import torch.distributed as dist
from torch.distributed.device_mesh import init_device_mesh

AXES = ("data", "model")
POD_AXES = ("pod", "data", "model")


@dataclasses.dataclass(frozen=True)
class AbstractMesh:
    """A mesh's axis sizes and names, with no devices behind it."""

    shape: Tuple[int, ...]
    mesh_dim_names: Tuple[str, ...]

    def size(self) -> int:
        return math.prod(self.shape)


def production_mesh_shape(*, multi_pod: bool = False) -> AbstractMesh:
    return AbstractMesh((2, 16, 16), POD_AXES) if multi_pod else AbstractMesh((16, 16), AXES)


def debug_mesh_shape(*, multi_pod: bool = False) -> AbstractMesh:
    """Small mesh for 8-device CI-scale tests (same axis names)."""
    return AbstractMesh((2, 2, 2), POD_AXES) if multi_pod else AbstractMesh((4, 2), AXES)


def _device_mesh(shape: AbstractMesh):
    n = dist.get_world_size() if dist.is_initialized() else 0
    if n != shape.size():
        raise RuntimeError(f"a {shape.shape} mesh needs a default process group of {shape.size()} ranks; "
                           f"it has {n or 'none'}")
    # a mesh of host ranks: the gloo and fake backends; no partitioner runs on the card yet
    return init_device_mesh("cpu", shape.shape, mesh_dim_names=shape.mesh_dim_names)


def make_production_mesh(*, multi_pod: bool = False):
    return _device_mesh(production_mesh_shape(multi_pod=multi_pod))


def make_debug_mesh(*, multi_pod: bool = False):
    return _device_mesh(debug_mesh_shape(multi_pod=multi_pod))


@contextlib.contextmanager
def fake_mesh(*, multi_pod: bool = False, debug: bool = False, rank: int = 0) -> Iterator:
    """A production (or, with ``debug``, a debug) ``DeviceMesh`` held by this
    one process as rank ``rank`` of the ``fake`` backend; the process group
    is destroyed on exit.  One default group per process: a fake mesh cannot
    be opened inside another, nor beside a real group."""
    from torch.testing._internal.distributed.fake_pg import FakeStore

    shape = (debug_mesh_shape if debug else production_mesh_shape)(multi_pod=multi_pod)
    if dist.is_initialized():
        raise RuntimeError("fake_mesh: a default process group is already initialised")
    dist.init_process_group("fake", store=FakeStore(), rank=rank, world_size=shape.size())
    try:
        yield _device_mesh(shape)
    finally:
        dist.destroy_process_group()
