"""Hoplite public API types (paper Table 1); port of ``repro.core.api``.

The Hoplite interface is intentionally minimal:

    Buffer <- Get(object_id)
    Put(object_id, buffer)
    Delete(object_id)
    Reduce(target_object_id, {source_object_id, ...}, op)

Objects are immutable once complete.  In the port an object is a
``torch.uint8`` buffer on the cluster's device (the card by default), and
values are tensors there.  The directory tracks *partial* and
*complete* copies per node so that partial copies can act as senders
(pipelining, paper section 4.2).
"""

from __future__ import annotations

import dataclasses
import enum
import itertools
import threading
from typing import Callable, Dict, Optional

import numpy as np
import torch

from repro_torch.kernels import ops

# Small objects (< 64 KB) are inlined in the object directory itself
# (paper section 4.1, "Optimization for small objects").
SMALL_OBJECT_THRESHOLD = 64 * 1024

# Default pipelining granularity (paper section 6.1 uses 4 KB; the cluster
# autotunes per object, see core.local.LocalCluster.chunk_size_for).
DEFAULT_CHUNK_SIZE = 4 * 1024

_id_counter = itertools.count()


def fresh_object_id(prefix: str = "obj") -> str:
    """Generate a unique ObjectID string (paper: 'unique string')."""
    return f"{prefix}-{next(_id_counter)}"


class Progress(enum.Enum):
    """Single progress bit per location (paper section 4.1)."""

    PARTIAL = 0
    COMPLETE = 1


# The dtypes the data plane holds: numpy's, where torch has a counterpart
# with arithmetic on the card.  numpy's unsigned 16/32/64-bit integers have
# torch types without a CUDA ``add``, so a reduce of them could not run: the
# cluster refuses them at Put.
DTYPES = {
    "bool": torch.bool, "uint8": torch.uint8, "int8": torch.int8, "int16": torch.int16,
    "int32": torch.int32, "int64": torch.int64, "float16": torch.float16,
    "bfloat16": torch.bfloat16, "float32": torch.float32, "float64": torch.float64,
}
_SUPPORTED = frozenset(DTYPES.values())


def check_dtype(dtype: torch.dtype) -> torch.dtype:
    """``dtype`` if the data plane holds it, else ``TypeError``."""
    if dtype not in _SUPPORTED:
        raise TypeError(
            f"the data plane holds {sorted(DTYPES)}, not {dtype}: torch has no "
            "counterpart with arithmetic on the card for numpy's unsigned 16/32/64-bit "
            "integers (no CUDA add), and none for the others")
    return dtype


def as_tensor(value, device: torch.device) -> torch.Tensor:
    """``value`` (a tensor, a numpy array or anything ``np.asarray`` takes) as a
    contiguous tensor on ``device``, its bytes copied there.  numpy's
    ``bfloat16`` (ml_dtypes) becomes ``torch.bfloat16`` bit for bit."""
    if not isinstance(value, torch.Tensor):
        arr = np.asarray(value)
        if not arr.flags.c_contiguous:
            arr = np.ascontiguousarray(arr)  # (which would make a 0-d array 1-d)
        name = arr.dtype.name
        if name not in DTYPES:
            raise TypeError(f"the data plane holds {sorted(DTYPES)}, not numpy {name}")
        if name == "bfloat16":
            value = torch.from_numpy(arr.view(np.uint16)).view(torch.bfloat16)
        else:
            value = torch.from_numpy(arr)
    check_dtype(value.dtype)
    return value.to(device).contiguous()


class ReduceOp:
    """A commutative + associative reduction (paper: sum, min, max).

    ``fn(a, b)`` returns the elementwise result; ``into(a, b, out)`` writes it
    into ``out`` (which may be ``a``), the form a reduce hop uses to fold a
    window straight into its output buffer.  ``counts`` says how often each
    route ran."""

    def __init__(self, name: str, fn: Callable, identity=None,
                 into: Optional[Callable] = None):
        self.name = name
        self.fn = fn
        self.identity = identity
        self._into = into
        self._lock = threading.Lock()
        self.counts: Dict[str, int] = {}

    def __call__(self, a, b):
        return self.fn(a, b)

    def into(self, a, b, out):
        if self._into is None:
            return out.copy_(self.fn(a, b))
        return self._into(a, b, out)

    def count(self, route: str) -> None:
        with self._lock:
            self.counts[route] = self.counts.get(route, 0) + 1

    def reset_counts(self) -> None:
        with self._lock:
            self.counts.clear()

    def __repr__(self):
        return f"ReduceOp({self.name})"


# SUM of these goes through the hand-written ``chunk_reduce`` (f32 math,
# rounded once to the type, as numpy adds f16 and bf16): the Hoplite reduce
# hop, ``repro/kernels/chunk_reduce.py``.  Other dtypes add with
# ``torch.add``: the JAX package sums them in numpy with no Pallas kernel,
# and the kernel's f32 math would change an f64 or integer sum.
KERNEL_DTYPES = (torch.float32, torch.bfloat16, torch.float16)


def _sum_into(a, b, out=None):
    if a.dtype in KERNEL_DTYPES:
        SUM.count("chunk_reduce")
        return ops.chunk_reduce(a, b, out=out)
    SUM.count("add")
    return torch.add(a, b) if out is None else torch.add(a, b, out=out)


def _min_into(a, b, out=None):
    MIN.count("minimum")
    return torch.minimum(a, b) if out is None else torch.minimum(a, b, out=out)


def _max_into(a, b, out=None):
    MAX.count("maximum")
    return torch.maximum(a, b) if out is None else torch.maximum(a, b, out=out)


SUM = ReduceOp("sum", _sum_into, into=_sum_into)
MIN = ReduceOp("min", _min_into, into=_min_into)
MAX = ReduceOp("max", _max_into, into=_max_into)


@dataclasses.dataclass
class Location:
    """One entry in the directory's location list for an object."""

    node: int
    progress: Progress
    # Monotonic count of bytes present at `node` for this object; used by
    # the simulator/threaded store to enforce that a partial copy never
    # forwards bytes it has not yet received.
    bytes_present: int = 0
    # True when the bytes are *generated* at this node (a reduce target
    # being reduced into, a Put mid-copy) rather than relayed from another
    # copy.  A producing partial keeps advancing with no upstream feed, so
    # receivers chasing it must never conclude the cohort is stuck, and a
    # reduce chain may admit it as a streaming source before COMPLETE.
    producing: bool = False


class ObjectLost(RuntimeError):
    """All copies of an object disappeared (node failures)."""


class ObjectAlreadyExists(ValueError):
    """Put() called twice with non-identical buffers for the same ID."""
