"""The train step's cross-pod gradient sync (port of the part of
``repro.train.step`` that this slice covers).

The JAX train step reduces gradients within a pod through GSPMD and across
pods through the Hoplite chains over the "pod" mesh axis.  Here the pods are
the ranks of a process group (``None`` is the world).  The rest of the step
(microbatching, remat, AdamW) comes with the train slice; ``TrainOptions``
holds only the fields used so far.
"""

from __future__ import annotations

import dataclasses

from repro_torch.core import collectives
from repro_torch.optim import compression
from repro_torch.tree import tree_map

# pod_sync -> the grad_sync method that carries it
POD_SYNC_METHODS = {"hoplite_chain": "chain", "hoplite_2d": "chain2d", "psum": "psum"}


@dataclasses.dataclass(frozen=True)
class TrainOptions:
    pod_sync: str = "hoplite_chain"  # gspmd | hoplite_chain | hoplite_2d | psum
    pod_compression: bool = False  # int8 quantize-dequantize before the pod sync


def _pod_sync_fn(options: TrainOptions, group=None):
    """The cross-pod sync of a gradient tree: the mean over the group's ranks
    by the method ``options.pod_sync`` names, after a stateless int8
    compress-decompress of every leaf when ``options.pod_compression`` is set
    (error feedback residuals are the train step's to carry)."""
    if options.pod_sync not in POD_SYNC_METHODS:
        raise ValueError(f"pod_sync {options.pod_sync!r} has no Hoplite sync (one of {sorted(POD_SYNC_METHODS)}); "
                         "'gspmd' leaves the pod axis to the train step")
    method = POD_SYNC_METHODS[options.pod_sync]
    config = collectives.HOST_STAGED_CONFIG

    def sync(grads):
        if options.pod_compression:
            grads = tree_map(compression.compress_decompress, grads)
        return collectives.grad_sync(grads, group, method=method, config=config)

    return sync
