"""Carry a parameter tree of the JAX package over to the port.

``jax.random`` streams cannot be reproduced in PyTorch, so the tests draw
weights once in the JAX package and hand the same numbers to both packages:
the leaves of ``repro.models.common.init_params(T.model_skel(cfg), key)``
passed through ``np.asarray``.  Trees with no model skeleton (gradients,
error-feedback residuals) cross with ``tree_from_numpy``; a train state
(parameters, AdamW moments, counts) with ``state_from_jax``.
"""

from __future__ import annotations

import numpy as np
import torch

from repro_torch.device import resolve_device
from repro_torch.models import transformer as T
from repro_torch.models.common import is_param
from repro_torch.tree import tree_map


def _tensor(a, dev, want) -> torch.Tensor:
    """A numpy array (bfloat16 from ml_dtypes included) as a tensor of its
    own, exactly: never a view of the array, which the train step's in-place
    updates would write through."""
    a = np.asarray(a)
    if a.dtype.name == "bfloat16":  # ml_dtypes: exact through f32
        t = torch.from_numpy(a.astype(np.float32)).to(torch.bfloat16)
    else:
        t = torch.from_numpy(np.array(a))
    return t.to(device=dev, dtype=want or t.dtype)


def tree_from_numpy(tree, device=None, dtype=None):
    """A tree (dicts, lists) of numpy arrays as tensors on ``device`` (the card
    unless ``"cpu"`` is asked for); each leaf keeps its type unless ``dtype``."""
    dev = resolve_device(device)
    want = getattr(torch, dtype) if isinstance(dtype, str) else dtype
    return tree_map(lambda a: _tensor(a, dev, want), tree)


def params_from_jax(tree, cfg, device=None, dtype=None):
    """The port's parameters for ``cfg`` from a tree of numpy arrays.

    The tree must have the names and shapes of ``T.model_skel(cfg)`` (stacked
    "layers" axes included); anything else raises ``ValueError``.  Each leaf
    keeps its own type (bfloat16 stays bfloat16) unless ``dtype`` is given.
    """
    dev = resolve_device(device)
    want = getattr(torch, dtype) if isinstance(dtype, str) else dtype

    def leaf(p, a, path):
        a = np.asarray(a)
        if tuple(a.shape) != tuple(p.shape):
            raise ValueError(f"{path}: shape {a.shape}, the port expects {p.shape}")
        return _tensor(a, dev, want)

    def walk(skel, node, path):
        if is_param(skel):
            return leaf(skel, node, path)
        if isinstance(skel, dict):
            if not isinstance(node, dict) or set(node) != set(skel):
                got = sorted(node) if isinstance(node, dict) else type(node).__name__
                raise ValueError(f"{path or 'params'}: keys {got}, the port expects {sorted(skel)}")
            return {k: walk(skel[k], node[k], f"{path}/{k}") for k in skel}
        if not isinstance(node, (list, tuple)) or len(node) != len(skel):
            raise ValueError(f"{path}: expected a list of {len(skel)} stages")
        return [walk(s, n, f"{path}[{i}]") for i, (s, n) in enumerate(zip(skel, node))]

    return walk(T.model_skel(cfg), tree, "")


def state_from_jax(tree, cfg, device=None):
    """The port's train state from a JAX one as numpy:
    ``{"params", "opt": {"m", "v", "count"}, "step"}``, as
    ``repro.train.step.init_state`` lays it out.  Parameters and moments must
    have the names and shapes of the model skeleton; every leaf keeps its
    type (moments f32, counts int32)."""
    dev = resolve_device(device)
    opt = tree["opt"]
    count = lambda a: torch.tensor(np.asarray(a).item(), dtype=torch.int32, device=dev)
    return {
        "params": params_from_jax(tree["params"], cfg, dev),
        "opt": {"m": params_from_jax(opt["m"], cfg, dev), "v": params_from_jax(opt["v"], cfg, dev),
                "count": count(opt["count"])},
        "step": count(tree["step"]),
    }
