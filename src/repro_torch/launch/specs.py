"""Stand-ins for every model input (port of ``repro.launch.specs``): tensors
on the ``meta`` device with the shapes and dtypes of the JAX package's
``ShapeDtypeStruct``s, nothing allocated.  For [vlm]/[audio] archs the
modality frontend is a stub: the specs provide the position streams of
M-RoPE and whisper's encoder frames.

    PYTHONPATH=src python -m repro_torch.launch.specs

prints each config's train-state bytes per device on both production
meshes, computed from the placements (``state_bytes_per_rank``)."""

from __future__ import annotations

import math
from typing import Any, Dict

import torch

from repro_torch.configs import ARCHS
from repro_torch.configs.base import ModelConfig, ShapeSpec
from repro_torch.launch.mesh import production_mesh_shape
from repro_torch.models import transformer as T
from repro_torch.models.common import abstract_params, param_elems
from repro_torch.sharding.partitioning import local_slices
from repro_torch.train import step as train_step_mod
from repro_torch.tree import leaves


def _meta(shape, dtype) -> torch.Tensor:
    return torch.empty(shape, dtype=dtype, device="meta")


def train_batch_specs(cfg: ModelConfig, shape: ShapeSpec) -> Dict[str, Any]:
    B, S = shape.global_batch, shape.seq_len
    out = {"tokens": _meta((B, S), torch.int32), "labels": _meta((B, S), torch.int32)}
    if cfg.rope == "mrope":
        out["positions_3d"] = _meta((3, B, S), torch.int32)
    if cfg.is_encoder_decoder:
        out["encoder_frames"] = _meta((B, cfg.encoder_seq, cfg.d_model), torch.float32)
    return out


def _params(cfg: ModelConfig):
    """The parameters as the JAX package's ``abstract_state`` gives them: in
    their skeleton's dtype (the port's own ``abstract_state`` gives
    ``cfg.param_dtype``)."""
    return abstract_params(T.model_skel(cfg))


def prefill_inputs(cfg: ModelConfig, shape: ShapeSpec):
    """(abstract_params, abstract_batch) for the prefill path."""
    batch = train_batch_specs(cfg, shape)
    batch.pop("labels")
    return _params(cfg), batch


def decode_inputs(cfg: ModelConfig, shape: ShapeSpec):
    """(params, token, t, caches) abstract inputs for a decode step."""
    B = shape.global_batch
    return _params(cfg), _meta((B, 1), torch.int32), _meta((), torch.int32), T.cache_skel(cfg, B, shape.seq_len)


def train_inputs(cfg: ModelConfig, shape: ShapeSpec):
    """(abstract state, abstract batch), the state's parameters in their
    skeleton's dtype as the JAX package's ``abstract_state`` gives them."""
    state = train_step_mod.abstract_state(cfg)
    state["params"] = _params(cfg)
    return state, train_batch_specs(cfg, shape)


def state_bytes_per_rank(cfg: ModelConfig, mesh) -> int:
    """One device's bytes of the train state on ``mesh``, from
    ``train.step.state_shardings``' placements, no device touched: the
    device at coordinate 0 (every split divides, so each holds as much)."""
    state, _ = train_inputs(cfg, ShapeSpec("state", 1, 1, "train"))
    total = 0
    for t, pl in _with_placements(state, train_step_mod.state_shardings(cfg, mesh)):
        block = local_slices(tuple(t.shape), pl, mesh, [0] * len(mesh.shape))
        total += math.prod(s.stop - s.start for s in block) * t.element_size()
    return total


def _with_placements(tree, places):
    """(leaf, its placements) over a tree and its tree of placements (whose
    leaves are tuples)."""
    if isinstance(tree, dict):
        for k in tree:
            yield from _with_placements(tree[k], places[k])
    elif isinstance(tree, list):
        for t, p in zip(tree, places):
            yield from _with_placements(t, p)
    else:
        yield tree, places


def main() -> None:
    """Print each config's train-state bytes, whole and per device on both
    production meshes (``python -m repro_torch.launch.specs``)."""
    meshes = [production_mesh_shape(multi_pod=False), production_mesh_shape(multi_pod=True)]
    print("| config | parameters | train state | " + " | ".join(
        "per device, " + " x ".join(map(str, m.shape)) for m in meshes) + " |")
    print("|---|---|---|" + "---|" * len(meshes))
    for name, cfg in ARCHS.items():
        state, _ = train_inputs(cfg, ShapeSpec("state", 1, 1, "train"))
        whole = sum(t.numel() * t.element_size() for t in leaves(state))
        per = [state_bytes_per_rank(cfg, m) for m in meshes]
        print(f"| {name} | {param_elems(T.model_skel(cfg)) / 1e9:.3f} B | {whole / 1e9:.2f} GB | "
              + " | ".join(f"{b / 1e9:.3f} GB" for b in per) + " |")


if __name__ == "__main__":
    main()
