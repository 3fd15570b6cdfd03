"""The train step: remat, microbatch accumulation, the cross-pod gradient
sync and AdamW (port of ``repro.train.step``).

The JAX step runs under ``pjit`` over a (data, model) mesh and reduces
gradients within a pod through GSPMD and across pods through the Hoplite
chains over the "pod" axis.  The port's step runs on one device; the pods,
when there are several, are the ranks of a process group (``pod``), each of
which holds a replica of the state and its share of the global batch
(``launch.train`` takes that share from ``partitioning.batch_specs``).
``state_shardings`` gives the state's DTensor placements on a mesh; no
partitioner within a pod runs them yet.

The step owns its state: it updates the parameters and the AdamW moments in
place (``optim.adamw``), where the JAX step donates them to XLA.  A state of
full-width qwen3-14b's 4 layers would not fit the card twice.
"""

from __future__ import annotations

import dataclasses
import functools
import time
from typing import Any, Callable, Dict, List

import torch
import torch.distributed as dist
from torch.utils.checkpoint import CheckpointPolicy, checkpoint, create_selective_checkpoint_contexts

from repro_torch.configs.base import ModelConfig
from repro_torch.core import collectives
from repro_torch.core import group as G
from repro_torch.device import resolve_device
from repro_torch.models import transformer as T
from repro_torch.models.common import init_params, tree_map_params
from repro_torch.optim import adamw, compression
from repro_torch.optim.adamw import AdamWConfig
from repro_torch.sharding import partitioning
from repro_torch.sharding.partitioning import ShardingOptions
from repro_torch.tree import leaves, tree_map, unflatten_like

# pod_sync -> the grad_sync method that carries it
POD_SYNC_METHODS = {"hoplite_chain": "chain", "hoplite_2d": "chain2d", "psum": "psum"}
REMAT_MODES = ("none", "full", "dots")


@dataclasses.dataclass(frozen=True)
class TrainOptions:
    num_microbatches: int = 1
    remat: str = "full"  # none | full | dots
    pod_sync: str = "hoplite_chain"  # gspmd | hoplite_chain | hoplite_2d | psum
    pod_compression: bool = False  # int8 quantize-dequantize before the pod sync
    adamw: AdamWConfig = AdamWConfig()
    sharding: ShardingOptions = ShardingOptions()


# The matrix products whose outputs "dots" keeps, as jax.checkpoint_policies.checkpoint_dots
# keeps every dot_general's: what torch.matmul and einsum dispatch to.
_DOTS = frozenset({torch.ops.aten.mm.default, torch.ops.aten.bmm.default, torch.ops.aten.addmm.default,
                   torch.ops.aten.baddbmm.default})


def _save_dots(ctx, op, *args, **kwargs):
    return CheckpointPolicy.MUST_SAVE if op in _DOTS else CheckpointPolicy.PREFER_RECOMPUTE


def _remat_wrap(fn: Callable, mode: str) -> Callable:
    """``fn`` rematerialised in the backward: ``full`` keeps only its inputs
    (``jax.checkpoint``), ``dots`` also the outputs of its matrix products
    (``checkpoint_dots``), ``none`` keeps everything."""
    if mode == "none":
        return fn
    if mode == "full":
        return lambda *a: checkpoint(fn, *a, use_reentrant=False)
    if mode == "dots":
        ctx = functools.partial(create_selective_checkpoint_contexts, _save_dots)
        return lambda *a: checkpoint(fn, *a, use_reentrant=False, context_fn=ctx)
    raise ValueError(f"remat {mode!r}: one of {REMAT_MODES}")


def _loss_with_remat(cfg: ModelConfig, options: TrainOptions) -> Callable:
    """``train_loss`` with each layer block rematerialised as ``options.remat`` says."""
    if options.remat not in REMAT_MODES:
        raise ValueError(f"remat {options.remat!r}: one of {REMAT_MODES}")
    wrap = None if options.remat == "none" else functools.partial(_remat_wrap, mode=options.remat)
    return lambda params, batch: T.train_loss(cfg, params, batch, wrap)


def _split_micro(batch: Dict[str, torch.Tensor], n: int) -> List[Dict[str, torch.Tensor]]:
    """The global batch as n microbatches of consecutive rows (dim 1 of
    ``positions_3d``, dim 0 of the rest)."""
    dim = lambda name: 1 if name == "positions_3d" else 0
    for name, x in batch.items():
        if x.shape[dim(name)] % n:
            raise ValueError(f"{name}: a batch of {x.shape[dim(name)]} rows does not split into {n} microbatches")
    parts = {name: torch.chunk(x, n, dim=dim(name)) for name, x in batch.items()}
    return [{name: p[i] for name, p in parts.items()} for i in range(n)]


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


def make_train_step(cfg: ModelConfig, options: TrainOptions = TrainOptions(), pod=None):
    """Build ``train_step(state, batch) -> (state, metrics)``.

    state = {"params": ..., "opt": {"m", "v", "count"}, "step": int32}; the
    step updates the parameters and moments in place and returns the state
    with its new count and step.  metrics = {"loss", "grad_norm", "lr"}, f32
    scalars on the state's device.  ``pod`` is the process group of the pod
    axis (``None``: one pod): with more than one rank, each rank passes its
    share of the global batch, the gradients are synced by ``_pod_sync_fn``
    and the loss is averaged over the ranks.  The step then appends the wall
    time of each sync, from a synchronised device to the synced tree, in
    seconds, to its attribute ``sync_seconds``.
    """
    loss_fn = _loss_with_remat(cfg, options)
    n_pods = 1 if pod is None else dist.get_world_size(pod)
    if n_pods > 1 and options.pod_sync not in POD_SYNC_METHODS:
        raise ValueError(f"pod_sync {options.pod_sync!r} with {n_pods} pods: the port has no partitioner "
                         f"to reduce over them; one of {sorted(POD_SYNC_METHODS)}")
    sync = _pod_sync_fn(options, pod) if n_pods > 1 else None

    def grads_of(params, batch):
        n = options.num_microbatches
        ps = tree_map(lambda p: p.detach().requires_grad_(), params)  # the same storage
        flat = list(leaves(ps))
        if n == 1:
            loss = loss_fn(ps, batch)
            grads = torch.autograd.grad(loss, flat, allow_unused=True)  # None: a leaf the loss does not use
            return loss.detach(), unflatten_like(params, [
                torch.zeros_like(p) if g is None else g for p, g in zip(flat, grads)])

        # The embedding gather runs once, outside the microbatch loop, and its
        # table gradient is folded back after it, as the JAX step does.  The
        # f32 sums keep its order, (0 + g_1) + ... + g_n, then the table's,
        # then / n, and are made in place: a copy of them would not fit the
        # card beside the state.
        if "lm_head" not in params and cfg.tie_embeddings:
            raise NotImplementedError("microbatches with tied embeddings: the JAX step does not run them either")
        tokens = batch["tokens"]
        table = params["embed"]
        x_emb = table[tokens]
        micro = _split_micro(dict({k: v for k, v in batch.items() if k != "tokens"}, x_embed=x_emb), n)
        gacc = [torch.zeros(p.shape, dtype=torch.float32, device=p.device) for p in flat]
        loss_sum = torch.zeros((), dtype=torch.float32, device=table.device)
        gxs = []
        for mb in micro:
            xe = mb["x_embed"].detach().requires_grad_()
            loss = loss_fn(ps, dict(mb, x_embed=xe))
            *gp, gx = torch.autograd.grad(loss, flat + [xe], allow_unused=True)
            for a, g in zip(gacc, gp):
                if g is not None:
                    a.add_(g)  # in f32: a + g.float()
            loss_sum = loss_sum + loss.detach()
            gxs.append(gx)
            del loss, gp, gx
        gsum = unflatten_like(params, gacc)
        d_table = torch.zeros_like(table).index_put_(
            (tokens.reshape(-1),), torch.cat(gxs).reshape(-1, table.shape[-1]).to(table.dtype), accumulate=True)
        gsum["embed"].add_(d_table)
        inv = 1.0 / n
        for g in gacc:
            g.mul_(inv)
        return loss_sum * inv, gsum

    def synced(grads, loss):
        dev = loss.device
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)
        t = time.perf_counter()
        grads = sync(grads)
        loss = G.psum(loss, pod) / n_pods
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)
        train_step.sync_seconds.append(time.perf_counter() - t)
        return grads, loss

    def train_step(state, batch):
        loss, grads = grads_of(state["params"], batch)
        if sync is not None:
            grads, loss = synced(grads, loss)
        params, opt, metrics = adamw.adamw_update(grads, state["opt"], state["params"], options.adamw)
        return {"params": params, "opt": opt, "step": state["step"] + 1}, dict(metrics, loss=loss)

    train_step.sync_seconds = []
    return train_step


def state_shardings(cfg: ModelConfig, mesh, options: TrainOptions = TrainOptions()):
    """The state's tree of DTensor placements on ``mesh``: the parameters
    and both AdamW moments as ``partitioning.param_specs`` places the
    parameters, the count and the step replicated."""
    pl = partitioning.param_placements(cfg, T.model_skel(cfg), mesh, options.sharding)
    replicated = partitioning.placements(partitioning.P(), mesh)
    return {"params": pl, "opt": {"m": pl, "v": pl, "count": replicated}, "step": replicated}


def abstract_state(cfg: ModelConfig):
    """The shapes and types of the state ``init_state`` draws, as tensors on
    the ``meta`` device: parameters of ``cfg.param_dtype``, f32 moments,
    int32 counts.  (The JAX package's ``abstract_state`` gives the
    parameters their skeleton's type, bfloat16, whatever ``param_dtype``
    says; its launcher's restore reads only the names.)"""
    meta = lambda shape, dtype: torch.empty(shape, dtype=dtype, device="meta")
    params = tree_map_params(lambda p: meta(p.shape, getattr(torch, cfg.param_dtype)), T.model_skel(cfg))
    f32 = lambda t: meta(t.shape, torch.float32)
    return {"params": params,
            "opt": {"m": tree_map(f32, params), "v": tree_map(f32, params), "count": meta((), torch.int32)},
            "step": meta((), torch.int32)}


def init_state(cfg: ModelConfig, seed: int = 0, device=None) -> Dict[str, Any]:
    """Parameters of ``cfg.param_dtype`` drawn on ``device`` (the card unless
    ``"cpu"`` is asked for) from ``seed``, zero moments, step 0.  The draws
    are torch's, not ``jax.random``'s (``convert.state_from_jax`` carries a
    JAX state across)."""
    dev = resolve_device(device)
    gen = torch.Generator(device=dev).manual_seed(seed)
    params = init_params(T.model_skel(cfg), gen, dev, dtype_override=cfg.param_dtype)
    return {"params": params, "opt": adamw.init_opt_state(params),
            "step": torch.zeros((), dtype=torch.int32, device=dev)}

