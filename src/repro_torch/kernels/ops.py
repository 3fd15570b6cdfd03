"""Public kernel entry points of the port.

Dispatch goes by where the tensor lies: a CPU tensor takes the plain
PyTorch version in ``ref``; a CUDA tensor launches the hand-written kernel,
or the call raises.  There is no fallback from one to the other.

The flash forward and the RMSNorm forward are ``torch.library`` custom ops
(``repro_torch::flash_attention_fwd``, ``repro_torch::flash_attention_fwd_lse``
and ``repro_torch::rmsnorm``), so that a trace sees each as one operation,
as the card runs it:

  * the implementation is the dispatch above, and counts the card's launches;
  * the fake implementation gives the outputs the CUDA kernel writes (``out``
    in q's type, the f32 (B, H, Sq) log-sum-exp only from the ``_lse`` op),
    so ``FakeTensorMode`` allocates nothing the kernel does not;
  * the flop formulas count what the kernels compute (for flash, Q·Kᵀ and PV
    over the (query, key) pairs the masks leave visible);
  * the DTensor sharding rules say how each op splits over a mesh: flash by
    batch, and by heads only where the q and the kv heads split together
    (q head h reads kv head h // G, which a split of the q heads alone would
    break), RMSNorm by any dim but the normalised one.

``flash_attention`` and ``rmsnorm`` are differentiable.  Their backward
passes are plain PyTorch on either device, as the JAX package's are no
Pallas kernels (``repro/kernels/ops.py``, ``repro/models/attention._flash_bwd``):
the flash backward recomputes the softmax from the log-sum-exp that the
forward kernel wrote (``ref.flash_attention_bwd``), RMSNorm's is the f32
gradient of its formula (``ref.rmsnorm_bwd``).  Without gradients flash
writes no log-sum-exp.  On a DTensor a backward runs on each device's local
blocks under the forward's placements (``sharding.regions.local_region``).
"""

from __future__ import annotations

import inspect
import math
from typing import Callable, Dict, Optional, Sequence, Tuple

import torch
from torch.distributed.tensor import DTensor, Partial, Replicate, Shard
from torch._subclasses.fake_tensor import FakeTensor
from torch.utils.flop_counter import register_flop_formula

from repro_torch.kernels import chunk_reduce as _cr
from repro_torch.kernels import flash_attention as _fa
from repro_torch.kernels import ref as _ref
from repro_torch.kernels import rmsnorm as _rn
from repro_torch.sharding.regions import local_region

Tensor = torch.Tensor


def _needs_grad(*ts: Tensor) -> bool:
    return torch.is_grad_enabled() and any(t.requires_grad for t in ts)


def _on_cpu_or_card(name: str, t: Tensor) -> None:
    """A tensor neither on the CPU nor on the card takes no kernel.  (A
    ``meta`` tensor would reach the ops' fake implementations, which serve
    ``FakeTensorMode``, whose tensors, like a DTensor, name a real device.)"""
    if t.device.type not in ("cpu", "cuda"):
        raise ValueError(f"{name} takes CPU tensors (the plain version) or CUDA tensors (the kernel), "
                         f"got {t.device}")


def _flash_fwd(q, k, v, causal, window, q_offset, return_lse):
    if q.device.type == "cpu":
        return _ref.flash_attention_ref(q, k, v, causal, window, q_offset, return_lse=return_lse)
    return _fa.flash_attention_fwd(q, k, v, causal=causal, window=window, q_offset=q_offset,
                                   return_lse=return_lse)


# ---------------------------------------------------------------------------
# flash attention
# ---------------------------------------------------------------------------


@torch.library.custom_op("repro_torch::flash_attention_fwd", mutates_args=())
def flash_attention_fwd(q: Tensor, k: Tensor, v: Tensor, causal: bool, window: int, q_offset: int) -> Tensor:
    """The flash forward kernel (the plain version on the CPU), no log-sum-exp."""
    return _flash_fwd(q, k, v, causal, window, q_offset, False).contiguous()


@torch.library.custom_op("repro_torch::flash_attention_fwd_lse", mutates_args=())
def flash_attention_fwd_lse(q: Tensor, k: Tensor, v: Tensor, causal: bool, window: int,
                            q_offset: int) -> Tuple[Tensor, Tensor]:
    """The flash forward kernel with each row's log-sum-exp, f32 (B, H, Sq)."""
    out, lse = _flash_fwd(q, k, v, causal, window, q_offset, True)
    return out.contiguous(), lse.contiguous()


@flash_attention_fwd.register_fake
def _(q, k, v, causal, window, q_offset):
    return torch.empty_like(q, memory_format=torch.contiguous_format)


@flash_attention_fwd_lse.register_fake
def _(q, k, v, causal, window, q_offset):
    B, H, Sq, _ = q.shape
    return (torch.empty_like(q, memory_format=torch.contiguous_format),
            q.new_empty((B, H, Sq), dtype=torch.float32))


def _flash_bwd_local(q, k, v, out, lse, dout, causal, window, q_offset):
    return _ref.flash_attention_bwd(q, k, v, out, lse, dout.contiguous(), causal, window, q_offset)


def _flash_setup(ctx, inputs, output):
    q, k, v, causal, window, q_offset = inputs
    out, lse = output
    ctx.save_for_backward(q, k, v, out, lse)
    ctx.masks = (causal, window, q_offset)


def _flash_backward(ctx, dout, _dlse):
    q, k, v, out, lse = ctx.saved_tensors
    if isinstance(q, DTensor):
        # each device's blocks under the forward's placements (out's: the
        # rule splits q, k, v, out and lse alike, by batch or heads), so the
        # local backward is the plain one on the local heads
        po, pl = out.placements, lse.placements
        fn = local_region(_flash_bwd_local, (po, po, po), (po, po, po, po, pl, po, None, None, None),
                          q.device_mesh)
        dq, dk, dv = fn(q, k, v, out, lse, dout, *ctx.masks)
    else:
        dq, dk, dv = _flash_bwd_local(q, k, v, out, lse, dout, *ctx.masks)
    return dq, dk, dv, None, None, None


flash_attention_fwd_lse.register_autograd(_flash_backward, setup_context=_flash_setup)


def flash_attention(q: Tensor, k: Tensor, v: Tensor, causal: bool = True, window: int = 0,
                    q_offset: int = 0) -> Tensor:
    """(B,H,Sq,D) x (B,Kh,Skv,D)^2 -> (B,H,Sq,D); GQA via H//Kh groups.  On the
    card the kernel follows ``flash_attention.route(dtype, D)``: bf16 with D
    a multiple of 16 up to 128 on the tensor cores, the rest on the CUDA cores.
    Under autograd the kernel also writes the log-sum-exp for the backward."""
    _on_cpu_or_card("flash_attention", q)
    if _needs_grad(q, k, v):
        return flash_attention_fwd_lse(q, k, v, causal, window, q_offset)[0]
    return flash_attention_fwd(q, k, v, causal, window, q_offset)


def visible_pairs(Sq: int, Skv: int, causal: bool, window: int, q_offset: int) -> int:
    """(query, key) pairs the masks leave visible, query i at position
    q_offset + i and key j at j: the work the flash kernels do."""
    total = 0
    for i in range(Sq):
        p = q_offset + i
        hi = min(Skv - 1, p) if causal else Skv - 1
        lo = max(0, p - window + 1) if window else 0
        total += max(0, hi - lo + 1)
    return total


def flash_flops(q_shape: Sequence[int], k_shape: Sequence[int], causal: bool, window: int,
                q_offset: int) -> int:
    """2·D flops for each of Q·Kᵀ and PV per visible (query, key) pair and head."""
    B, H, Sq, D = q_shape
    return 4 * B * H * D * visible_pairs(Sq, k_shape[2], causal, window, q_offset)


@register_flop_formula([torch.ops.repro_torch.flash_attention_fwd, torch.ops.repro_torch.flash_attention_fwd_lse])
def _flash_flop_formula(q_shape, k_shape, v_shape, causal, window, q_offset, *args, out_shape=None, **kwargs):
    return flash_flops(q_shape, k_shape, causal, window, q_offset)


def _heads_split_together(input_specs, output_specs) -> bool:
    """A strategy splits the q heads only where the kv heads split with them,
    by the same mesh dims, and each split divides both: then a device's local
    q head j reads its local kv head j // G, as the kernel's h // G does.  (A
    batch may split unevenly: rows are independent.)"""
    q, k = input_specs[0], input_specs[1]
    H, Kh = q.shape[1], k.shape[1]
    heads = [n for n, p in zip(q.mesh.shape, q.placements) if p == Shard(1)]
    kv_heads = [n for n, p in zip(k.mesh.shape, k.placements) if p == Shard(1)]
    return heads == kv_heads and Kh % math.prod(heads) == 0 and H % math.prod(heads) == 0


def register_rule(op, n_out: int, singles: Callable, valid: Optional[Callable] = None) -> None:
    """A DTensor rule for ``op``, as ``register_sharding`` registers one: the
    strategies of one mesh dim (``singles(*arg_specs)``, each a list of the
    outputs' then the arguments' placements), expanded over the mesh.  Two
    things beyond it: ``valid(input_specs, output_specs)`` drops mesh-wide
    strategies (a split must divide, say); and where the first argument's
    own placements are among the strategies left, only those stay.  DTensor
    picks the strategy that moves the fewest bytes, and a split of a
    replicated dim moves none, so without that a tie could split, say, a
    sequence dim that nothing downstream expects split."""
    from torch.distributed.tensor._op_schema import OpStrategy, RuntimeSchemaInfo
    from torch.distributed.tensor._ops.utils import expand_to_full_mesh_op_strategy

    # torch 2.13 refuses uneven splits here unless asked; torch 2.11 has no such check
    uneven = ({"allow_uneven_sharding": True}
              if "allow_uneven_sharding" in inspect.signature(expand_to_full_mesh_op_strategy).parameters else {})

    def strategy(op_schema):
        specs = [a.strategies[0].output_spec if isinstance(a, OpStrategy) else a for a in op_schema.args_schema]
        full = expand_to_full_mesh_op_strategy(op_schema.get_mesh_from_args(), op_schema, singles(*specs),
                                               input_index=n_out, is_valid_strategy_cb=valid, **uneven)
        own = [s for s in full.strategies if s.input_specs[0].placements == specs[0].placements]
        if own:
            full.strategies = own
        return full

    static = min([i for i, a in enumerate(op._schema.arguments) if not isinstance(a.type, torch.TensorType)] or [100])
    DTensor._op_dispatcher.sharding_propagator.register_op_strategy(
        op, strategy, RuntimeSchemaInfo(static, needs_pytree=True))


def _flash_singles(n_out: int):
    """Per mesh dim: every tensor replicated, split on batch, or split on heads."""
    return lambda *specs: [[p] * (n_out + 3) + [None] * 3 for p in (Replicate(), Shard(0), Shard(1))]


register_rule(torch.ops.repro_torch.flash_attention_fwd.default, 1, _flash_singles(1), _heads_split_together)
register_rule(torch.ops.repro_torch.flash_attention_fwd_lse.default, 2, _flash_singles(2), _heads_split_together)


# ---------------------------------------------------------------------------
# RMSNorm
# ---------------------------------------------------------------------------


def _rmsnorm_fwd(x, w, eps):
    return _ref.rmsnorm_ref(x, w, eps) if x.device.type == "cpu" else _rn.rmsnorm(x, w, eps)


@torch.library.custom_op("repro_torch::rmsnorm", mutates_args=())
def rmsnorm_fwd(x: Tensor, w: Tensor, eps: float) -> Tensor:
    """The RMSNorm kernel (the plain version on the CPU)."""
    return _rmsnorm_fwd(x, w, eps).contiguous()


@rmsnorm_fwd.register_fake
def _(x, w, eps):
    return torch.empty_like(x, memory_format=torch.contiguous_format)


def _rmsnorm_setup(ctx, inputs, output):
    x, w, eps = inputs
    ctx.save_for_backward(x, w)
    ctx.eps = eps
    ctx.places = output.placements if isinstance(output, DTensor) else None


def _rmsnorm_backward(ctx, dy):
    x, w = ctx.saved_tensors
    if isinstance(x, DTensor):
        # the forward's placements (the output's): rows split, w whole on
        # every device, so dw is each device's partial sum over its rows
        px = ctx.places
        pw = (Replicate(),) * len(px)
        pdw = tuple(Partial() if isinstance(p, Shard) else p for p in px)
        fn = local_region(_ref.rmsnorm_bwd, (px, pdw), (px, pw, px, None), x.device_mesh)
        return (*fn(x, w, dy, ctx.eps), None)
    return (*_ref.rmsnorm_bwd(x, w, dy, ctx.eps), None)


rmsnorm_fwd.register_autograd(_rmsnorm_backward, setup_context=_rmsnorm_setup)


@register_flop_formula(torch.ops.repro_torch.rmsnorm)
def _rmsnorm_flop_formula(x_shape, w_shape, eps, *args, out_shape=None, **kwargs):
    return 0  # no matrix product, as FlopCounterMode counts none for F.rms_norm


def _rmsnorm_singles(x, w, eps):
    """Per mesh dim: x split by any dim but the last, with w whole; or both whole."""
    return [[Replicate(), Replicate(), Replicate(), None]] + [
        [Shard(d), Shard(d), Replicate(), None] for d in range(x.ndim - 1)]


register_rule(torch.ops.repro_torch.rmsnorm.default, 1, _rmsnorm_singles)


def rmsnorm(x: Tensor, w: Tensor, eps: float = 1e-6) -> Tensor:
    _on_cpu_or_card("rmsnorm", x)
    return rmsnorm_fwd(x, w, eps)


# ---------------------------------------------------------------------------
# the sync's kernels: plain wrappers (the sync runs them on local shards)
# ---------------------------------------------------------------------------


def chunk_reduce(dst: Tensor, src: Tensor, alpha: float = 1.0, out: Optional[Tensor] = None) -> Tensor:
    """``dst + alpha * src`` (f32 math, dst's type), into ``out`` when given;
    ``out`` may be ``dst``: the chain hop accumulates in place.  Under
    ``FakeTensorMode`` (the dry run's trace: shapes, no storage) it returns
    what the kernel would write, as the custom ops' fake implementations do;
    a kernel given a fake tensor's address would read no memory of its own."""
    if isinstance(dst, FakeTensor):
        return torch.empty_like(dst) if out is None else out
    if dst.device.type == "cpu":
        res = _ref.chunk_reduce_ref(dst, src, alpha)
        return res if out is None else out.copy_(res)
    return _cr.chunk_reduce(dst, src, alpha, out=out)


def dequant_add(dst: Tensor, q: Tensor, scale: Tensor, qblock: int = 256) -> Tensor:
    """``dst + q * scale[block]``: an int8 block-quantized payload added to dst."""
    if dst.device.type == "cpu":
        return _ref.dequant_add_ref(dst, q, scale, qblock)
    return _cr.dequant_add(dst, q, scale, qblock)


def launch_counts() -> Dict[str, int]:
    """Kernel launches in this process since the last reset."""
    return {"rmsnorm": _rn.launches, "flash_attention_tc": _fa.launches_tc,
            "flash_attention_cores": _fa.launches_cores,
            "chunk_reduce": _cr.chunk_reduce_launches, "dequant_add": _cr.dequant_add_launches}


def reset_launch_counts() -> None:
    _rn.launches = 0
    _fa.launches_tc = 0
    _fa.launches_cores = 0
    _fa.lse_launches = 0
    _cr.chunk_reduce_launches = 0
    _cr.dequant_add_launches = 0
