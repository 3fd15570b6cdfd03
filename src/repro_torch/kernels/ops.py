"""Public kernel entry points of the port.

Dispatch goes by where the tensor lies: a CPU tensor takes the plain
PyTorch version in ``ref``; a CUDA tensor launches the hand-written kernel,
or the call raises.  There is no fallback from one to the other.

``flash_attention`` and ``rmsnorm`` are differentiable.  When autograd needs
their gradients they run as ``torch.autograd.Function``s: the forward is the
kernel (the plain version on the CPU), and the backward is plain PyTorch on
either device, as the JAX package's are no Pallas kernels
(``repro/kernels/ops.py``, ``repro/models/attention._flash_bwd``): the flash
backward recomputes the softmax from the log-sum-exp that the forward kernel
wrote (``ref.flash_attention_bwd``), RMSNorm's is the f32 gradient of its
formula (``ref.rmsnorm_bwd``).  Without gradients they call the kernel
alone, and flash writes no log-sum-exp.
"""

from __future__ import annotations

from typing import Dict, Optional

import torch

from repro_torch.kernels import chunk_reduce as _cr
from repro_torch.kernels import flash_attention as _fa
from repro_torch.kernels import ref as _ref
from repro_torch.kernels import rmsnorm as _rn


def _needs_grad(*ts: torch.Tensor) -> bool:
    return torch.is_grad_enabled() and any(t.requires_grad for t in ts)


def _flash_fwd(q, k, v, causal, window, q_offset, return_lse):
    if q.device.type == "cpu":
        return _ref.flash_attention_ref(q, k, v, causal, window, q_offset, return_lse=return_lse)
    return _fa.flash_attention_fwd(q, k, v, causal=causal, window=window, q_offset=q_offset,
                                   return_lse=return_lse)


class _FlashAttention(torch.autograd.Function):
    """The forward kernel with its log-sum-exp; ``ref.flash_attention_bwd`` back."""

    @staticmethod
    def forward(ctx, q, k, v, causal, window, q_offset):
        out, lse = _flash_fwd(q, k, v, causal, window, q_offset, True)
        ctx.save_for_backward(q, k, v, out, lse)
        ctx.masks = (causal, window, q_offset)
        return out

    @staticmethod
    def backward(ctx, dout):
        q, k, v, out, lse = ctx.saved_tensors
        dq, dk, dv = _ref.flash_attention_bwd(q, k, v, out, lse, dout.contiguous(), *ctx.masks)
        return dq, dk, dv, None, None, None


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    causal: bool = True, window: int = 0, q_offset: int = 0) -> torch.Tensor:
    """(B,H,Sq,D) x (B,Kh,Skv,D)^2 -> (B,H,Sq,D); GQA via H//Kh groups.  On the
    card the kernel follows ``flash_attention.route(dtype, D)``: bf16 with D
    a multiple of 16 up to 128 on the tensor cores, the rest on the CUDA cores."""
    if _needs_grad(q, k, v):
        return _FlashAttention.apply(q, k, v, causal, window, q_offset)
    return _flash_fwd(q, k, v, causal, window, q_offset, False)


def _rmsnorm_fwd(x, w, eps):
    return _ref.rmsnorm_ref(x, w, eps) if x.device.type == "cpu" else _rn.rmsnorm(x, w, eps)


class _RMSNorm(torch.autograd.Function):
    """The forward kernel; ``ref.rmsnorm_bwd`` back."""

    @staticmethod
    def forward(ctx, x, w, eps):
        ctx.save_for_backward(x, w)
        ctx.eps = eps
        return _rmsnorm_fwd(x, w, eps)

    @staticmethod
    def backward(ctx, dy):
        x, w = ctx.saved_tensors
        dx, dw = _ref.rmsnorm_bwd(x, w, dy, ctx.eps)
        return dx, dw, None


def rmsnorm(x: torch.Tensor, w: torch.Tensor, eps: float = 1e-6) -> torch.Tensor:
    if _needs_grad(x, w):
        return _RMSNorm.apply(x, w, eps)
    return _rmsnorm_fwd(x, w, eps)


def chunk_reduce(dst: torch.Tensor, src: torch.Tensor, alpha: float = 1.0,
                 out: Optional[torch.Tensor] = None) -> torch.Tensor:
    """``dst + alpha * src`` (f32 math, dst's type), into ``out`` when given;
    ``out`` may be ``dst``: the chain hop accumulates in place."""
    if dst.device.type == "cpu":
        res = _ref.chunk_reduce_ref(dst, src, alpha)
        return res if out is None else out.copy_(res)
    return _cr.chunk_reduce(dst, src, alpha, out=out)


def dequant_add(dst: torch.Tensor, q: torch.Tensor, scale: torch.Tensor, qblock: int = 256) -> torch.Tensor:
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
