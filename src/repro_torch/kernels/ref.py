"""Plain PyTorch versions of the port's kernels.

Each function is the numerical contract its CUDA kernel is held to, the
counterpart of ``repro.kernels.ref``.  ``ops`` sends CPU tensors here; on
the card they serve as the reference the kernels are compared against.
"""

from __future__ import annotations

import math

import torch


def flash_attention_ref(
    q: torch.Tensor,  # (B, H, Sq, D)   (q heads already expanded)
    k: torch.Tensor,  # (B, Kh, Skv, D)
    v: torch.Tensor,  # (B, Kh, Skv, D)
    causal: bool = True,
    window: int = 0,
    q_offset: int = 0,
) -> torch.Tensor:
    """Plain softmax attention with GQA head-group mapping.

    q head h attends kv head h // (H // Kh).  Positions: query i sits at
    global position q_offset + i; kv j at position j.  Rows with no visible
    key come out as zeros.
    """
    B, H, Sq, D = q.shape
    Kh, Skv = k.shape[1], k.shape[2]
    G = H // Kh
    kf = k.repeat_interleave(G, dim=1).float()
    vf = v.repeat_interleave(G, dim=1).float()
    s = torch.einsum("bhqd,bhsd->bhqs", q.float(), kf) / math.sqrt(D)
    qpos = q_offset + torch.arange(Sq, device=q.device)
    kpos = torch.arange(Skv, device=q.device)
    mask = torch.ones((Sq, Skv), dtype=torch.bool, device=q.device)
    if causal:
        mask &= kpos[None, :] <= qpos[:, None]
    if window:
        mask &= (qpos[:, None] - kpos[None, :]) < window
    s = torch.where(mask[None, None], s, torch.full_like(s, -1e30))
    p = torch.softmax(s, dim=-1)
    out = torch.einsum("bhqs,bhsd->bhqd", p, vf)
    # fully-masked rows (window start-up) produce uniform p; zero them
    out = torch.where(mask.any(dim=-1)[None, None, :, None], out, torch.zeros_like(out))
    return out.to(q.dtype)


def chunk_reduce_ref(dst: torch.Tensor, src: torch.Tensor, alpha: float = 1.0) -> torch.Tensor:
    """Hoplite chain-hop accumulate: ``dst + alpha * src`` in f32, out in dst's type."""
    return (dst.float() + alpha * src.float()).to(dst.dtype)


def dequant_add_ref(dst: torch.Tensor, q: torch.Tensor, scale: torch.Tensor, block: int) -> torch.Tensor:
    """Accumulate an int8 block-quantized payload: ``dst + dequant(q, scale)``.

    q: int8, flat, padded to a multiple of ``block``; scale: one f32 scale per
    block.  The layout of ``optim.compression.quantize_int8``.
    """
    deq = q.float().reshape(-1, block) * scale[:, None]
    deq = deq.reshape(-1)[: dst.numel()].reshape(dst.shape)
    return (dst.float() + deq).to(dst.dtype)


def rmsnorm_ref(x: torch.Tensor, w: torch.Tensor, eps: float = 1e-6) -> torch.Tensor:
    """``x * rsqrt(mean(x^2) + eps) * (1 + w)`` per row, f32 math, out in x.dtype."""
    x32 = x.float()
    var = torch.mean(x32 * x32, dim=-1, keepdim=True)
    return (x32 * torch.rsqrt(var + eps) * (1.0 + w.float())).to(x.dtype)
