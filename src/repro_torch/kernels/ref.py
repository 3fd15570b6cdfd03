"""Plain PyTorch versions of the port's kernels, and the backward passes.

Each forward function is the numerical contract its CUDA kernel is held to,
the counterpart of ``repro.kernels.ref``.  ``ops`` sends CPU tensors here; on
the card they serve as the reference the kernels are compared against.

The backward passes (``flash_attention_bwd``, ``rmsnorm_bwd``) have no
kernel, in either package: ``ops``' autograd functions run them on both
devices.
"""

from __future__ import annotations

import math
from typing import Tuple

import torch

NEG_INF = -1e30


def flash_attention_ref(
    q: torch.Tensor,  # (B, H, Sq, D)   (q heads already expanded)
    k: torch.Tensor,  # (B, Kh, Skv, D)
    v: torch.Tensor,  # (B, Kh, Skv, D)
    causal: bool = True,
    window: int = 0,
    q_offset: int = 0,
    return_lse: bool = False,
):
    """Plain softmax attention with GQA head-group mapping.

    q head h attends kv head h // (H // Kh).  Positions: query i sits at
    global position q_offset + i; kv j at position j.  Rows with no visible
    key come out as zeros.  With ``return_lse`` the result is ``(out, lse)``:
    each row's log-sum-exp of the scaled scores, f32 (B, H, Sq), ``+inf``
    where no key is visible (the kernels' contract).

    As the JAX model's ``flash_ref`` and the tensor-core kernel do, the
    unnormalised p = exp(s - rowmax) is rounded to v's type before the PV
    product (a no-op in f32), which accumulates in f32; the row sum l and the
    division by it stay in f32.
    """
    B, H, Sq, D = q.shape
    Kh, Skv = k.shape[1], k.shape[2]
    G = H // Kh
    kf = k.repeat_interleave(G, dim=1).float()
    vf = v.repeat_interleave(G, dim=1).float()
    s = torch.einsum("bhqd,bhsd->bhqs", q.float(), kf) / math.sqrt(D)
    mask = _mask(q_offset, 0, Sq, 0, Skv, causal, window, q.device)
    s = torch.where(mask[None, None], s, torch.full_like(s, NEG_INF))
    m = s.amax(dim=-1, keepdim=True) if Skv else torch.full((B, H, Sq, 1), NEG_INF, device=q.device)
    p = torch.exp(s - m)
    l = p.sum(dim=-1, keepdim=True)
    out = torch.einsum("bhqs,bhsd->bhqd", p.to(v.dtype).float(), vf) / l
    # fully-masked rows (window start-up) produce uniform p; zero them
    seen = mask.any(dim=-1)
    out = torch.where(seen[None, None, :, None], out, torch.zeros_like(out)).to(q.dtype)
    if not return_lse:
        return out
    lse = torch.where(seen[None, None], (m + torch.log(l))[..., 0], math.inf)
    return out, lse


def _mask(q_offset: int, i0: int, i1: int, j0: int, j1: int, causal: bool, window: int, device):
    """Which keys j0..j1-1 the queries i0..i1-1 see: query i sits at position
    q_offset + i, key j at j."""
    qpos = q_offset + torch.arange(i0, i1, device=device)
    kpos = torch.arange(j0, j1, device=device)
    mask = torch.ones((i1 - i0, j1 - j0), dtype=torch.bool, device=device)
    if causal:
        mask &= kpos[None, :] <= qpos[:, None]
    if window:
        mask &= (qpos[:, None] - kpos[None, :]) < window
    return mask


def _block_sizes(sq: int, skv: int) -> Tuple[int, int]:
    """The JAX package's blocks (``repro.models.attention._block_sizes``)."""
    qb = min(sq, 2048)
    while sq % qb:
        qb //= 2
    kb = min(skv, 1024)
    while skv % kb:
        kb //= 2
    return max(qb, 1), max(kb, 1)


def flash_attention_bwd(q, k, v, out, lse, dout, causal: bool = True, window: int = 0,
                        q_offset: int = 0):
    """Gradients (dq, dk, dv) of ``flash_attention_ref`` from the forward's
    ``out`` and ``lse``: a port of ``_flash_bwd`` (repro/models/attention.py)
    in the kernel's (B, H, S, D) layout, q head h on kv head h // (H // Kh).

    Blockwise over ``_block_sizes``: each (q, kv) block pair recomputes
    ``p = exp(s - lse)``; ``delta = rowsum(dout * out)``; ``dv = p^T dout``,
    ``ds = p * (dout v^T - delta) * scale``, ``dq = ds k``, ``dk = ds^T q``,
    with dk and dv summed over each kv head's G query heads inside the
    product.  As JAX's ``preferred_element_type=f32``, every product takes
    its operands in their own type (p and ds rounded to it first, as JAX
    rounds them) and multiplies and accumulates in f32: bf16 operands are
    upcast, which is exact, and the f32 product must not use TF32.  Block
    pairs that the masks hide entirely are skipped: they add exact zeros.
    """
    B, H, Sq, D = q.shape
    Kh, Skv = k.shape[1], k.shape[2]
    G = H // Kh
    qb, kb = _block_sizes(Sq, Skv)
    scale = 1.0 / math.sqrt(D)
    q5 = q.reshape(B, Kh, G, Sq, D)
    do5 = dout.reshape(B, Kh, G, Sq, D)
    lse5 = lse.reshape(B, Kh, G, Sq)
    delta = (dout.float() * out.float()).sum(-1).reshape(B, Kh, G, Sq)
    dq = torch.empty((B, Kh, G, Sq, D), dtype=torch.float32, device=q.device)
    dk = torch.zeros((B, Kh, Skv, D), dtype=torch.float32, device=q.device)
    dv = torch.zeros((B, Kh, Skv, D), dtype=torch.float32, device=q.device)
    for i0 in range(0, Sq, qb):
        i1 = i0 + qb
        qblk, doblk = q5[..., i0:i1, :].float(), do5[..., i0:i1, :].float()
        lse_b, del_b = lse5[..., i0:i1, None], delta[..., i0:i1, None]
        dq_acc = torch.zeros((B, Kh, G, qb, D), dtype=torch.float32, device=q.device)
        for j0 in range(0, Skv, kb):
            j1 = j0 + kb
            if causal and j0 > q_offset + i1 - 1 or window and q_offset + i0 - (j1 - 1) >= window:
                continue  # no query of the block sees a key of it
            kblk, vblk = k[:, :, j0:j1].float(), v[:, :, j0:j1].float()
            s = torch.einsum("bkgqd,bksd->bkgqs", qblk, kblk) * scale
            mask = _mask(q_offset, i0, i1, j0, j1, causal, window, q.device)
            p = torch.exp(torch.where(mask, s, NEG_INF) - lse_b)
            dp = torch.einsum("bkgqd,bksd->bkgqs", doblk, vblk)
            ds = p * (dp - del_b) * scale
            dv[:, :, j0:j1] += torch.einsum("bkgqs,bkgqd->bksd", p.to(dout.dtype).float(), doblk)
            dk[:, :, j0:j1] += torch.einsum("bkgqs,bkgqd->bksd", ds.to(q.dtype).float(), qblk)
            dq_acc += torch.einsum("bkgqs,bksd->bkgqd", ds.to(k.dtype).float(), kblk)
        dq[..., i0:i1, :] = dq_acc
    return dq.reshape(B, H, Sq, D).to(q.dtype), dk.to(k.dtype), dv.to(v.dtype)


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


def rmsnorm_bwd(x: torch.Tensor, w: torch.Tensor, dy: torch.Tensor, eps: float = 1e-6):
    """(dx, dw) of ``rmsnorm_ref`` in f32, each out in its input's type: what
    ``jax.grad`` of ``repro.models.common.rmsnorm`` gives.  With r =
    rsqrt(mean(x^2) + eps) and g = dy * (1 + w): dx = r * g - x * r^3 *
    mean(g * x) per row, and dw is dy * x * r summed over the rows."""
    x32, dy32 = x.float(), dy.float()
    r = torch.rsqrt(torch.mean(x32 * x32, dim=-1, keepdim=True) + eps)
    g = dy32 * (1.0 + w.float())
    dx = r * g - x32 * (r * r * r) * torch.mean(g * x32, dim=-1, keepdim=True)
    dw = (dy32 * (x32 * r)).reshape(-1, x.shape[-1]).sum(0)
    return dx.to(x.dtype), dw.to(w.dtype)
