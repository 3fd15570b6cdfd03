"""Attention: GQA with full causal attention, prefill and decode (port of
``repro.models.attention``).

Prefill runs the flash-attention kernel through ``ops.flash_attention`` in
the kernel's (B, H, S, D) layout; decode attends one query position against
a linear KV cache in plain PyTorch, as the JAX package does with plain jnp.
Sliding-window layers (ring caches) and cross-attention are later slices.
"""

from __future__ import annotations

import math
from typing import Tuple

import torch

from repro_torch.kernels import ops
from repro_torch.models.common import Param, apply_rope, dense, rmsnorm

NEG_INF = -1e30


def attn_skel(cfg):
    d, qd, kvd = cfg.d_model, cfg.q_dim, cfg.kv_dim
    s = {
        "wq": Param((d, qd), ("embed", "heads")),
        "wk": Param((d, kvd), ("embed", "kv")),
        "wv": Param((d, kvd), ("embed", "kv")),
        "wo": Param((qd, d), ("heads", "embed")),
    }
    if cfg.qk_norm:
        s["q_norm"] = Param((cfg.head_dim,), (None,), init="zeros")
        s["k_norm"] = Param((cfg.head_dim,), (None,), init="zeros")
    return s


def _check_full(spec) -> None:
    if spec.attention != "full":
        raise NotImplementedError(
            f"{spec.attention!r} attention: the port runs full causal attention only so far"
        )


def _positions_rope(cfg, p, q, k, q_pos, kv_pos):
    """Apply qk-norm then rotary embedding.  q: (B,S,K,G,D), k: (B,S,K,D)."""
    if cfg.qk_norm:
        q = rmsnorm(q, p["q_norm"])
        k = rmsnorm(k, p["k_norm"])
    if cfg.rope != "rope":
        raise NotImplementedError(f"rope {cfg.rope!r}: the port runs plain RoPE only so far")
    B, S = q.shape[:2]
    qf = apply_rope(q.reshape(B, S, -1, cfg.head_dim), q_pos[None, :], cfg.rope_theta)
    return qf.reshape(q.shape), apply_rope(k, kv_pos[None, :], cfg.rope_theta)


def attention_fwd(cfg, p, x: torch.Tensor, spec, q_pos: torch.Tensor) -> torch.Tensor:
    """Prefill self-attention (no cache).  x: (B, S, d); q_pos: (S,) positions."""
    _check_full(spec)
    B, S = x.shape[:2]
    K, H, D = cfg.num_kv_heads, cfg.num_heads, cfg.head_dim
    G = H // K
    q = dense(x, p["wq"]).reshape(B, S, K, G, D)
    k = dense(x, p["wk"]).reshape(B, S, K, D)
    v = dense(x, p["wv"]).reshape(B, S, K, D)
    q, k = _positions_rope(cfg, p, q, k, q_pos, q_pos)
    # kernel layout: head h = k*G + g, so the kernel's h // G finds kv head k
    qh = q.permute(0, 2, 3, 1, 4).reshape(B, H, S, D).contiguous()
    kh = k.permute(0, 2, 1, 3).contiguous()
    vh = v.permute(0, 2, 1, 3).contiguous()
    # q and kv share positions, so the causal mask q_pos[i] >= kv_pos[j] is
    # i >= j whatever q_pos starts at: the kernel's q_offset is 0
    out = ops.flash_attention(qh, kh, vh, causal=True, window=0, q_offset=0)
    out = out.reshape(B, K, G, S, D).permute(0, 3, 1, 2, 4).reshape(B, S, H * D)
    return dense(out, p["wo"])


def attention_prefill_kv(cfg, p, x: torch.Tensor, q_pos: torch.Tensor):
    """The K/V tensors that seed a decode cache: a (B,S,K,D) pair."""
    B, S = x.shape[:2]
    K, D = cfg.num_kv_heads, cfg.head_dim
    k = dense(x, p["wk"]).reshape(B, S, K, D)
    if cfg.qk_norm:
        k = rmsnorm(k, p["k_norm"])
    if cfg.rope != "rope":
        raise NotImplementedError(f"rope {cfg.rope!r}: the port runs plain RoPE only so far")
    k = apply_rope(k, q_pos[None, :], cfg.rope_theta)
    return k, dense(x, p["wv"]).reshape(B, S, K, D)


def decode_attend(
    q: torch.Tensor,  # (B, K, G, 1, D)
    k_cache: torch.Tensor,  # (B, C, K, D)
    v_cache: torch.Tensor,  # (B, C, K, D)
    kv_positions: torch.Tensor,  # (C,) token position per slot; < 0 invalid
    t: int,  # position of the new token
) -> torch.Tensor:
    """One-token attention over the cache, scores and softmax in f32."""
    scale = 1.0 / math.sqrt(q.shape[-1])
    s = torch.einsum("bkgqd,bskd->bkgqs", q.float(), k_cache.float()) * scale
    mask = (kv_positions >= 0) & (kv_positions <= t)
    s = torch.where(mask[None, None, None, None, :], s, torch.full_like(s, NEG_INF))
    p = torch.softmax(s, dim=-1)
    out = torch.einsum("bkgqs,bskd->bkgqd", p.to(v_cache.dtype).float(), v_cache.float())
    return out.to(q.dtype)


def attention_decode(
    cfg,
    p,
    x: torch.Tensor,  # (B, 1, d)
    spec,
    cache: Tuple[torch.Tensor, torch.Tensor],  # k, v: (B, C, K, D); slot == position
    t: int,
) -> Tuple[torch.Tensor, Tuple[torch.Tensor, torch.Tensor]]:
    """One decode step against a linear cache: returns (output, cache).

    The new token's k/v are written into slot ``t`` of the cache in place
    (JAX returns an updated copy with ``dynamic_update_slice``); a ``t`` past
    the cache raises ``IndexError`` instead of being clamped."""
    _check_full(spec)
    B = x.shape[0]
    K, H, D = cfg.num_kv_heads, cfg.num_heads, cfg.head_dim
    G = H // K
    k_cache, v_cache = cache
    C = k_cache.shape[1]
    q = dense(x, p["wq"]).reshape(B, 1, K, G, D)
    xk = dense(x, p["wk"]).reshape(B, 1, K, D)
    xv = dense(x, p["wv"]).reshape(B, 1, K, D)
    pos = torch.full((1,), t, dtype=torch.long, device=x.device)
    q, xk = _positions_rope(cfg, p, q, xk, pos, pos)
    k_cache[:, t] = xk[:, 0]
    v_cache[:, t] = xv[:, 0]
    kv_positions = torch.arange(C, device=x.device)
    out = decode_attend(q.permute(0, 2, 3, 1, 4), k_cache, v_cache, kv_positions, t)
    out = out.permute(0, 3, 1, 2, 4).reshape(B, 1, H * D)
    return dense(out, p["wo"]), (k_cache, v_cache)
