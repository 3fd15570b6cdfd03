"""Attention: GQA, full causal or sliding-window, bidirectional and cross,
prefill and decode (port of ``repro.models.attention``).

Prefill runs the flash-attention kernel through ``ops.flash_attention`` in
the kernel's (B, H, S, D) layout, with the layer's window; decode attends one
query position against the KV cache in plain PyTorch, as the JAX package does
with plain jnp.  A windowed layer whose cache holds exactly its window uses
it as a ring (slot ``t % C``); any other cache is linear (slot = position).
Rotary embedding is RoPE, Qwen2-VL's M-RoPE (``positions_3d``, the three
position streams; without them every stream is the token's position) or
none (``rope="none"``, Jamba's and Whisper's attention layers: q and k as
projected).  ``causal=False`` is an encoder's bidirectional self-attention.
Cross-attention (``kv_x``, the encoder's output) takes K and V from it with
neither rotary embedding nor qk-norm and sees every frame; in decode it
reads the static cross cache that prefill wrote (``cross=True``).
"""

from __future__ import annotations

import math
from typing import Optional, Tuple

import torch
from torch.distributed.tensor import DTensor, Replicate, Shard

from repro_torch.kernels import ops
from repro_torch.models.common import Param, apply_mrope, apply_rope, dense, rmsnorm
from repro_torch.sharding.partitioning import block_start
from repro_torch.sharding.regions import local_region

NEG_INF = -1e30

# The placements of q (B, H, S, D) under which the flash kernel ran on
# DTensors, as strings, since the last ``PLACEMENTS_SEEN.clear()``: a dry run
# records them, so that an attention replicated over the model axis shows.
PLACEMENTS_SEEN: set = set()


def _heads(t: torch.Tensor, kv_heads: int, shape) -> torch.Tensor:
    """t (..., F), a projection's output whose features are heads of D, viewed
    as ``shape``.  On a DTensor the features stay split over a mesh dim only
    where the kv heads split with them: q head h reads kv head h // G, so q
    and kv split their heads together or not at all (the flash rule,
    ``ops._heads_split_together``).  A split the kv heads do not divide is
    gathered first (GSPMD would pad it)."""
    if isinstance(t, DTensor):
        last = t.ndim - 1
        split = [(i, n) for i, (n, p) in enumerate(zip(t.device_mesh.shape, t.placements)) if p == Shard(last)]
        if split and kv_heads % math.prod(n for _, n in split):
            keep = [Replicate() if p == Shard(last) else p for p in t.placements]
            t = t.redistribute(t.device_mesh, keep)
    return t.reshape(shape)


def write_rows(cache: torch.Tensor, start: int, new: torch.Tensor) -> None:
    """``cache[:, start:start + n] = new`` (dim 1, the slots), in place.  On a
    DTensor cache each device writes the part of the rows its own block
    holds, as ``dynamic_update_slice`` writes under GSPMD: ``new`` is placed as
    the cache, whole along the slots, and nothing else moves."""
    n = new.shape[1]
    if not isinstance(cache, DTensor):
        cache[:, start:start + n] = new
        return
    mesh = cache.device_mesh
    whole = [Replicate() if p == Shard(1) else p for p in cache.placements]
    local_new = new.redistribute(mesh, whole).to_local()
    local = cache.to_local()
    lo = block_start(cache.shape, cache.placements, mesh, mesh.get_coordinate(), 1)
    a, b = max(start, lo), min(start + n, lo + local.shape[1])
    if a < b:
        local[:, a - lo:b - lo] = local_new[:, a - start:b - start]


def attn_skel(cfg, cross: bool = False):
    """A cross-attention block (``cross``) has no qk-norm."""
    d, qd, kvd = cfg.d_model, cfg.q_dim, cfg.kv_dim
    s = {
        "wq": Param((d, qd), ("embed", "heads")),
        "wk": Param((d, kvd), ("embed", "kv")),
        "wv": Param((d, kvd), ("embed", "kv")),
        "wo": Param((qd, d), ("heads", "embed")),
    }
    if cfg.qk_norm and not cross:
        s["q_norm"] = Param((cfg.head_dim,), (None,), init="zeros")
        s["k_norm"] = Param((cfg.head_dim,), (None,), init="zeros")
    return s


def _rotate(cfg, x, pos, positions_3d):
    """RoPE or M-RoPE of x (B, S, H, D) at positions pos (S,), or x itself for
    ``rope="none"``; M-RoPE without ``positions_3d`` (3, B, S) rotates every
    stream by pos, as the JAX package."""
    if cfg.rope == "none":
        return x
    if cfg.rope == "rope":
        return apply_rope(x, pos[None, :], cfg.rope_theta)
    if cfg.rope == "mrope":
        if positions_3d is None:
            positions_3d = pos[None, None, :].expand(3, x.shape[0], x.shape[1])
        return apply_mrope(x, positions_3d, cfg.rope_theta, cfg.mrope_sections)
    raise ValueError(f"unknown rope {cfg.rope!r}")


def _positions_rope(cfg, p, q, k, q_pos, kv_pos, positions_3d=None):
    """Apply qk-norm then rotary embedding.  q: (B,S,K,G,D), k: (B,S,K,D)."""
    if cfg.qk_norm:
        q = rmsnorm(q, p["q_norm"])
        k = rmsnorm(k, p["k_norm"])
    B, S = q.shape[:2]
    qf = _rotate(cfg, q.reshape(B, S, -1, cfg.head_dim), q_pos, positions_3d)
    return qf.reshape(q.shape), _rotate(cfg, k, kv_pos, positions_3d)


def attention_fwd(cfg, p, x: torch.Tensor, spec, q_pos: torch.Tensor, positions_3d=None,
                  kv_x: Optional[torch.Tensor] = None, causal: bool = True) -> torch.Tensor:
    """Prefill attention (no cache).  x: (B, S, d); q_pos: (S,) positions;
    positions_3d: M-RoPE's (3, B, S) streams or None.  ``kv_x`` (B, Skv, d),
    the encoder's output, makes it cross-attention: K and V projected from
    it, no rotary embedding or qk-norm, every frame visible.  Without it,
    ``causal=False`` is bidirectional self-attention."""
    cross = kv_x is not None
    src = kv_x if cross else x
    B, S = x.shape[:2]
    Skv = src.shape[1]
    K, H, D = cfg.num_kv_heads, cfg.num_heads, cfg.head_dim
    G = H // K
    q = _heads(dense(x, p["wq"]), K, (B, S, K, G, D))
    k = _heads(dense(src, p["wk"]), K, (B, Skv, K, D))
    v = _heads(dense(src, p["wv"]), K, (B, Skv, K, D))
    if not cross:
        q, k = _positions_rope(cfg, p, q, k, q_pos, q_pos, positions_3d)
    # kernel layout: head h = k*G + g, so the kernel's h // G finds kv head k
    qh = q.permute(0, 2, 3, 1, 4).reshape(B, H, S, D).contiguous()
    kh = k.permute(0, 2, 1, 3).contiguous()
    vh = v.permute(0, 2, 1, 3).contiguous()
    # self-attention: q and kv share positions, so the masks q_pos[i] >=
    # kv_pos[j] and q_pos[i] - kv_pos[j] < window are i >= j and i - j <
    # window whatever q_pos starts at, and the kernel's q_offset is 0; cross:
    # kv positions are arange(Skv) and no causal mask applies
    window = spec.window if spec.attention == "window" else 0
    if isinstance(qh, DTensor):
        PLACEMENTS_SEEN.add(str(tuple(qh.placements)))
    out = ops.flash_attention(qh, kh, vh, causal=causal and not cross, window=window, q_offset=0)
    out = out.reshape(B, K, G, S, D).permute(0, 3, 1, 2, 4).reshape(B, S, H * D)
    return dense(out, p["wo"])


def attention_prefill_kv(cfg, p, x: torch.Tensor, q_pos: torch.Tensor, positions_3d=None):
    """The K/V tensors that seed a decode cache: a (B,S,K,D) pair."""
    B, S = x.shape[:2]
    K, D = cfg.num_kv_heads, cfg.head_dim
    k = _heads(dense(x, p["wk"]), K, (B, S, K, D))
    if cfg.qk_norm:
        k = rmsnorm(k, p["k_norm"])
    k = _rotate(cfg, k, q_pos, positions_3d)
    return k, _heads(dense(x, p["wv"]), K, (B, S, K, D))


def decode_attend(
    q: torch.Tensor,  # (B, K, G, 1, D)
    k_cache: torch.Tensor,  # (B, C, K, D)
    v_cache: torch.Tensor,  # (B, C, K, D)
    kv_positions: torch.Tensor,  # (C,) token position per slot; < 0 invalid
    t: int,  # position of the new token
    window: int = 0,
) -> torch.Tensor:
    """One-token attention over the cache, scores and softmax in f32.  On
    DTensors, each device's rows and heads against the whole cache length
    (``_decode_attend_local``)."""
    if isinstance(q, DTensor):
        return _decode_attend_local(q, k_cache, v_cache, kv_positions, t, window)
    scale = 1.0 / math.sqrt(q.shape[-1])
    s = torch.einsum("bkgqd,bskd->bkgqs", q.float(), k_cache.float()) * scale
    mask = (kv_positions >= 0) & (kv_positions <= t)
    if window:
        mask &= (t - kv_positions) < window
    s = torch.where(mask[None, None, None, None, :], s, torch.full_like(s, NEG_INF))
    p = torch.softmax(s, dim=-1)
    out = torch.einsum("bkgqs,bskd->bkgqd", p.to(v_cache.dtype).float(), v_cache.float())
    return out.to(q.dtype)


def _decode_attend_local(q, k_cache, v_cache, kv_positions, t: int, window: int):
    """``decode_attend`` on each device's block: q's batch and head splits
    kept (a kv-head split of q takes the caches' kv heads, a split within
    the groups takes them whole), every slot of the cache gathered to each
    device, which then attends exactly as one device does.  (DTensor's own
    einsum flattens two split dims into one, which some torch versions
    refuse.)"""
    q_in, kv_in = [], []
    for p in q.placements:
        d = p.dim if isinstance(p, Shard) else None
        q_in.append(p if d in (0, 1, 2) else Replicate())
        kv_in.append(Shard(0) if d == 0 else Shard(2) if d == 1 else Replicate())
    fn = local_region(lambda q_, k_, v_: decode_attend(q_, k_, v_, kv_positions, t, window), q_in,
                      (q_in, kv_in, kv_in), q.device_mesh)
    return fn(q, k_cache, v_cache)


def attention_decode(
    cfg,
    p,
    x: torch.Tensor,  # (B, 1, d)
    spec,
    cache: Tuple[torch.Tensor, torch.Tensor],  # k, v: (B, C, K, D); C = S or window
    t: int,
    cross: bool = False,
) -> Tuple[torch.Tensor, Tuple[torch.Tensor, torch.Tensor]]:
    """One decode step: returns (output, cache).

    A windowed layer whose cache has ``C == window`` slots uses it as a RING:
    slot j holds the latest position congruent to j (mod C), and the new
    token goes to slot ``t % C``.  Any other cache is linear: slot == position.
    The new token's k/v are written in place (JAX returns an updated copy
    with ``dynamic_update_slice``); a ``t`` past a linear cache raises
    ``IndexError`` instead of being clamped.

    ``cross``: the cache is the static cross cache (the encoder's K/V), left
    as it is; every slot is valid (positions 0..C-1 against ``t = C - 1``),
    and q takes no rotary embedding."""
    B = x.shape[0]
    K, H, D = cfg.num_kv_heads, cfg.num_heads, cfg.head_dim
    G = H // K
    k_cache, v_cache = cache
    C = k_cache.shape[1]
    q = _heads(dense(x, p["wq"]), K, (B, 1, K, G, D))
    j = torch.arange(C, device=x.device)
    if cross:
        out = decode_attend(q.permute(0, 2, 3, 1, 4), k_cache, v_cache, j, C - 1)
    else:
        xk = _heads(dense(x, p["wk"]), K, (B, 1, K, D))
        xv = _heads(dense(x, p["wv"]), K, (B, 1, K, D))
        pos = torch.full((1,), t, dtype=torch.long, device=x.device)
        q, xk = _positions_rope(cfg, p, q, xk, pos, pos)
        windowed = spec.attention == "window" and C == spec.window
        slot = t % C if windowed else t
        write_rows(k_cache, slot, xk)
        write_rows(v_cache, slot, xv)
        # ring: positions in (t - C, t], floor modulo as jnp's; < 0 => empty slot
        kv_positions = t - torch.remainder(t - j, C) if windowed else j
        window = spec.window if spec.attention == "window" else 0
        out = decode_attend(q.permute(0, 2, 3, 1, 4), k_cache, v_cache, kv_positions, t, window)
    out = out.permute(0, 3, 1, 2, 4).reshape(B, 1, H * D)
    return dense(out, p["wo"]), (k_cache, v_cache)
