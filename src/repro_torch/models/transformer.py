"""Model assembly: embed -> layer stages -> norm -> lm head (port of
``repro.models.transformer``): ``train_loss`` (and ``forward``), prefill and
decode for the dense path.

Parameters keep the JAX package's tree: each stage stacks its layers on a
leading "layers" axis, and where JAX scans over that axis the port runs a
Python loop over it.  Caches mirror the JAX tree too: per stage,
``{"pos0": {"k": (L,B,C,K,D), "v": (L,B,C,K,D)}}``; the port fills and
updates them in place (JAX returns new arrays).  GSPMD sharding hints have
no counterpart on one device.  The dense path has no MoE auxiliary loss, so
``layer_fwd``, ``stage_fwd`` and ``forward`` return no ``aux`` term.

The slice runs dense attention layers with RMSNorm, SwiGLU and RoPE; any
other configuration raises ``NotImplementedError`` (:func:`check_supported`).
"""

from __future__ import annotations

from typing import Any, Callable, Dict, List, Optional

import torch

from repro_torch.configs.base import LayerSpec, ModelConfig
from repro_torch.models import attention as attn
from repro_torch.models import moe as moe_mod
from repro_torch.models.common import Param, apply_norm, norm_skel, tree_map_params


def check_supported(cfg: ModelConfig) -> None:
    """Raise ``NotImplementedError`` naming what this slice of the port lacks."""
    missing = []
    for spec in cfg.pattern + cfg.tail_pattern:
        if spec.kind != "attn":
            missing.append(f"{spec.kind} layers")
        elif spec.attention != "full":
            missing.append(f"{spec.attention} attention with ring caches")
        if spec.moe:
            missing.append("MoE FFN")
    if cfg.is_encoder_decoder:
        missing.append("encoder and cross-attention")
    if cfg.rope != "rope":
        missing.append(f"rope={cfg.rope!r}")
    if cfg.norm != "rmsnorm":
        missing.append(f"norm={cfg.norm!r}")
    if cfg.act != "swiglu":
        missing.append(f"act={cfg.act!r}")
    if missing:
        raise NotImplementedError(
            f"{cfg.name}: the port runs dense attention with RMSNorm, SwiGLU and RoPE "
            f"only so far; missing: {', '.join(sorted(set(missing)))}"
        )


# ---------------------------------------------------------------------------
# skeletons
# ---------------------------------------------------------------------------


def layer_skel(cfg: ModelConfig, spec: LayerSpec):
    if spec.kind != "attn" or spec.moe:
        raise NotImplementedError(f"{spec}: the port runs dense attention layers only so far")
    return {
        "ln1": norm_skel(cfg),
        "attn": attn.attn_skel(cfg),
        "ln2": norm_skel(cfg),
        "ffn": moe_mod.ffn_skel(cfg),
    }


def _stack(skel, n: int):
    return tree_map_params(
        lambda p: Param((n,) + p.shape, ("layers",) + p.axes, p.init, p.scale, p.dtype),
        skel,
    )


def stage_skel(cfg: ModelConfig, pattern, nblocks: int):
    return _stack({f"pos{i}": layer_skel(cfg, s) for i, s in enumerate(pattern)}, nblocks)


def model_skel(cfg: ModelConfig):
    check_supported(cfg)
    V, d = cfg.padded_vocab, cfg.d_model
    s: Dict[str, Any] = {
        "embed": Param((V, d), (None, "heads"), scale=1.0),
        "final_norm": norm_skel(cfg),
    }
    if not cfg.tie_embeddings:
        s["lm_head"] = Param((d, V), ("embed", "vocab"))
    s["stages"] = [stage_skel(cfg, pattern, nblocks) for pattern, nblocks in cfg.stages()]
    return s


def _layer(tree, i: int):
    """Block ``i`` of a tree stacked on the leading "layers" axis (views)."""
    if isinstance(tree, dict):
        return {k: _layer(v, i) for k, v in tree.items()}
    return tree[i]


# ---------------------------------------------------------------------------
# layer forward (prefill / decode)
# ---------------------------------------------------------------------------


def _ffn_part(cfg, lp, x):
    return x + moe_mod.ffn_fwd(cfg, lp["ffn"], apply_norm(cfg, lp["ln2"], x))


def layer_fwd(cfg, spec, lp, x, q_pos):
    """Full-sequence forward of one layer (training)."""
    h = apply_norm(cfg, lp["ln1"], x)
    x = x + attn.attention_fwd(cfg, lp["attn"], h, spec, q_pos)
    return _ffn_part(cfg, lp, x)


def layer_prefill(cfg, spec, lp, x, q_pos, cache):
    """Forward one layer over the prompt and write its K/V into ``cache``
    (``{"k", "v"}`` views of shape (B, C, K, D), filled in place)."""
    h = apply_norm(cfg, lp["ln1"], x)
    x = x + attn.attention_fwd(cfg, lp["attn"], h, spec, q_pos)
    # recomputes k and v as the JAX package does (attention_prefill_kv)
    k, v = attn.attention_prefill_kv(cfg, lp["attn"], h, q_pos)
    cache["k"][:, : k.shape[1]] = k
    cache["v"][:, : v.shape[1]] = v
    return _ffn_part(cfg, lp, x)


def layer_decode(cfg, spec, lp, x, t: int, cache):
    """One-token forward against the cache (updated in place)."""
    h = apply_norm(cfg, lp["ln1"], x)
    out, _ = attn.attention_decode(cfg, lp["attn"], h, spec, (cache["k"], cache["v"]), t)
    return _ffn_part(cfg, lp, x + out)


# ---------------------------------------------------------------------------
# stage runners (a Python loop over the stacked blocks)
# ---------------------------------------------------------------------------


def _num_blocks(stage_params) -> int:
    return stage_params["pos0"]["ln1"]["w"].shape[0]


def stage_fwd(cfg, pattern, stage_params, x, q_pos, wrap: Optional[Callable] = None):
    """Every block of the stage in turn.  ``wrap`` (the train step's remat)
    maps the block function ``(h, block_params) -> h`` to the one that runs,
    as the JAX train step wraps its scanned block body in ``jax.checkpoint``."""

    def block(h, bp):
        for i, spec in enumerate(pattern):
            h = layer_fwd(cfg, spec, bp[f"pos{i}"], h, q_pos)
        return h

    run = block if wrap is None else wrap(block)
    for blk in range(_num_blocks(stage_params)):
        x = run(x, _layer(stage_params, blk))
    return x


def stage_prefill(cfg, pattern, stage_params, x, q_pos, cache_seq: int):
    B, S = x.shape[:2]
    if S > cache_seq:
        raise ValueError(f"prompt of {S} tokens does not fit a cache of {cache_seq}")
    n = _num_blocks(stage_params)
    shape = (n, B, cache_seq, cfg.num_kv_heads, cfg.head_dim)
    caches = {
        f"pos{i}": {"k": x.new_zeros(shape), "v": x.new_zeros(shape)}
        for i in range(len(pattern))
    }
    for blk in range(n):
        bp = _layer(stage_params, blk)
        for i, spec in enumerate(pattern):
            x = layer_prefill(cfg, spec, bp[f"pos{i}"], x, q_pos, _layer(caches[f"pos{i}"], blk))
    return x, caches


def stage_decode(cfg, pattern, stage_params, x, t: int, caches):
    for blk in range(_num_blocks(stage_params)):
        bp = _layer(stage_params, blk)
        for i, spec in enumerate(pattern):
            x = layer_decode(cfg, spec, bp[f"pos{i}"], x, t, _layer(caches[f"pos{i}"], blk))
    return x, caches


# ---------------------------------------------------------------------------
# model entry points
# ---------------------------------------------------------------------------


def _embed(cfg, params, tokens):
    return params["embed"][tokens].to(getattr(torch, cfg.dtype))


class _F32Product(torch.autograd.Function):
    """``x2 @ w`` of bf16 operands with cuBLAS's f32 output (``mm`` with
    ``out_dtype``), which has no derivative in torch.  Back, dx and dw are
    products of the same kind: the f32 cotangent rounded to bf16, bf16
    operands, f32 accumulation, each result rounded to its operand's type."""

    @staticmethod
    def forward(ctx, x2, w):
        ctx.save_for_backward(x2, w)
        return torch.mm(x2, w, out_dtype=torch.float32)

    @staticmethod
    def backward(ctx, g):
        x2, w = ctx.saved_tensors
        g = g.to(x2.dtype)
        dx = torch.mm(g, w.t(), out_dtype=torch.float32).to(x2.dtype) if ctx.needs_input_grad[0] else None
        dw = torch.mm(x2.t(), g, out_dtype=torch.float32).to(w.dtype) if ctx.needs_input_grad[1] else None
        return dx, dw


def _unembed(cfg, params, x):
    """Logits as an f32 product, as the JAX package asks its dot for an f32
    result: of bf16 x and w, cuBLAS's f32 output on the card (``mm`` with
    ``out_dtype``, through ``_F32Product`` for its gradient), the product of
    the upcast values on the CPU; where the types differ, JAX promotes both
    to f32 and so does this."""
    w = params.get("lm_head")
    if w is None:
        w = params["embed"].T
    x2 = x.reshape(-1, x.shape[-1])
    if x.device.type == "cuda" and x.dtype == w.dtype == torch.bfloat16:
        y = _F32Product.apply(x2, w)
    else:
        y = torch.mm(x2.float(), w.float())
    return y.reshape(*x.shape[:-1], w.shape[-1])


def forward(cfg: ModelConfig, params, batch, wrap: Optional[Callable] = None) -> torch.Tensor:
    """Full-sequence logits (B, S, V_padded) in f32.

    ``batch["x_embed"]`` (embeddings gathered already) takes precedence over
    ``batch["tokens"]``: the microbatched train step hoists the embedding
    gather out of its loop, as the JAX package's does.  ``wrap`` is the
    remat of each layer block (``stage_fwd``)."""
    check_supported(cfg)
    if "x_embed" in batch:
        x = batch["x_embed"].to(getattr(torch, cfg.dtype))
    else:
        x = _embed(cfg, params, batch["tokens"])
    q_pos = torch.arange(x.shape[1], device=x.device)
    for (pattern, _n), sp in zip(cfg.stages(), params["stages"]):
        x = stage_fwd(cfg, pattern, sp, x, q_pos, wrap)
    x = apply_norm(cfg, params["final_norm"], x)
    return _unembed(cfg, params, x)


def train_loss(cfg: ModelConfig, params, batch, wrap: Optional[Callable] = None) -> torch.Tensor:
    """Next-token cross-entropy in f32, the mean over labels >= 0.

    The label's log-probability is a gather where the JAX package contracts
    with a one-hot (a form for its SPMD partitioner): a sum with one nonzero
    term is exact in f32, so both give the same number."""
    logits = forward(cfg, params, batch, wrap)
    labels = batch["labels"]
    lse = torch.logsumexp(logits, dim=-1)
    picked = logits.gather(-1, labels.clamp(min=0)[..., None])[..., 0]
    mask = (labels >= 0).float()
    return -((picked - lse) * mask).sum() / mask.sum().clamp(min=1.0)


def prefill(cfg: ModelConfig, params, batch, cache_seq: int):
    """Process the prompt ``batch["tokens"]`` (B, S); return (last-token
    logits (B, V_padded) in f32, caches of length ``cache_seq``)."""
    check_supported(cfg)
    tokens = batch["tokens"]
    S = tokens.shape[1]
    x = _embed(cfg, params, tokens)
    q_pos = torch.arange(S, device=x.device)
    all_caches: List[Dict[str, Any]] = []
    for (pattern, _n), sp in zip(cfg.stages(), params["stages"]):
        x, caches = stage_prefill(cfg, pattern, sp, x, q_pos, cache_seq)
        all_caches.append(caches)
    x = apply_norm(cfg, params["final_norm"], x)
    return _unembed(cfg, params, x[:, -1:])[:, 0], all_caches


def decode_step(cfg: ModelConfig, params, token, t: int, caches):
    """One decode step: token (B, 1) at position ``t``; returns (logits, caches)."""
    check_supported(cfg)
    x = _embed(cfg, params, token)
    for (pattern, _n), sp, cs in zip(cfg.stages(), params["stages"], caches):
        x, _ = stage_decode(cfg, pattern, sp, x, t, cs)
    x = apply_norm(cfg, params["final_norm"], x)
    return _unembed(cfg, params, x)[:, 0], caches
