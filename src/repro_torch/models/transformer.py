"""Model assembly: embed -> layer stages -> norm -> lm head (port of
``repro.models.transformer``): ``train_loss`` (and ``forward``), prefill and
decode.

Parameters keep the JAX package's tree: each stage stacks its layers on a
leading "layers" axis, and where JAX scans over that axis the port runs a
Python loop over it.  Caches mirror the JAX tree too, per stage and pattern
position, by the position's kind: attention ``{"k", "v"}`` of (L,B,C,K,D)
with C the position's own length (``cache_len_for``: a windowed layer keeps
at most its window, as a ring); Mamba ``{"conv": (L,B,W-1,di), "ssm":
(L,B,di,N) f32}``; RWKV ``{"shift_t", "shift_c": (L,B,d), "wkv":
(L,B,H,hs,hs) f32}``; a decoder layer with cross-attention wraps its own
cache as ``{"self": <it>, "cross_k", "cross_v"}``, the encoder output's K/V
of (L,B,E,K,D) in the model's type, written once by prefill.  The port
fills and updates them in place (JAX returns new arrays); ``cache_skel``
gives their shapes on ``meta`` and ``cache_spec_skel`` their partition
specs.  The JAX package's sharding hints (``_constrain``) stand where its
do: a plain tensor passes unchanged, a DTensor is redistributed to the
policy's placements.  ``layer_fwd``, ``stage_fwd`` and
``forward`` carry the MoE auxiliary loss (0 for a plain FFN or an RWKV
block), as the JAX package's do.

The port runs stacks of attention layers (full or sliding-window), Mamba
layers (``models/ssm.py``; each with its FFN or MoE after it, as Jamba
interleaves them) and RWKV-6 blocks (their own channel mix, no FFN), with a
SwiGLU or gelu FFN or a mixture of experts, RMSNorm or LayerNorm, and RoPE,
M-RoPE (``batch["positions_3d"]``, the three position streams, read by
``forward`` and ``prefill`` when ``cfg.rope == "mrope"``; decode rotates
every stream by the token's position, as the JAX package does) or no rotary
embedding.  An encoder-decoder (``cfg.encoder_layers``, Whisper's) runs a
bidirectional encoder over ``batch["encoder_frames"]`` (B, E, d), frames
that a stubbed frontend would give, and gives every attention and Mamba
layer of the decoder a cross-attention into its output (an RWKV block takes
none, as in the JAX package); the decoder adds sinusoidal positions to its
embeddings.
"""

from __future__ import annotations

import functools
from typing import Any, Callable, Dict, List, Optional

import torch
from torch.distributed.tensor import DTensor, Partial, Replicate, Shard
from torch.distributed.tensor import zeros as dtensor_zeros

from repro_torch.configs.base import LayerSpec, ModelConfig
from repro_torch.models import attention as attn
from repro_torch.models import moe as moe_mod
from repro_torch.models import ssm as ssm_mod
from repro_torch.models.common import (
    Param,
    apply_norm,
    dense,
    f32_product,
    norm_skel,
    product,
    sinusoidal_positions,
    tree_map_params,
)
from repro_torch.sharding.partitioning import PartitionSpec, block_start, cache_specs, placements, tree_map_specs
from repro_torch.sharding.regions import local_region


def check_supported(cfg: ModelConfig) -> None:
    """Raise ``NotImplementedError`` naming a layer kind or attention the port lacks."""
    missing = []
    for spec in cfg.pattern + cfg.tail_pattern:
        if spec.kind not in ("attn", "mamba", "rwkv"):
            missing.append(f"{spec.kind} layers")
        elif spec.kind == "attn" and spec.attention not in ("full", "window"):
            missing.append(f"{spec.attention} attention")
    if missing:
        raise NotImplementedError(
            f"{cfg.name}: the port runs attention, Mamba and RWKV layers only; "
            f"missing: {', '.join(sorted(set(missing)))}"
        )


# ---------------------------------------------------------------------------
# skeletons
# ---------------------------------------------------------------------------


def layer_skel(cfg: ModelConfig, spec: LayerSpec, cross: bool = False):
    """One layer's parameters; ``cross`` adds a cross-attention block and its
    norm to an attention or Mamba layer (an RWKV block takes none)."""
    s: Dict[str, Any] = {"ln1": norm_skel(cfg)}
    if spec.kind == "attn":
        s["attn"] = attn.attn_skel(cfg)
    elif spec.kind == "mamba":
        s["mixer"] = ssm_mod.mamba_skel(cfg)
    elif spec.kind == "rwkv":
        s["rwkv"] = ssm_mod.rwkv_skel(cfg)
        s["ln2"] = norm_skel(cfg)
        return s  # the rwkv block embeds its own channel-mix FFN
    else:
        raise ValueError(spec.kind)
    if cross:
        s["ln_cross"] = norm_skel(cfg)
        s["cross"] = attn.attn_skel(cfg, cross=True)
    s["ln2"] = norm_skel(cfg)
    if spec.moe:
        s["moe"] = moe_mod.moe_skel(cfg)
    else:
        s["ffn"] = moe_mod.ffn_skel(cfg)
    return s


def _stack(skel, n: int):
    return tree_map_params(
        lambda p: Param((n,) + p.shape, ("layers",) + p.axes, p.init, p.scale, p.dtype),
        skel,
    )


def stage_skel(cfg: ModelConfig, pattern, nblocks: int, cross: bool = False):
    return _stack({f"pos{i}": layer_skel(cfg, s, cross) for i, s in enumerate(pattern)}, nblocks)


# The encoder's one layer kind: full attention (bidirectional: stage_fwd's
# causal=False) and the FFN.
ENCODER_PATTERN = (LayerSpec(kind="attn"),)


def model_skel(cfg: ModelConfig):
    check_supported(cfg)
    V, d = cfg.padded_vocab, cfg.d_model
    s: Dict[str, Any] = {
        "embed": Param((V, d), (None, "heads"), scale=1.0),
        "final_norm": norm_skel(cfg),
    }
    if not cfg.tie_embeddings:
        s["lm_head"] = Param((d, V), ("embed", "vocab"))
    s["stages"] = [stage_skel(cfg, pattern, nblocks, cross=cfg.is_encoder_decoder)
                   for pattern, nblocks in cfg.stages()]
    if cfg.is_encoder_decoder:
        s["encoder"] = {"stage": stage_skel(cfg, ENCODER_PATTERN, cfg.encoder_layers),
                        "final_norm": norm_skel(cfg)}
    return s


def _layer(tree, i: int):
    """Block ``i`` of a tree stacked on the leading "layers" axis (views)."""
    if isinstance(tree, dict):
        return {k: _layer(v, i) for k, v in tree.items()}
    return tree[i]


# ---------------------------------------------------------------------------
# layer forward (prefill / decode)
# ---------------------------------------------------------------------------


def _ffn_part(cfg, lp, spec, x):
    """The residual FFN or MoE block: (x + out, aux), aux 0.0 for a plain FFN."""
    h = apply_norm(cfg, lp["ln2"], x)
    if spec.moe:
        if moe_mod.MOE_MODE[0] == "dropping":
            out, aux = moe_mod.moe_fwd_dropping(cfg, lp["moe"], h)
        else:
            out, aux = moe_mod.moe_fwd(cfg, lp["moe"], h)
    else:
        out, aux = moe_mod.ffn_fwd(cfg, lp["ffn"], h), 0.0
    return x + out, aux


def _norms(cfg, lp):
    """The RWKV block's ln1 and ln2, as functions of x."""
    return (lambda t: apply_norm(cfg, lp["ln1"], t)), (lambda t: apply_norm(cfg, lp["ln2"], t))


def _cross_part(cfg, lp, spec, x, q_pos, enc_out):
    """The residual cross-attention into the encoder's output ``enc_out``."""
    h = apply_norm(cfg, lp["ln_cross"], x)
    return x + attn.attention_fwd(cfg, lp["cross"], h, spec, q_pos, kv_x=enc_out)


def layer_fwd(cfg, spec, lp, x, q_pos, positions_3d=None, enc_out=None, causal=True):
    """Full-sequence forward of one layer (training): (x, aux).  With
    ``enc_out`` a layer that has cross-attention attends to it after its
    mixer; ``causal=False`` makes the self-attention bidirectional."""
    if spec.kind == "rwkv":
        return ssm_mod.rwkv_fwd(cfg, lp["rwkv"], x, *_norms(cfg, lp)), 0.0
    h = apply_norm(cfg, lp["ln1"], x)
    if spec.kind == "attn":
        x = x + attn.attention_fwd(cfg, lp["attn"], h, spec, q_pos, positions_3d, causal=causal)
    else:  # mamba
        x = x + ssm_mod.mamba_fwd(cfg, lp["mixer"], h)
    if enc_out is not None and "cross" in lp:
        x = _cross_part(cfg, lp, spec, x, q_pos, enc_out)
    return _ffn_part(cfg, lp, spec, x)


def cache_len_for(cfg, spec: LayerSpec, seq_len: int) -> int:
    """Slots of an attention position's cache: a windowed layer keeps at most
    its window; 0 for a Mamba or RWKV position, whose state is fixed-size."""
    if spec.kind != "attn":
        return 0
    if spec.attention == "window":
        return min(seq_len, spec.window)
    return seq_len


def cache_for(cfg, spec: LayerSpec, n: int, batch: int, cache_seq: int, dtype, device, enc_seq: int = 0):
    """Zeroed decode caches of one pattern position over its ``n`` blocks, by
    kind, with the JAX package's shapes and types (``cache_skel``): K/V in
    the model's type; Mamba's conv state in the model's type and its SSM
    state in f32; RWKV's shift states in the model's type and its wkv state
    in f32.  With ``enc_seq`` encoder frames, an attention or Mamba
    position's cache is ``{"self": <that>, "cross_k", "cross_v"}``, the
    cross K/V (n, batch, enc_seq, K, D) in the model's type."""
    zeros = lambda *shape, dt=dtype: torch.zeros((n, batch) + shape, dtype=dt, device=device)
    if enc_seq and spec.kind != "rwkv":
        kv = (enc_seq, cfg.num_kv_heads, cfg.head_dim)
        return {"self": cache_for(cfg, spec, n, batch, cache_seq, dtype, device),
                "cross_k": zeros(*kv), "cross_v": zeros(*kv)}
    if spec.kind == "attn":
        shape = (cache_len_for(cfg, spec, cache_seq), cfg.num_kv_heads, cfg.head_dim)
        return {"k": zeros(*shape), "v": zeros(*shape)}
    if spec.kind == "mamba":
        di = cfg.ssm_expand * cfg.d_model
        return {"conv": zeros(cfg.ssm_conv_width - 1, di), "ssm": zeros(di, cfg.ssm_state_dim, dt=torch.float32)}
    if spec.kind == "rwkv":
        d, hs = cfg.d_model, cfg.rwkv_head_size
        return {"shift_t": zeros(d), "shift_c": zeros(d), "wkv": zeros(d // hs, hs, hs, dt=torch.float32)}
    raise ValueError(spec.kind)


def cache_skel(cfg: ModelConfig, batch: int, seq_len: int):
    """The decode caches of a shape cell as tensors on ``meta``: per stage, per
    pattern position, ``cache_for``'s tree over the stage's blocks (an
    encoder-decoder's with its cross K/V over ``cfg.encoder_seq`` frames)."""
    dt = getattr(torch, cfg.dtype)
    enc = cfg.encoder_seq if cfg.is_encoder_decoder else 0
    return [{f"pos{i}": cache_for(cfg, spec, n, batch, seq_len, dt, "meta", enc) for i, spec in enumerate(pattern)}
            for pattern, n in cfg.stages()]


def cache_spec_skel(cfg: ModelConfig, b_ax, seq_ax, tp_ax):
    """PartitionSpec tree mirroring :func:`cache_skel`.

    b_ax: batch mesh axes (or None); seq_ax: cache-length mesh axes; tp_ax:
    model axis for state inner dims.  The leading dim is the stacked layers
    axis (never sharded).  Where ``cache_for`` gives a Mamba position of an
    encoder-decoder cross K/V too (the JAX package's ``cache_skel`` does not;
    no config has both), the spec mirrors the port's tree."""

    def one_layer(spec: LayerSpec):
        if cfg.is_encoder_decoder and spec.kind != "rwkv":
            return {"self": _own(spec),
                    "cross_k": PartitionSpec(None, b_ax, None, None, None),
                    "cross_v": PartitionSpec(None, b_ax, None, None, None)}
        return _own(spec)

    def _own(spec: LayerSpec):
        if spec.kind == "attn":
            return {"k": PartitionSpec(None, b_ax, seq_ax, None, None), "v": PartitionSpec(None, b_ax, seq_ax, None, None)}
        if spec.kind == "mamba":
            return {"conv": PartitionSpec(None, b_ax, None, tp_ax), "ssm": PartitionSpec(None, b_ax, tp_ax, None)}
        if spec.kind == "rwkv":
            return {"shift_t": PartitionSpec(None, b_ax, tp_ax), "shift_c": PartitionSpec(None, b_ax, tp_ax),
                    "wkv": PartitionSpec(None, b_ax, tp_ax, None, None)}
        raise ValueError(spec.kind)

    return [{f"pos{i}": one_layer(s) for i, s in enumerate(pattern)} for pattern, _n in cfg.stages()]


def _store(cache, state) -> None:
    """Write a layer's new state into its cache views, in place."""
    for name, t in state.items():
        cache[name].copy_(t)


def layer_prefill(cfg, spec, lp, x, q_pos, cache, positions_3d=None, enc_out=None):
    """Forward one layer over the prompt and write its decode cache (views of
    one block of ``cache_for``'s tensors, filled in place).  Attention: its
    K/V from slot 0 when the prompt fits, else a ring of its last C
    positions, position p at slot p % C.  Mamba and RWKV: the state after
    the prompt.  With cross-attention (``enc_out``) the encoder output's K/V
    too.  Returns (x, aux)."""
    if spec.kind == "rwkv":
        out, state = ssm_mod.rwkv_prefill(cfg, lp["rwkv"], x, *_norms(cfg, lp))
        _store(cache, state)
        return out, 0.0
    cross = enc_out is not None and "cross" in lp
    own = cache["self"] if cross else cache
    h = apply_norm(cfg, lp["ln1"], x)
    if spec.kind == "mamba":
        y, state = ssm_mod.mamba_prefill(cfg, lp["mixer"], h)
        _store(own, state)
        x = x + y
    else:
        x = x + attn.attention_fwd(cfg, lp["attn"], h, spec, q_pos, positions_3d)
        # recomputes k and v as the JAX package does (attention_prefill_kv)
        k, v = attn.attention_prefill_kv(cfg, lp["attn"], h, q_pos, positions_3d)
        S, C = k.shape[1], own["k"].shape[1]
        if C >= S:
            attn.write_rows(own["k"], 0, k)
            attn.write_rows(own["v"], 0, v)
        else:  # ring cache: keep the last C positions at slots pos % C
            own["k"].copy_(torch.roll(k[:, -C:], S % C, dims=1))
            own["v"].copy_(torch.roll(v[:, -C:], S % C, dims=1))
    if cross:
        x = _cross_part(cfg, lp, spec, x, q_pos, enc_out)
        # projects the encoder's K/V again for the cache, as the JAX package does
        for name, w in (("cross_k", lp["cross"]["wk"]), ("cross_v", lp["cross"]["wv"])):
            cache[name].copy_(dense(enc_out, w).reshape(cache[name].shape))
    return _ffn_part(cfg, lp, spec, x)


def layer_decode(cfg, spec, lp, x, t: int, cache):
    """One-token forward against the cache (updated in place; a cross cache
    is only read)."""
    if spec.kind == "rwkv":
        out, state = ssm_mod.rwkv_decode(cfg, lp["rwkv"], x, cache, *_norms(cfg, lp))
        _store(cache, state)
        return out
    cross = "cross_k" in cache
    own = cache["self"] if cross else cache
    h = apply_norm(cfg, lp["ln1"], x)
    if spec.kind == "attn":
        out, _ = attn.attention_decode(cfg, lp["attn"], h, spec, (own["k"], own["v"]), t)
    else:  # mamba
        out, state = ssm_mod.mamba_decode(cfg, lp["mixer"], h, own)
        _store(own, state)
    x = x + out
    if cross:
        h = apply_norm(cfg, lp["ln_cross"], x)
        out, _ = attn.attention_decode(cfg, lp["cross"], h, spec, (cache["cross_k"], cache["cross_v"]), t,
                                       cross=True)
        x = x + out
    x, _ = _ffn_part(cfg, lp, spec, x)
    return x


# ---------------------------------------------------------------------------
# activation sharding
# ---------------------------------------------------------------------------


# Activation-sharding policy, set by a launcher (the model code itself is
# mesh-agnostic): "batch" -> the mesh axes of the activation batch dim, "tp"
# -> the model/TP axis.  Unset, ``_constrain`` returns what it is given.
ACTIVATION_SHARDING: Dict[str, Any] = {"batch": None, "tp": None}


def set_activation_sharding(batch_axes, tp_axis) -> None:
    ACTIVATION_SHARDING["batch"] = batch_axes
    ACTIVATION_SHARDING["tp"] = tp_axis


def _constrain(x, dims):
    """dims: a policy key or None per tensor dim.  A DTensor is
    redistributed over its own mesh to the placements of that spec; a plain
    tensor (one device, no mesh) is returned unchanged, as the JAX package
    returns its array where no mesh is in context."""
    if ACTIVATION_SHARDING["batch"] is None and ACTIVATION_SHARDING["tp"] is None:
        return x
    if not isinstance(x, DTensor):
        return x
    spec = PartitionSpec(*[ACTIVATION_SHARDING.get(d) if d else None for d in dims])
    return x.redistribute(x.device_mesh, placements(spec, x.device_mesh))


# ---------------------------------------------------------------------------
# stage runners (a Python loop over the stacked blocks)
# ---------------------------------------------------------------------------


def _num_blocks(stage_params) -> int:
    return stage_params["pos0"]["ln1"]["w"].shape[0]


def stage_fwd(cfg, pattern, stage_params, x, q_pos, wrap: Optional[Callable] = None, positions_3d=None,
              enc_out=None, causal: bool = True):
    """Every block of the stage in turn: (x, the f32 sum of the layers' aux).
    ``wrap`` (the train step's remat) maps the block function
    ``(h, block_params) -> (h, aux)`` to the one that runs, as the JAX train
    step wraps its scanned block body in ``jax.checkpoint``.  ``enc_out`` and
    ``causal`` go to every layer (``layer_fwd``)."""

    def block(h, bp):
        aux = torch.zeros((), dtype=torch.float32, device=h.device)
        for i, spec in enumerate(pattern):
            h, a = layer_fwd(cfg, spec, bp[f"pos{i}"], h, q_pos, positions_3d, enc_out, causal)
            aux = aux + a
        return h, aux

    run = block if wrap is None else wrap(block)
    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    for blk in range(_num_blocks(stage_params)):
        # the block carry pinned batch-sharded, outside the remat as in the
        # JAX package's stage_fwd and its train step's rematted body
        x = _constrain(x, ("batch", None, None))
        x, a = run(x, _layer(stage_params, blk))
        aux = aux + a
    return x, aux


def _placed_zeros(meta_tree, place_tree, mesh):
    """DTensor zeros of a tree of ``meta`` tensors, each with its placements."""
    if isinstance(meta_tree, dict):
        return {k: _placed_zeros(v, place_tree[k], mesh) for k, v in meta_tree.items()}
    return dtensor_zeros(meta_tree.shape, dtype=meta_tree.dtype, device_mesh=mesh, placements=place_tree)


def stage_prefill(cfg, pattern, stage_params, x, q_pos, cache_seq: int, positions_3d=None, enc_out=None,
                  cache_places=None):
    """``cache_places``: the stage's tree of cache placements, for DTensor
    activations (``prefill`` passes ``partitioning.cache_specs``' own)."""
    B, S = x.shape[:2]
    if S > cache_seq:
        raise ValueError(f"prompt of {S} tokens does not fit a cache of {cache_seq}")
    n = _num_blocks(stage_params)
    E = 0 if enc_out is None else enc_out.shape[1]
    dev = "meta" if cache_places is not None else x.device
    caches = {f"pos{i}": cache_for(cfg, spec, n, B, cache_seq, x.dtype, dev, E)
              for i, spec in enumerate(pattern)}
    if cache_places is not None:
        caches = _placed_zeros(caches, cache_places, x.device_mesh)
    for blk in range(n):
        bp = _layer(stage_params, blk)
        x = _constrain(x, ("batch", None, None))
        for i, spec in enumerate(pattern):
            # prefill's aux is dropped, as the JAX package drops it
            x, _ = layer_prefill(cfg, spec, bp[f"pos{i}"], x, q_pos, _layer(caches[f"pos{i}"], blk),
                                 positions_3d, enc_out)
    return x, caches


def stage_decode(cfg, pattern, stage_params, x, t: int, caches):
    for blk in range(_num_blocks(stage_params)):
        bp = _layer(stage_params, blk)
        x = _constrain(x, ("batch", None, None))
        for i, spec in enumerate(pattern):
            x = layer_decode(cfg, spec, bp[f"pos{i}"], x, t, _layer(caches[f"pos{i}"], blk))
    return x, caches


# ---------------------------------------------------------------------------
# model entry points
# ---------------------------------------------------------------------------


def gather_rows(table: torch.Tensor, tokens: torch.Tensor) -> torch.Tensor:
    """``table[tokens]``.  On DTensors whose table is whole over the vocab,
    each device gathers from its block of the table with its own tokens: the
    rows split as the tokens are, the features as the table's, the table's
    gradient summed over the devices that split the tokens (``local_region``).
    DTensor's own rule for the gather refuses tokens split over two mesh dims
    (the batch over pod and data) in some torch versions; this one takes any."""
    if not isinstance(table, DTensor) or not isinstance(tokens, DTensor):
        return table[tokens]
    out = []
    for pt, pi in zip(table.placements, tokens.placements):
        if isinstance(pt, Shard) and (pt.dim == 0 or isinstance(pi, Shard)):
            return table[tokens]  # a vocab split, or both split on one mesh dim: DTensor's rule
        out.append(pi if isinstance(pi, Shard) else Shard(tokens.ndim) if isinstance(pt, Shard) else Replicate())
    fn = local_region(lambda t, i: t[i], out, (table.placements, tokens.placements), table.device_mesh)
    return fn(table, tokens)


def _embed(cfg, params, tokens):
    return gather_rows(params["embed"], tokens).to(getattr(torch, cfg.dtype))


def _unembed(cfg, params, x):
    """Logits as an f32 product (``common.f32_product``), as the JAX package
    asks its dot for an f32 result."""
    w = params.get("lm_head")
    if w is None:
        w = params["embed"].T
    w = _constrain(w, (None, "tp"))
    if isinstance(x, DTensor):  # rows kept as they are split, however unevenly
        return product(x, w.to(x.dtype), True)
    y = f32_product(x.reshape(-1, x.shape[-1]), w)
    return y.reshape(*x.shape[:-1], w.shape[-1])


def _run_encoder(cfg, params, frames, wrap: Optional[Callable] = None):
    """The encoder over ``frames`` (B, E, d), f32 or the model's type: the
    frames and their sinusoidal positions, each in the model's type, summed;
    the encoder stage with bidirectional attention; its final norm."""
    dt = getattr(torch, cfg.dtype)
    E = frames.shape[1]
    h = frames.to(dt) + sinusoidal_positions(E, cfg.d_model, frames.device).to(dt)
    q_pos = torch.arange(E, device=frames.device)
    h, _ = stage_fwd(cfg, ENCODER_PATTERN, params["encoder"]["stage"], h, q_pos, wrap, causal=False)
    return apply_norm(cfg, params["encoder"]["final_norm"], h)


# Rows of the encoder-decoder's position table in decode, as the JAX package's
# decode_step makes it (positions past the last take the last row).
DECODE_POSITIONS = 8192


@functools.lru_cache(maxsize=None)
def _decode_positions(d_model: int, device: torch.device) -> torch.Tensor:
    """The decoder's table of DECODE_POSITIONS sinusoidal positions, f32,
    made once per width and device: a decode step adds row min(t, 8191)."""
    return sinusoidal_positions(DECODE_POSITIONS, d_model, device)


def forward(cfg: ModelConfig, params, batch, wrap: Optional[Callable] = None):
    """Full-sequence (logits (B, S, V_padded) in f32, the f32 sum of the MoE aux).

    ``batch["x_embed"]`` (embeddings gathered already) takes precedence over
    ``batch["tokens"]``: the microbatched train step hoists the embedding
    gather out of its loop, as the JAX package's does.  ``wrap`` is the
    remat of each layer block (``stage_fwd``), the encoder's too.  With
    M-RoPE, ``batch["positions_3d"]`` (3, B, S) holds the position streams;
    without it every stream is the token's position.  An encoder-decoder
    reads ``batch["encoder_frames"]`` (B, E, d)."""
    check_supported(cfg)
    if "x_embed" in batch:
        x = batch["x_embed"].to(getattr(torch, cfg.dtype))
    else:
        x = _embed(cfg, params, batch["tokens"])
    if cfg.is_encoder_decoder or (cfg.rope == "none" and cfg.family not in ("ssm", "hybrid")):
        # added once, as the JAX package's forward adds them (its prefill and
        # decode add them only for an encoder-decoder)
        x = x + sinusoidal_positions(x.shape[1], cfg.d_model, x.device).to(x.dtype)
    enc_out = _run_encoder(cfg, params, batch["encoder_frames"], wrap) if cfg.is_encoder_decoder else None
    q_pos = torch.arange(x.shape[1], device=x.device)
    positions_3d = batch.get("positions_3d") if cfg.rope == "mrope" else None
    aux_total = torch.zeros((), dtype=torch.float32, device=x.device)
    for (pattern, _n), sp in zip(cfg.stages(), params["stages"]):
        x, aux = stage_fwd(cfg, pattern, sp, x, q_pos, wrap, positions_3d, enc_out)
        aux_total = aux_total + aux
    x = apply_norm(cfg, params["final_norm"], x)
    return _unembed(cfg, params, x), aux_total


def _pick_local(logits, labels, lo: int):
    """A device's block of the vocab: each row's logit at its label where the
    label falls in the block [lo, lo + V_local), else 0."""
    idx = labels.clamp(min=0) - lo
    inside = (idx >= 0) & (idx < logits.shape[-1])
    got = logits.gather(-1, idx.clamp(0, logits.shape[-1] - 1)[..., None])[..., 0]
    return torch.where(inside, got, torch.zeros_like(got))


def _sharded_lse_and_pick(logits, labels):
    """``logsumexp`` over the vocab and the label's logit, for logits (B, S, V)
    whose vocab may be split over the mesh: the max and the sum of exps as
    partial results over the vocab's split, and the pick as a sum of one
    nonzero term over the blocks (the JAX package's one-hot contraction)."""
    m = logits.detach().amax(dim=-1, keepdim=True)
    lse = torch.log(torch.exp(logits - m).sum(dim=-1)) + m[..., 0]
    mesh, places = logits.device_mesh, logits.placements
    lo = block_start(logits.shape, places, mesh, mesh.get_coordinate(), 2)
    out_places = [Partial() if p == Shard(2) else p for p in places]
    label_places = [Replicate() if p == Shard(2) else p for p in places]
    pick = local_region(functools.partial(_pick_local, lo=lo), out_places, (places, label_places), mesh)
    return lse, pick(logits, labels)


def train_loss(cfg: ModelConfig, params, batch, wrap: Optional[Callable] = None) -> torch.Tensor:
    """Next-token cross-entropy in f32, the mean over labels >= 0, plus the
    MoE aux loss weighted by ``router_aux_weight / num_layers``.

    The label's log-probability is a gather where the JAX package contracts
    with a one-hot (a form for its SPMD partitioner): a sum with one nonzero
    term is exact in f32, so both give the same number."""
    logits, aux = forward(cfg, params, batch, wrap)
    labels = batch["labels"]
    # as the JAX package constrains the logits and its one-hot of the labels
    logits = _constrain(logits, ("batch", None, "tp"))
    labels = _constrain(labels, ("batch", None))
    if isinstance(logits, DTensor):
        lse, picked = _sharded_lse_and_pick(logits, labels)
    else:
        lse = torch.logsumexp(logits, dim=-1)
        picked = logits.gather(-1, labels.clamp(min=0)[..., None])[..., 0]
    mask = (labels >= 0).float()
    loss = -((picked - lse) * mask).sum() / mask.sum().clamp(min=1.0)
    if cfg.num_experts:
        loss = loss + cfg.router_aux_weight * aux / max(1, cfg.num_layers)
    return loss


def prefill(cfg: ModelConfig, params, batch, cache_seq: int):
    """Process the prompt ``batch["tokens"]`` (B, S) (with M-RoPE, and
    ``batch["positions_3d"]`` (3, B, S) where given; an encoder-decoder runs
    its encoder over ``batch["encoder_frames"]`` first); return (last-token
    logits (B, V_padded) in f32, caches of ``cache_len_for(.., cache_seq)``
    slots per position, and the cross K/V)."""
    check_supported(cfg)
    tokens = batch["tokens"]
    S = tokens.shape[1]
    x = _embed(cfg, params, tokens)
    enc_out = None
    if cfg.is_encoder_decoder:
        x = x + sinusoidal_positions(S, cfg.d_model, x.device).to(x.dtype)
        enc_out = _run_encoder(cfg, params, batch["encoder_frames"])
    q_pos = torch.arange(S, device=x.device)
    positions_3d = batch.get("positions_3d") if cfg.rope == "mrope" else None
    places = [None] * len(params["stages"])
    if isinstance(x, DTensor):
        mesh = x.device_mesh
        places = tree_map_specs(lambda sp: placements(sp, mesh), cache_specs(cfg, mesh, tokens.shape[0]))
    all_caches: List[Dict[str, Any]] = []
    for (pattern, _n), sp, pl in zip(cfg.stages(), params["stages"], places):
        x, caches = stage_prefill(cfg, pattern, sp, x, q_pos, cache_seq, positions_3d, enc_out, pl)
        all_caches.append(caches)
    x = apply_norm(cfg, params["final_norm"], x)
    return _unembed(cfg, params, x[:, -1:])[:, 0], all_caches


def decode_step(cfg: ModelConfig, params, token, t: int, caches):
    """One decode step: token (B, 1) at position ``t``; returns (logits, caches)."""
    check_supported(cfg)
    x = _embed(cfg, params, token)
    if cfg.is_encoder_decoder:
        x = x + _decode_positions(cfg.d_model, x.device)[min(t, DECODE_POSITIONS - 1)].to(x.dtype)
    for (pattern, _n), sp, cs in zip(cfg.stages(), params["stages"], caches):
        x, _ = stage_decode(cfg, pattern, sp, x, t, cs)
    x = apply_norm(cfg, params["final_norm"], x)
    return _unembed(cfg, params, x)[:, 0], caches
