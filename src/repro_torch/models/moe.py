"""Feed-forward blocks (port of ``repro.models.moe``): the SwiGLU or tanh-GELU
FFN and the mixture of experts, top-k routing with the Switch auxiliary loss,
and its two dispatch modes under ``MOE_MODE``: "dense" (every expert computes
every token and the router's weights combine them) and "dropping" (each
expert gathers at most a capacity of tokens; the rest drop to the residual
stream).

The experts' products ask for an f32 result as the JAX package's einsums do
(``preferred_element_type=float32``): ``common.f32_product`` of 2-D operands,
one expert at a time.  An expert's products involve no other expert, so the
loop adds nothing in another order, and it keeps one expert's f32 (tokens,
d_ff) pair live instead of all of them.

The two activations round in different places, as the JAX package's do: the
plain gelu FFN takes gelu of ``dense``'s result (rounded to x's type) and
rounds again, while an expert's gelu runs on the f32 product.
"""

from __future__ import annotations

from typing import Tuple

import torch
import torch.nn.functional as F

from repro_torch.models.common import Param, dense, f32_product, gelu


def ffn_skel(cfg, expert_dim: int = 0):
    """The FFN, SwiGLU (wi, wg, wo) or gelu (wi, wo); with ``expert_dim`` > 0
    each weight gets a leading expert axis."""
    d, f = cfg.d_model, cfg.d_ff
    e = (expert_dim,) if expert_dim else ()
    ax = ("expert",) if expert_dim else ()
    s = {"wi": Param(e + (d, f), ax + ("embed", "mlp"))}
    if cfg.act == "swiglu":
        s["wg"] = Param(e + (d, f), ax + ("embed", "mlp"))
    s["wo"] = Param(e + (f, d), ax + ("mlp", "embed"))
    return s


def ffn_fwd(cfg, p, x: torch.Tensor) -> torch.Tensor:
    if cfg.act == "swiglu":
        h = F.silu(dense(x, p["wg"]).float()).to(x.dtype) * dense(x, p["wi"])
    else:
        h = gelu(dense(x, p["wi"]).float()).to(x.dtype)
    return dense(h, p["wo"])


# Dispatch mode, as the JAX package's: "dense" or "dropping".
MOE_MODE = ["dense"]


def set_moe_mode(mode: str) -> None:
    if mode not in ("dense", "dropping"):
        raise ValueError(f"MoE mode {mode!r}: one of 'dense', 'dropping'")
    MOE_MODE[0] = mode


def moe_skel(cfg):
    s = {
        "router": Param((cfg.d_model, cfg.num_experts), ("embed", None), scale=0.1),
        "experts": ffn_skel(cfg, expert_dim=cfg.num_experts),
    }
    if cfg.shared_expert:
        s["shared"] = ffn_skel(cfg)
    return s


def _route(cfg, p, x) -> Tuple[torch.Tensor, torch.Tensor]:
    """Router: (weights (B,S,E) f32 with zeros off the top-k, aux loss).

    The top-k comes from a stable descending sort: among equal
    probabilities the lower expert comes first, as ``jax.lax.top_k`` puts
    it (``torch.topk`` promises no order).  Ties are real in bf16, where the
    router's logits are rounded before the f32 softmax."""
    logits = dense(x, p["router"]).float()  # (B,S,E)
    probs = torch.softmax(logits, dim=-1)
    topw, topi = torch.sort(probs, dim=-1, descending=True, stable=True)
    topw, topi = topw[..., : cfg.top_k], topi[..., : cfg.top_k]
    topw = topw / topw.sum(-1, keepdim=True).clamp(min=1e-9)
    weights = torch.zeros_like(probs).scatter(-1, topi, topw)  # the k experts differ
    # Switch-style load-balancing auxiliary loss
    frac_tokens = torch.zeros_like(probs).scatter(-1, topi, 1.0).mean(dim=(0, 1))  # (E,)
    frac_probs = probs.mean(dim=(0, 1))
    aux = cfg.num_experts * torch.sum(frac_tokens * frac_probs)
    return weights, aux


def _expert_h(ex, e: int, xt: torch.Tensor, act: str) -> torch.Tensor:
    """``silu(g) * h`` (or ``gelu(h)``) of expert ``e`` on tokens xt (n, d):
    f32 products, rounded to xt's type after the activation, as the JAX
    package does."""
    h = f32_product(xt, ex["wi"][e])
    if act == "swiglu":
        return (F.silu(f32_product(xt, ex["wg"][e])) * h).to(xt.dtype)
    return gelu(h).to(xt.dtype)


def moe_fwd(cfg, p, x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Dense-dispatch MoE: out = sum_e w_e * FFN_e(x).  (B,S,d) -> same, and aux.

    Combine before reduce, as the JAX package does: each expert's h is
    weighted by the router first (the weights rounded to h's type), and the
    sum over experts and d_ff is one f32 contraction, (T, E*f) @ (E*f, d)."""
    weights, aux = _route(cfg, p, x)
    B, S, d = x.shape
    E, f = cfg.num_experts, cfg.d_ff
    ex = p["experts"]
    xt = x.reshape(B * S, d)
    wt = weights.reshape(B * S, E).to(x.dtype)
    hw = x.new_empty((B * S, E, f))
    for e in range(E):
        hw[:, e] = _expert_h(ex, e, xt, cfg.act) * wt[:, e : e + 1]
    out = f32_product(hw.reshape(B * S, E * f), ex["wo"].reshape(E * f, d))
    out = out.reshape(B, S, d).to(x.dtype)
    if cfg.shared_expert:
        out = out + ffn_fwd(cfg, p["shared"], x)
    return out, aux


def moe_fwd_dropping(cfg, p, x: torch.Tensor, capacity_factor: float = 1.25):
    """Gather-based dispatch with a capacity per expert: FLOPs proportional
    to the active parameters; tokens over capacity drop to the residual
    stream.  Queue positions follow the flattened (B*S) token order."""
    B, S, d = x.shape
    E, k = cfg.num_experts, cfg.top_k
    T = B * S
    weights, aux = _route(cfg, p, x)
    cap = int(capacity_factor * B * S * k / E) or 1
    flat_w = weights.reshape(T, E)
    sel = flat_w > 0
    pos_in_e = torch.cumsum(sel.long(), dim=0) - 1  # (T,E) position in each expert's queue
    keep = sel & (pos_in_e < cap)
    slot = torch.where(keep, pos_in_e, torch.full_like(pos_in_e, cap))  # cap: the drop bucket
    e_idx = torch.arange(E, device=x.device)[None, :].expand(T, E)
    flat_slot = (e_idx * (cap + 1) + slot).reshape(-1)
    # the token in each (expert, slot), a scatter-max into zeros: an empty
    # slot computes on token 0 and is never gathered
    t_idx = torch.arange(T, device=x.device)[:, None].expand(T, E).reshape(-1)
    token_for_slot = torch.zeros(E * (cap + 1), dtype=torch.long, device=x.device)
    token_for_slot.scatter_reduce_(0, flat_slot, t_idx, "amax", include_self=True)
    token_for_slot = token_for_slot.reshape(E, cap + 1)[:, :cap]
    xt = x.reshape(T, d)
    ex = p["experts"]
    y_pad = torch.zeros((E, cap + 1, d), dtype=torch.float32, device=x.device)
    for e in range(E):
        h = _expert_h(ex, e, xt[token_for_slot[e]], cfg.act)  # (cap, f)
        y_pad[e, :cap] = f32_product(h, ex["wo"][e])
    gathered = y_pad.reshape(E * (cap + 1), d)[flat_slot].reshape(T, E, d)
    w_slot = torch.where(keep, flat_w, torch.zeros_like(flat_w))
    out = torch.einsum("ted,te->td", gathered, w_slot.float())
    out = out.reshape(B, S, d).to(x.dtype)
    if cfg.shared_expert:
        out = out + ffn_fwd(cfg, p["shared"], x)
    return out, aux
