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

import functools
from typing import Tuple

import torch
import torch.nn.functional as F
from torch.distributed.tensor import DTensor, Partial, Replicate, Shard

from repro_torch.models.common import Param, dense, f32_product, gelu
from repro_torch.sharding.regions import local_region
from repro_torch.tree import tree_map


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


def _top_k(logits: torch.Tensor, k: int):
    """(weights with zeros off the top-k, the 0/1 choices, probs), each (..., E)
    f32, from each token's router logits alone."""
    probs = torch.softmax(logits, dim=-1)
    topw, topi = torch.sort(probs, dim=-1, descending=True, stable=True)
    topw, topi = topw[..., :k], topi[..., :k]
    topw = topw / topw.sum(-1, keepdim=True).clamp(min=1e-9)
    weights = torch.zeros_like(probs).scatter(-1, topi, topw)  # the k experts differ
    return weights, torch.zeros_like(probs).scatter(-1, topi, 1.0), probs


def _route(cfg, p, x) -> Tuple[torch.Tensor, torch.Tensor]:
    """Router: (weights (B,S,E) f32 with zeros off the top-k, aux loss).

    The top-k comes from a stable descending sort: among equal
    probabilities the lower expert comes first, as ``jax.lax.top_k`` puts
    it (``torch.topk`` promises no order).  Ties are real in bf16, where the
    router's logits are rounded before the f32 softmax.  On a DTensor the
    sort and the scatters, which DTensor has no rule for, run on each
    device's tokens (``local_region``, the experts whole on every device): a
    token's routing reads its own logits only."""
    logits = dense(x, p["router"]).float()  # (B,S,E)
    if isinstance(logits, DTensor):
        places = [Replicate() if isinstance(q, Shard) and q.dim == 2 else q for q in logits.placements]
        fn = local_region(functools.partial(_top_k, k=cfg.top_k), (places,) * 3, (places,), logits.device_mesh)
        weights, chosen, probs = fn(logits)
    else:
        weights, chosen, probs = _top_k(logits, cfg.top_k)
    # Switch-style load-balancing auxiliary loss
    frac_tokens = chosen.mean(dim=(0, 1))  # (E,)
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


def _experts_dense(x, weights, wi, wg, wo, act: str):
    """The weighted sum over the experts wi/wg/wo (E, ...) hold, f32 (B, S, d):
    each expert's h weighted by the router first (the weights rounded to h's
    type), then one f32 contraction over the experts and d_ff."""
    B, S, d = x.shape
    E, f = wi.shape[0], wi.shape[-1]
    xt = x.reshape(B * S, d)
    wt = weights.reshape(B * S, E).to(x.dtype)
    ex = {"wi": wi, "wg": wg}
    hw = x.new_empty((B * S, E, f))
    for e in range(E):
        hw[:, e] = _expert_h(ex, e, xt, act) * wt[:, e : e + 1]
    return f32_product(hw.reshape(B * S, E * f), wo.reshape(E * f, d)).reshape(B, S, d)


def _experts_sharded(cfg, x, weights, wi, wg, wo):
    """``_experts_dense`` on each device's tokens and its block of the
    experts (``local_region``): the experts split over the model axis where
    ``partitioning`` splits them (expert parallelism), else their d_ff; the
    weights whole along d_model (FSDP gathers them).  The sum over experts
    and d_ff then spans the split: an f32 partial sum, reduced after."""
    mesh = x.device_mesh
    xp = [q if q == Shard(0) else Replicate() for q in x.placements]

    def per_mesh_dim(px, pw):  # (wi and wg, wo, the router's weights, the result)
        if px == Shard(0):  # a batch axis: the tokens split, the weights whole
            return Replicate(), Replicate(), Shard(0), Shard(0)
        if pw == Shard(0):  # the experts split (expert parallelism)
            return Shard(0), Shard(0), Shard(2), Partial()
        if pw == Shard(2):  # each expert's d_ff split
            return Shard(2), Shard(1), Replicate(), Partial()
        return (Replicate(),) * 4  # d_model's FSDP split gathered

    w_in, w_out, wts, out = zip(*map(per_mesh_dim, xp, wi.placements))
    fn = local_region(functools.partial(_experts_dense, act=cfg.act), list(out), (xp, wts, w_in, w_in, w_out), mesh)
    y = fn(x, weights, wi, wg, wo)
    return y.redistribute(mesh, [Replicate() if q.is_partial() else q for q in y.placements])


def moe_fwd(cfg, p, x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Dense-dispatch MoE: out = sum_e w_e * FFN_e(x).  (B,S,d) -> same, and aux.

    Combine before reduce, as the JAX package does: each expert's h is
    weighted by the router first (the weights rounded to h's type), and the
    sum over experts and d_ff is one f32 contraction, (T, E*f) @ (E*f, d)."""
    weights, aux = _route(cfg, p, x)
    ex = p["experts"]
    wg = ex.get("wg", ex["wi"])  # the gelu experts have no wg
    if isinstance(x, DTensor):
        out = _experts_sharded(cfg, x, weights, ex["wi"], wg, ex["wo"])
    else:
        out = _experts_dense(x, weights, ex["wi"], wg, ex["wo"], cfg.act)
    out = out.to(x.dtype)
    if cfg.shared_expert:
        out = out + ffn_fwd(cfg, p["shared"], x)
    return out, aux


def moe_fwd_dropping(cfg, p, x: torch.Tensor, capacity_factor: float = 1.25):
    """Gather-based dispatch with a capacity per expert: FLOPs proportional
    to the active parameters; tokens over capacity drop to the residual
    stream.  Queue positions follow the flattened (B*S) token order.  On a
    DTensor the queues span every token, which DTensor's cumsum, scatter
    and gathers have no rule for: the dispatch runs replicated
    on every device over the gathered tokens, router and experts, and the
    gathers are the collectives it costs."""
    if isinstance(x, DTensor):
        mesh = x.device_mesh
        whole = [Replicate()] * mesh.ndim
        local = lambda t: t.redistribute(mesh, whole).to_local()
        out, aux = moe_fwd_dropping(cfg, tree_map(local, p), local(x), capacity_factor)
        return (DTensor.from_local(out, mesh, whole, run_check=False),
                DTensor.from_local(aux, mesh, whole, run_check=False))
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
