"""AdamW with f32 moments, global-norm clipping and a warmup + cosine
schedule (port of ``repro.optim.adamw``), as plain functions on trees of
tensors (``repro_torch.tree``).

The moments mirror the parameter tree leaf for leaf, in f32 whatever the
parameter's type; a new parameter is computed in f32 and rounded to the
parameter's type once.  ``adamw_update`` writes the new moments and
parameters into the tensors it is given, where the JAX package returns new
arrays (and its train step donates the old ones): the old and the new state
of a large model would not fit the card together.  The numbers are the same.
A leaf is updated CHUNK elements at a time, so that its f32 temporaries
take a few hundred MB, not several copies of the largest leaf (the
embedding of a full-width model is 3.1 GB in f32); every operation is
elementwise, so the numbers do not depend on the chunks.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Any, Dict

import torch

from repro_torch.tree import leaves, tree_map

# Elements of a leaf that one pass of the update takes at a time.
CHUNK = 1 << 26


@dataclasses.dataclass(frozen=True)
class AdamWConfig:
    lr: float = 3e-4
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    clip_norm: float = 1.0
    warmup_steps: int = 100
    total_steps: int = 10000
    min_lr_frac: float = 0.1


def schedule(cfg: AdamWConfig, step: torch.Tensor) -> torch.Tensor:
    """The learning rate at ``step`` (an integer tensor), f32: linear warmup
    over ``warmup_steps``, then a cosine down to ``min_lr_frac`` of ``lr``."""
    step = torch.as_tensor(step).to(torch.float32)
    warm = torch.clamp((step + 1) / max(1, cfg.warmup_steps), max=1.0)
    prog = torch.clamp((step - cfg.warmup_steps) / max(1, cfg.total_steps - cfg.warmup_steps), 0.0, 1.0)
    cos = 0.5 * (1 + torch.cos(math.pi * prog))
    frac = cfg.min_lr_frac + (1 - cfg.min_lr_frac) * cos
    return cfg.lr * warm * frac


def init_opt_state(params) -> Dict[str, Any]:
    """Zero f32 moments shaped like ``params``, and a step count of 0."""
    device = next(iter(leaves(params))).device
    zeros32 = lambda p: torch.zeros(p.shape, dtype=torch.float32, device=p.device)
    return {"m": tree_map(zeros32, params), "v": tree_map(zeros32, params),
            "count": torch.zeros((), dtype=torch.int32, device=device)}


def global_norm(tree) -> torch.Tensor:
    """sqrt of the sum of squares of every leaf, in f32."""
    return torch.sqrt(sum(torch.sum(torch.square(g.float())) for g in leaves(tree)))


def adamw_update(grads, opt_state, params, cfg: AdamWConfig):
    """Returns (new_params, new_opt_state, metrics): one AdamW step with the
    gradients clipped to a global norm of ``cfg.clip_norm``.  The moments and
    parameters are updated in place; the returned trees hold the same
    tensors, and a new count."""
    count = opt_state["count"] + 1
    gnorm = global_norm(grads)
    scale = torch.clamp(cfg.clip_norm / (gnorm + 1e-9), max=1.0)
    lr = schedule(cfg, count)
    c = count.to(torch.float32)
    b1c = 1 - torch.pow(torch.tensor(cfg.b1, dtype=torch.float32, device=c.device), c)
    b2c = 1 - torch.pow(torch.tensor(cfg.b2, dtype=torch.float32, device=c.device), c)

    # each line rounds as the JAX package's: m = b1 * m + (1 - b1) * g, ...
    for leaf in zip(leaves(grads), leaves(opt_state["m"]), leaves(opt_state["v"]), leaves(params)):
        flat = all(t.is_contiguous() for t in leaf)
        for g, m, v, p in zip(*(t.view(-1).split(CHUNK) for t in leaf)) if flat else [leaf]:
            g = g.float() * scale
            m.mul_(cfg.b1).add_((1 - cfg.b1) * g)
            v.mul_(cfg.b2).add_((1 - cfg.b2) * g * g)
            step = (m / b1c) / (torch.sqrt(v / b2c) + cfg.eps) + cfg.weight_decay * p.float()
            p.copy_(p.float() - lr * step)  # rounded to p's type once
    return params, {"m": opt_state["m"], "v": opt_state["v"], "count": count}, {"grad_norm": gnorm, "lr": lr}
