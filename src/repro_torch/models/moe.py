"""Feed-forward block: the plain SwiGLU FFN of ``repro.models.moe``.

The mixture-of-experts dispatch and the gelu FFN are later slices.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.models.common import Param, dense


def _check_swiglu(cfg) -> None:
    if cfg.act != "swiglu":
        raise NotImplementedError(f"act {cfg.act!r}: the port runs the SwiGLU FFN only so far")


def ffn_skel(cfg):
    _check_swiglu(cfg)
    d, f = cfg.d_model, cfg.d_ff
    return {
        "wi": Param((d, f), ("embed", "mlp")),
        "wg": Param((d, f), ("embed", "mlp")),
        "wo": Param((f, d), ("mlp", "embed")),
    }


def ffn_fwd(cfg, p, x: torch.Tensor) -> torch.Tensor:
    _check_swiglu(cfg)
    h = F.silu(dense(x, p["wg"]).float()).to(x.dtype) * dense(x, p["wi"])
    return dense(h, p["wo"])
