"""Public kernel entry points of the port, forward only.

Dispatch goes by where the tensor lies: a CPU tensor takes the plain
PyTorch version in ``ref``; a CUDA tensor launches the hand-written kernel,
or the call raises.  There is no fallback from one to the other.  The
backward of ``flash_attention`` belongs to the training slice.
"""

from __future__ import annotations

from typing import Dict

import torch

from repro_torch.kernels import flash_attention as _fa
from repro_torch.kernels import ref as _ref
from repro_torch.kernels import rmsnorm as _rn


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    causal: bool = True, window: int = 0, q_offset: int = 0) -> torch.Tensor:
    """(B,H,Sq,D) x (B,Kh,Skv,D)^2 -> (B,H,Sq,D); GQA via H//Kh groups."""
    if q.device.type == "cpu":
        return _ref.flash_attention_ref(q, k, v, causal, window, q_offset)
    return _fa.flash_attention_fwd(q, k, v, causal=causal, window=window, q_offset=q_offset)


def rmsnorm(x: torch.Tensor, w: torch.Tensor, eps: float = 1e-6) -> torch.Tensor:
    if x.device.type == "cpu":
        return _ref.rmsnorm_ref(x, w, eps)
    return _rn.rmsnorm(x, w, eps)


def launch_counts() -> Dict[str, int]:
    """Kernel launches in this process since the last reset."""
    return {"rmsnorm": _rn.launches, "flash_attention": _fa.launches}


def reset_launch_counts() -> None:
    _rn.launches = 0
    _fa.launches = 0
