"""Public kernel entry points of the port, forward only.

Dispatch goes by where the tensor lies: a CPU tensor takes the plain
PyTorch version in ``ref``; a CUDA tensor launches the hand-written kernel,
or the call raises.  There is no fallback from one to the other.  The
backward of ``flash_attention`` belongs to the training slice.
"""

from __future__ import annotations

from typing import Dict, Optional

import torch

from repro_torch.kernels import chunk_reduce as _cr
from repro_torch.kernels import flash_attention as _fa
from repro_torch.kernels import ref as _ref
from repro_torch.kernels import rmsnorm as _rn


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    causal: bool = True, window: int = 0, q_offset: int = 0) -> torch.Tensor:
    """(B,H,Sq,D) x (B,Kh,Skv,D)^2 -> (B,H,Sq,D); GQA via H//Kh groups.  On the
    card the kernel follows ``flash_attention.route(dtype, D)``: bf16 with D
    64 or 128 on the tensor cores, the rest on the CUDA cores."""
    if q.device.type == "cpu":
        return _ref.flash_attention_ref(q, k, v, causal, window, q_offset)
    return _fa.flash_attention_fwd(q, k, v, causal=causal, window=window, q_offset=q_offset)


def rmsnorm(x: torch.Tensor, w: torch.Tensor, eps: float = 1e-6) -> torch.Tensor:
    if x.device.type == "cpu":
        return _ref.rmsnorm_ref(x, w, eps)
    return _rn.rmsnorm(x, w, eps)


def chunk_reduce(dst: torch.Tensor, src: torch.Tensor, alpha: float = 1.0,
                 out: Optional[torch.Tensor] = None) -> torch.Tensor:
    """``dst + alpha * src`` (f32 math, dst's type), into ``out`` when given;
    ``out`` may be ``dst``: the chain hop accumulates in place."""
    if dst.device.type == "cpu":
        res = _ref.chunk_reduce_ref(dst, src, alpha)
        return res if out is None else out.copy_(res)
    return _cr.chunk_reduce(dst, src, alpha, out=out)


def dequant_add(dst: torch.Tensor, q: torch.Tensor, scale: torch.Tensor, qblock: int = 256) -> torch.Tensor:
    """``dst + q * scale[block]``: an int8 block-quantized payload added to dst."""
    if dst.device.type == "cpu":
        return _ref.dequant_add_ref(dst, q, scale, qblock)
    return _cr.dequant_add(dst, q, scale, qblock)


def launch_counts() -> Dict[str, int]:
    """Kernel launches in this process since the last reset."""
    return {"rmsnorm": _rn.launches, "flash_attention_tc": _fa.launches_tc,
            "flash_attention_cores": _fa.launches_cores,
            "chunk_reduce": _cr.chunk_reduce_launches, "dequant_add": _cr.dequant_add_launches}


def reset_launch_counts() -> None:
    _rn.launches = 0
    _fa.launches_tc = 0
    _fa.launches_cores = 0
    _cr.chunk_reduce_launches = 0
    _cr.dequant_add_launches = 0
