"""Wrapper of the hand-written CUDA flash-attention forward (``csrc/flash_attention.cu``).

Counterpart of ``repro.kernels.flash_attention.flash_attention_fwd``.  Takes
CUDA tensors only; the plain version for CPU tensors is
``ref.flash_attention_ref`` (see ``ops``).  Unlike the Pallas kernel it needs
no tile divisibility and pads no head dim.
"""

from __future__ import annotations

import ctypes
import math

import torch

from repro_torch.kernels import _build

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
BQ = 32  # query rows per block, as kBQ in the source

# Launches of the kernel in this process; ``ops.reset_launch_counts`` zeroes it.
launches = 0


# flash_attention_fwd(q, k, v, o, B, H, Kh, Sq, Skv, D, causal, window, q_offset,
#                     scale, dtype, stream) in csrc/flash_attention.cu
ARGTYPES = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 8 + [
    ctypes.c_longlong, ctypes.c_float, ctypes.c_int, ctypes.c_void_p]


def _fn():
    fn = _build.load("flash_attention").flash_attention_fwd
    fn.argtypes = ARGTYPES
    fn.restype = ctypes.c_int
    return fn


def flash_attention_fwd(
    q: torch.Tensor,  # (B, H, Sq, D)
    k: torch.Tensor,  # (B, Kh, Skv, D)
    v: torch.Tensor,  # (B, Kh, Skv, D)
    causal: bool = True,
    window: int = 0,
    q_offset: int = 0,
) -> torch.Tensor:
    """(B,H,Sq,D) x (B,Kh,Skv,D)^2 -> (B,H,Sq,D); q head h reads kv head h // (H/Kh)."""
    global launches
    if q.device.type != "cuda" or k.device != q.device or v.device != q.device:
        raise ValueError(f"flash kernel takes CUDA tensors on one device, got {q.device}, {k.device}, {v.device}")
    if q.dtype not in _DTYPES or k.dtype != q.dtype or v.dtype != q.dtype:
        raise TypeError(f"flash kernel takes one type, float32 or bfloat16, got {q.dtype}, {k.dtype}, {v.dtype}")
    if q.dim() != 4 or k.dim() != 4 or k.shape != v.shape:
        raise ValueError(f"flash kernel needs q (B,H,Sq,D), k = v (B,Kh,Skv,D), got {tuple(q.shape)}, {tuple(k.shape)}, {tuple(v.shape)}")
    B, H, Sq, D = q.shape
    Kh, Skv = k.shape[1], k.shape[2]
    if k.shape[0] != B or k.shape[3] != D or Kh == 0 or H % Kh:
        raise ValueError(f"flash kernel: k/v {tuple(k.shape)} do not fit q {tuple(q.shape)}")
    if D % 16 or not 16 <= D <= 256:
        raise ValueError(f"flash kernel takes a head dim that is a multiple of 16 up to 256, got {D}")
    if B * H >= 2**31 or (Sq + BQ - 1) // BQ > 65535:
        raise ValueError(f"flash kernel: grid ({B * H}, {(Sq + BQ - 1) // BQ}) too large")
    if not (q.is_contiguous() and k.is_contiguous() and v.is_contiguous()):
        raise ValueError("flash kernel takes contiguous tensors")
    out = torch.empty_like(q)
    fn = _fn()
    stream = torch.cuda.current_stream(q.device).cuda_stream
    err = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), B, H, Kh, Sq, Skv, D,
             int(bool(causal)), int(window), int(q_offset), 1.0 / math.sqrt(D),
             _DTYPES[q.dtype], stream)
    if err != 0:
        raise RuntimeError(f"flash kernel launch failed: cudaError {err}")
    launches += 1
    return out
