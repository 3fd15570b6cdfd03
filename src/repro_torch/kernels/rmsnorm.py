"""Wrapper of the hand-written CUDA RMSNorm kernel (``csrc/rmsnorm.cu``).

Counterpart of ``repro.kernels.rmsnorm``.  Takes CUDA tensors only; the
plain version for CPU tensors is ``ref.rmsnorm_ref`` (see ``ops``).
"""

from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import _build

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}

# Launches of the kernel in this process; ``ops.reset_launch_counts`` zeroes it.
launches = 0


# rmsnorm_fwd(x, w, y, rows, d, eps, x_dtype, w_dtype, stream) in csrc/rmsnorm.cu
ARGTYPES = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_longlong,
            ctypes.c_int, ctypes.c_float, ctypes.c_int, ctypes.c_int, ctypes.c_void_p]


def _fn():
    fn = _build.load("rmsnorm").rmsnorm_fwd
    fn.argtypes = ARGTYPES
    fn.restype = ctypes.c_int
    return fn


def rmsnorm(x: torch.Tensor, w: torch.Tensor, eps: float = 1e-6) -> torch.Tensor:
    """``x * rsqrt(mean(x^2) + eps) * (1 + w)`` over the last dim of x (..., d)."""
    global launches
    if x.device.type != "cuda" or w.device != x.device:
        raise ValueError(f"rmsnorm kernel takes CUDA tensors on one device, got {x.device} and {w.device}")
    if x.dtype not in _DTYPES or w.dtype not in _DTYPES:
        raise TypeError(f"rmsnorm kernel takes float32 or bfloat16, got {x.dtype} and {w.dtype}")
    if x.dim() < 1 or w.shape != (x.shape[-1],):
        raise ValueError(f"rmsnorm kernel needs x (..., d) and w (d,), got {tuple(x.shape)} and {tuple(w.shape)}")
    if not (x.is_contiguous() and w.is_contiguous()):
        raise ValueError("rmsnorm kernel takes contiguous tensors")
    d = x.shape[-1]
    rows = x.numel() // d if d else 0
    if rows >= 2**31 - 1:
        raise ValueError(f"rmsnorm kernel: {rows} rows exceed the grid")
    out = torch.empty_like(x)
    fn = _fn()
    stream = torch.cuda.current_stream(x.device).cuda_stream
    err = fn(x.data_ptr(), w.data_ptr(), out.data_ptr(), rows, d, float(eps),
             _DTYPES[x.dtype], _DTYPES[w.dtype], stream)
    if err != 0:
        raise RuntimeError(f"rmsnorm kernel launch failed: cudaError {err}")
    launches += 1
    return out
