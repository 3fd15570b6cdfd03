"""Wrappers of the hand-written CUDA chunk-accumulate kernels (``csrc/chunk_reduce.cu``).

Counterpart of ``repro.kernels.chunk_reduce``: ``chunk_reduce`` is the hop of
every reduce chain in ``core.collectives`` and every window of a SUM fold in
the data plane (``core.local``): ``out = dst + alpha * src``, f32 math, out
in dst's type, for f32, bf16 and f16; ``dequant_add`` (f32 and bf16) adds an int8 block-quantized payload
(``optim.compression``'s layout).  Both take CUDA tensors only; the plain
versions for CPU tensors are in ``ref`` (see ``ops``).  Neither pads: the
kernels mask the ragged tail.
"""

from __future__ import annotations

import ctypes
import functools
import threading
from typing import Optional

import torch

from repro_torch.kernels import _build

_DTYPES = {torch.float32: 0, torch.bfloat16: 1, torch.float16: 2}
_DEQUANT_DTYPES = (torch.float32, torch.bfloat16)
_count_lock = threading.Lock()  # the data plane launches from many threads

# Launches of each kernel in this process; ``ops.reset_launch_counts`` zeroes them.
chunk_reduce_launches = 0
dequant_add_launches = 0

# The extern "C" prototypes in csrc/chunk_reduce.cu:
#   chunk_reduce_fwd(dst, src, out, n, alpha, dtype, stream)
#   dequant_add_fwd(dst, q, scale, out, n, qblock, dtype, stream)
ARGTYPES = {
    "chunk_reduce_fwd": [ctypes.c_void_p] * 3 + [
        ctypes.c_longlong, ctypes.c_float, ctypes.c_int, ctypes.c_void_p],
    "dequant_add_fwd": [ctypes.c_void_p] * 4 + [
        ctypes.c_longlong, ctypes.c_int, ctypes.c_int, ctypes.c_void_p],
}


@functools.lru_cache(maxsize=None)
def _fn(name: str):
    fn = getattr(_build.load("chunk_reduce"), name)
    fn.argtypes = ARGTYPES[name]
    fn.restype = ctypes.c_int
    return fn


def _check_dst(dst: torch.Tensor, what: str, dtypes) -> None:
    if dst.device.type != "cuda":
        raise ValueError(f"{what} kernel takes CUDA tensors, got dst on {dst.device}")
    if dst.dtype not in dtypes:
        raise TypeError(f"{what} kernel takes a dst of {', '.join(map(str, dtypes))}, got {dst.dtype}")
    if not dst.is_contiguous():
        raise ValueError(f"{what} kernel takes contiguous tensors")


def chunk_reduce(dst: torch.Tensor, src: torch.Tensor, alpha: float = 1.0,
                 out: Optional[torch.Tensor] = None) -> torch.Tensor:
    """``dst + alpha * src`` in f32, in dst's type, written to ``out`` (which may be ``dst``)."""
    global chunk_reduce_launches
    _check_dst(dst, "chunk_reduce", tuple(_DTYPES))
    if src.device != dst.device or src.dtype != dst.dtype or src.shape != dst.shape:
        raise ValueError(f"chunk_reduce kernel: src ({src.dtype} {tuple(src.shape)} on {src.device}) "
                         f"must match dst ({dst.dtype} {tuple(dst.shape)} on {dst.device})")
    if out is None:
        out = torch.empty_like(dst)
    elif out.device != dst.device or out.dtype != dst.dtype or out.shape != dst.shape:
        raise ValueError(f"chunk_reduce kernel: out must match dst, got {out.dtype} {tuple(out.shape)} on {out.device}")
    if not (src.is_contiguous() and out.is_contiguous()):
        raise ValueError("chunk_reduce kernel takes contiguous tensors")
    stream = torch.cuda.current_stream(dst.device).cuda_stream
    err = _fn("chunk_reduce_fwd")(dst.data_ptr(), src.data_ptr(), out.data_ptr(), dst.numel(),
                                  float(alpha), _DTYPES[dst.dtype], stream)
    if err != 0:
        raise RuntimeError(f"chunk_reduce kernel launch failed: cudaError {err}")
    with _count_lock:
        chunk_reduce_launches += 1
    return out


def dequant_add(dst: torch.Tensor, q: torch.Tensor, scale: torch.Tensor, qblock: int = 256) -> torch.Tensor:
    """``dst + q * scale[block]`` in f32, in dst's type: q int8 flat, padded to a
    multiple of ``qblock`` and at least dst's size; one f32 scale per block."""
    global dequant_add_launches
    _check_dst(dst, "dequant_add", _DEQUANT_DTYPES)
    if q.device != dst.device or scale.device != dst.device:
        raise ValueError(f"dequant_add kernel takes CUDA tensors on one device, got {q.device} and {scale.device}")
    if q.dtype != torch.int8 or scale.dtype != torch.float32:
        raise TypeError(f"dequant_add kernel takes int8 q and float32 scale, got {q.dtype} and {scale.dtype}")
    if qblock <= 0 or q.numel() % qblock or q.numel() < dst.numel() or scale.numel() != q.numel() // qblock:
        raise ValueError(f"dequant_add kernel: q of {q.numel()} and {scale.numel()} scales do not fit "
                         f"dst of {dst.numel()} in blocks of {qblock}")
    if not (q.is_contiguous() and scale.is_contiguous()):
        raise ValueError("dequant_add kernel takes contiguous tensors")
    out = torch.empty_like(dst)
    stream = torch.cuda.current_stream(dst.device).cuda_stream
    err = _fn("dequant_add_fwd")(dst.data_ptr(), q.data_ptr(), scale.data_ptr(), out.data_ptr(),
                                 dst.numel(), int(qblock), _DTYPES[dst.dtype], stream)
    if err != 0:
        raise RuntimeError(f"dequant_add kernel launch failed: cudaError {err}")
    dequant_add_launches += 1
    return out
