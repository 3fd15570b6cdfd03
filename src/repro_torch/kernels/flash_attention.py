"""Wrappers of the hand-written CUDA flash-attention forward kernels.

Counterpart of ``repro.kernels.flash_attention.flash_attention_fwd``.  Takes
CUDA tensors only; the plain version for CPU tensors is
``ref.flash_attention_ref`` (see ``ops``).  Unlike the Pallas kernel it needs
no tile divisibility and pads no head dim in device memory.

Two kernels, one route each, chosen by ``route(dtype, D)`` before the launch:

- ``"tc"``: bf16 with a head dim that is a multiple of 16 from 16 to 128
  (``TC_HEAD_DIMS``) runs on the tensor cores (``csrc/flash_attention_sm90.cu``:
  wgmma, TMA, P rounded to bf16 for the PV product as the JAX model's
  ``flash_ref`` does).  A head dim that is not a multiple of 64 is padded to
  one in shared memory only (design (a) in the source): TMA reads D columns
  and fills the rest with zeros, Q K^T runs D / 16 k-steps, and the store of O
  drops the padding.
- ``"cores"``: everything else, f32 at any head dim and bf16 at a head dim in
  (128, 256], runs the exact f32 kernel on the CUDA cores
  (``csrc/flash_attention.cu``).  f32 is held to 2e-5, which no bf16 or TF32
  product meets.

Both kernels can also write each query row's log-sum-exp of the scaled
scores (``return_lse=True``): f32 (B, H, Sq), natural-log units, ``+inf``
for a row with no visible key.  The train step's backward recomputes the
softmax from it (``ops.flash_attention``); the serve path does not ask for
it and its kernels skip the writes.

A launch that a route's kernel refuses raises; it never goes to the other.
"""

from __future__ import annotations

import ctypes
import functools
import math

import torch

from repro_torch.kernels import _build

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
BQ = 32  # query rows per block of the CUDA-core kernel, as kBQ in its source
TC_HEAD_DIMS = tuple(range(16, 129, 16))  # the instances of the tensor-core kernel

# Launches of each kernel in this process, and how many of them wrote the
# lse; ``ops.reset_launch_counts`` zeroes them.
launches_tc = 0
launches_cores = 0
lse_launches = 0


# flash_attention_fwd(q, k, v, o, lse, B, H, Kh, Sq, Skv, D, causal, window,
#                     q_offset, scale, dtype, stream) in csrc/flash_attention.cu;
# flash_attention_fwd_sm90(q, k, v, o, lse, B, H, Kh, Sq, Skv, D, causal, window,
#                          q_offset, scale, stream) in csrc/flash_attention_sm90.cu
ARGTYPES = {
    "flash_attention_fwd": [ctypes.c_void_p] * 5 + [ctypes.c_int] * 8 + [
        ctypes.c_longlong, ctypes.c_float, ctypes.c_int, ctypes.c_void_p],
    "flash_attention_fwd_sm90": [ctypes.c_void_p] * 5 + [ctypes.c_int] * 8 + [
        ctypes.c_longlong, ctypes.c_float, ctypes.c_void_p],
}
_LIBS = {"flash_attention_fwd": "flash_attention", "flash_attention_fwd_sm90": "flash_attention_sm90"}


def route(dtype: torch.dtype, head_dim: int) -> str:
    """``"tc"`` for bf16 with a head dim in ``TC_HEAD_DIMS``, else ``"cores"``."""
    return "tc" if dtype == torch.bfloat16 and head_dim in TC_HEAD_DIMS else "cores"


@functools.lru_cache(maxsize=None)
def _fn(name: str):
    fn = getattr(_build.load(_LIBS[name]), name)
    fn.argtypes = ARGTYPES[name]
    fn.restype = ctypes.c_int
    return fn


def flash_attention_fwd(
    q: torch.Tensor,  # (B, H, Sq, D)
    k: torch.Tensor,  # (B, Kh, Skv, D)
    v: torch.Tensor,  # (B, Kh, Skv, D)
    causal: bool = True,
    window: int = 0,
    q_offset: int = 0,
    return_lse: bool = False,
):
    """(B,H,Sq,D) x (B,Kh,Skv,D)^2 -> (B,H,Sq,D); q head h reads kv head h // (H/Kh).
    With ``return_lse`` the result is ``(out, lse)``, lse f32 (B, H, Sq)."""
    global launches_tc, launches_cores, lse_launches
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
    if not (q.is_contiguous() and k.is_contiguous() and v.is_contiguous()):
        raise ValueError("flash kernel takes contiguous tensors")
    tc = route(q.dtype, D) == "tc"
    if B * H * Sq >= 2**31 or Skv >= 2**31 or (not tc and (Sq + BQ - 1) // BQ > 65535):
        raise ValueError(f"flash kernel: B*H*Sq = {B * H * Sq} or Skv = {Skv} too large")
    if tc and any(t.data_ptr() % 16 for t in (q, k, v)):
        raise ValueError("tensor-core flash kernel: TMA needs q, k and v to start 16-byte aligned")
    out = torch.empty_like(q)
    lse = torch.empty((B, H, Sq), dtype=torch.float32, device=q.device) if return_lse else None
    stream = torch.cuda.current_stream(q.device).cuda_stream
    args = (q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
            None if lse is None else lse.data_ptr(), B, H, Kh, Sq, Skv, D,
            int(bool(causal)), int(window), int(q_offset), 1.0 / math.sqrt(D))
    if tc:
        err = _fn("flash_attention_fwd_sm90")(*args, stream)
    else:
        err = _fn("flash_attention_fwd")(*args, _DTYPES[q.dtype], stream)
    if err != 0:
        what = ("no cuTensorMapEncodeTiled in the driver" if err == -1 else
                f"tensor map refused, CUresult {-err - 1000}" if err <= -1000 else f"cudaError {err}")
        raise RuntimeError(f"flash kernel ({'tensor cores' if tc else 'CUDA cores'}) launch failed: {what}")
    if tc:
        launches_tc += 1
    else:
        launches_cores += 1
    if lse is not None:
        lse_launches += 1
    return (out, lse) if return_lse else out
