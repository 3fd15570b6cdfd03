"""Parameter skeleton system + shared layer math (port of ``repro.models.common``).

Models are defined as *skeletons*: nested dicts (and lists) of ``Param``
descriptors (shape, dtype name, logical axes, initializer).  The port keeps
the JAX package's tree of names and its logical axis names, so a parameter
tree of one package maps leaf for leaf onto the other (``convert``).
"""

from __future__ import annotations

import dataclasses
import math
from typing import Any, Callable, Optional, Tuple

import numpy as np
import torch

from repro_torch.device import resolve_device
from repro_torch.kernels import ops


@dataclasses.dataclass(frozen=True)
class Param:
    shape: Tuple[int, ...]
    axes: Tuple[Optional[str], ...]
    init: str = "normal"  # normal | zeros | ones
    scale: float = 1.0
    dtype: str = "bfloat16"

    def __post_init__(self):
        assert len(self.shape) == len(self.axes), (self.shape, self.axes)


def is_param(x) -> bool:
    return isinstance(x, Param)


def tree_map_params(fn: Callable[[Param], Any], skel):
    """Apply ``fn`` to every ``Param`` of a skeleton of dicts and lists."""
    if is_param(skel):
        return fn(skel)
    if isinstance(skel, dict):
        return {k: tree_map_params(fn, v) for k, v in skel.items()}
    if isinstance(skel, (list, tuple)):
        return type(skel)(tree_map_params(fn, v) for v in skel)
    raise TypeError(f"unexpected skeleton node {type(skel).__name__}")


def init_params(skel, generator: torch.Generator, device=None, dtype_override=None):
    """Draw every parameter on ``device`` (the card unless ``"cpu"`` is asked for).

    The std rule is the JAX package's: ``scale / sqrt(shape[-2])`` (the fan-in);
    RMSNorm weights and LayerNorm biases zero, LayerNorm scales one.
    ``generator`` must live on the same device; its stream is not
    ``jax.random``'s, so the values differ from the JAX package's for the same
    seed (``convert.params_from_jax`` carries those across).
    """
    dev = resolve_device(device)

    def draw(p: Param) -> torch.Tensor:
        dtype = getattr(torch, dtype_override or p.dtype)
        if p.init == "zeros":
            return torch.zeros(p.shape, dtype=dtype, device=dev)
        if p.init == "ones":
            return torch.ones(p.shape, dtype=dtype, device=dev)
        fan_in = p.shape[-2] if len(p.shape) >= 2 else p.shape[-1]
        std = p.scale / math.sqrt(max(1, fan_in))
        # drawn in place in the target type: no f32 copy of a stacked leaf
        return torch.empty(p.shape, dtype=dtype, device=dev).normal_(0.0, std, generator=generator)

    return tree_map_params(draw, skel)


def _leaves_of(skel):
    if is_param(skel):
        yield skel
    elif isinstance(skel, dict):
        for v in skel.values():
            yield from _leaves_of(v)
    else:
        for v in skel:
            yield from _leaves_of(v)


def abstract_params(skel):
    """The skeleton as tensors on the ``meta`` device, each of its ``Param``'s
    shape and dtype: nothing is allocated (the JAX package's
    ``ShapeDtypeStruct`` tree)."""
    return tree_map_params(lambda p: torch.empty(p.shape, dtype=getattr(torch, p.dtype), device="meta"), skel)


def param_bytes(skel) -> int:
    """Bytes of every parameter in its skeleton dtype."""
    return sum(math.prod(p.shape) * getattr(torch, p.dtype).itemsize for p in _leaves_of(skel))


def param_elems(skel) -> int:
    return sum(math.prod(p.shape) for p in _leaves_of(skel))


# ---------------------------------------------------------------------------
# layer math (activations in cfg.dtype, reductions in f32)
# ---------------------------------------------------------------------------


def rmsnorm(x: torch.Tensor, w: torch.Tensor, eps: float = 1e-6) -> torch.Tensor:
    """``x * rsqrt(mean(x^2) + eps) * (1 + w)``: the RMSNorm kernel on the card."""
    return ops.rmsnorm(x, w, eps)


def layernorm(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor, eps: float = 1e-5) -> torch.Tensor:
    """``(x - mean) * rsqrt(var + eps) * w + b`` in f32 (the population
    variance, as ``jnp.var``), rounded once to x's type: ``F.layer_norm`` of
    the f32 upcast, on either device (the JAX package has no LayerNorm kernel)."""
    d = x.shape[-1]
    return torch.nn.functional.layer_norm(x.float(), (d,), w.float(), b.float(), eps).to(x.dtype)


def norm_skel(cfg):
    d = cfg.d_model
    if cfg.norm == "rmsnorm":
        return {"w": Param((d,), ("embed",), init="zeros")}
    return {"w": Param((d,), ("embed",), init="ones"), "b": Param((d,), ("embed",), init="zeros")}


def apply_norm(cfg, p, x):
    if cfg.norm == "rmsnorm":
        return rmsnorm(x, p["w"])
    return layernorm(x, p["w"], p["b"])


def dense(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """x @ w, out in x's type.  Mixed operands are promoted to the wider type
    before the product, as JAX's ``dot_general`` does (bf16 activations against
    an f32 weight multiply in f32; an f32 weight is never rounded to bf16).
    With one type on both sides nothing is copied: on the card bf16 x bf16 is
    one cuBLAS GEMM that accumulates in f32 and rounds the output to bf16, as
    the JAX package's f32-accumulated dot does."""
    dt = torch.promote_types(x.dtype, w.dtype)
    return torch.matmul(x.to(dt), w.to(dt)).to(x.dtype)


class _F32Product(torch.autograd.Function):
    """``a @ b`` of bf16 operands with cuBLAS's f32 output (``mm`` with
    ``out_dtype``), which has no derivative in torch.  Back, da and db are
    products of the same kind: the f32 cotangent rounded to bf16, bf16
    operands, f32 accumulation, each result rounded to its operand's type."""

    @staticmethod
    def forward(ctx, a, b):
        ctx.save_for_backward(a, b)
        return torch.mm(a, b, out_dtype=torch.float32)

    @staticmethod
    def backward(ctx, g):
        a, b = ctx.saved_tensors
        g = g.to(a.dtype)
        da = torch.mm(g, b.t(), out_dtype=torch.float32).to(a.dtype) if ctx.needs_input_grad[0] else None
        db = torch.mm(a.t(), g, out_dtype=torch.float32).to(b.dtype) if ctx.needs_input_grad[1] else None
        return da, db


def f32_product(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """``a @ b`` of 2-D operands with an f32 result, as the JAX package asks a
    dot for ``preferred_element_type=float32``: of bf16 operands on the card,
    cuBLAS's f32 output (through ``_F32Product`` for its gradient), which
    accumulates in f32 and never rounds the product to bf16; elsewhere, and
    where the types differ (JAX promotes both to f32), the product of the
    upcast operands."""
    if a.device.type == "cuda" and a.dtype == b.dtype == torch.bfloat16:
        return _F32Product.apply(a, b)
    return torch.mm(a.float(), b.float())


def gelu(x: torch.Tensor) -> torch.Tensor:
    """GELU, tanh approximation (``jax.nn.gelu(approximate=True)``)."""
    return torch.nn.functional.gelu(x, approximate="tanh")


# ---------------------------------------------------------------------------
# rotary embeddings (RoPE and Qwen2-VL M-RoPE)
# ---------------------------------------------------------------------------


def rope_freqs(head_dim: int, theta: float, device=None) -> torch.Tensor:
    exps = torch.arange(0, head_dim, 2, dtype=torch.float32, device=device) / head_dim
    return 1.0 / (theta ** exps)


def _rotate_by(x: torch.Tensor, angles: torch.Tensor) -> torch.Tensor:
    """x: (..., S, H, D) with its halves rotated by ``angles`` (..., S, D/2),
    in f32, rounded once to x's type."""
    cos = torch.cos(angles)[..., None, :]  # (..., S, 1, D/2)
    sin = torch.sin(angles)[..., None, :]
    x1, x2 = torch.chunk(x.float(), 2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    return out.to(x.dtype)


def apply_rope(x: torch.Tensor, positions: torch.Tensor, theta: float) -> torch.Tensor:
    """x: (..., S, H, D); positions: broadcastable to (..., S)."""
    freqs = rope_freqs(x.shape[-1], theta, device=x.device)  # (D/2,)
    return _rotate_by(x, positions[..., None].float() * freqs)


def apply_mrope(x: torch.Tensor, positions_3d: torch.Tensor, theta: float, sections) -> torch.Tensor:
    """Qwen2-VL multimodal RoPE.  x: (..., S, H, D); positions_3d: (3, ..., S),
    the temporal / height / width position ids (equal for text).  The D/2
    frequency bands split into ``sections``, band group i rotated by stream i."""
    d = x.shape[-1]
    half = d // 2
    if sum(sections) != half:
        raise ValueError(f"M-RoPE sections {tuple(sections)} do not sum to head_dim / 2 = {half}")
    freqs = rope_freqs(d, theta, device=x.device)  # (half,)
    sec_id = torch.tensor([i for i, n in enumerate(sections) for _ in range(n)], device=x.device)  # (half,)
    pos = torch.movedim(positions_3d[sec_id], 0, -1)  # (..., S, half)
    return _rotate_by(x, pos.float() * freqs)


def sinusoidal_positions(seq_len: int, d_model: int, device=None) -> torch.Tensor:
    """Whisper-style absolute sinusoidal embeddings (seq_len, d_model), f32:
    computed in numpy as the JAX package computes them, then rounded once."""
    pos = np.arange(seq_len)[:, None]
    dim = np.arange(d_model // 2)[None, :]
    inv = 1.0 / (10000 ** (dim / max(1, d_model // 2 - 1)))
    ang = pos * inv
    return torch.from_numpy(np.concatenate([np.sin(ang), np.cos(ang)], axis=-1)).to(device=device, dtype=torch.float32)
