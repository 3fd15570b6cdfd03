"""Blockwise int8 gradient compression with error feedback (port of
``repro.optim.compression``), plain PyTorch on the tensor's device.

What the train step does with it (``train.step._pod_sync_fn``): each gradient
is quantized and dequantized before the cross-pod sync, and the f32/bf16
result is synced; no int8 payload crosses a link.  ``q`` equals the JAX
package's bit for bit: the same f32 division by the scale (not a product with
its reciprocal), the same ``+ 1e-12``, and ``torch.round`` rounds half to
even as ``jnp.round`` does.  Error feedback (``ef_sync``) keeps the long-run
sum of what was sent equal to the sum of the true gradients.
"""

from __future__ import annotations

from typing import Tuple

import torch
import torch.nn.functional as F

from repro_torch.tree import leaves, tree_map, unflatten_like

BLOCK = 256  # quantization block (per-block scale)


def quantize_int8(x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Blockwise symmetric int8 quantization.  Returns (q (blocks, BLOCK), scales (blocks,))."""
    flat = x.reshape(-1).float()
    pad = (-flat.numel()) % BLOCK
    if pad:
        flat = F.pad(flat, (0, pad))
    blocks = flat.reshape(-1, BLOCK)
    scale = blocks.abs().amax(dim=1, keepdim=True) / 127.0 + 1e-12
    q = torch.clamp(torch.round(blocks / scale), -127, 127).to(torch.int8)
    return q, scale[:, 0]


def dequantize_int8(q: torch.Tensor, scale: torch.Tensor, shape, dtype) -> torch.Tensor:
    flat = (q.float() * scale[:, None]).reshape(-1)
    n = 1
    for s in shape:
        n *= s
    return flat[:n].reshape(shape).to(dtype)


def compress_decompress(x: torch.Tensor) -> torch.Tensor:
    q, s = quantize_int8(x)
    return dequantize_int8(q, s, x.shape, x.dtype)


def ef_sync(grads, residuals, sync_fn):
    """Error-feedback compressed sync of a gradient tree: each leaf plus its
    f32 residual is compressed, ``sync_fn`` syncs the compressed tree, and the
    new residual is what compression dropped.  Returns (synced, new_residuals)."""
    flat_g, flat_e = list(leaves(grads)), list(leaves(residuals))
    if len(flat_g) != len(flat_e):
        raise ValueError(f"{len(flat_g)} gradients against {len(flat_e)} residuals")
    sent, new_res = [], []
    for g, e in zip(flat_g, flat_e):
        target = g.float() + e
        s = compress_decompress(target)
        new_res.append(target - s)
        sent.append(s.to(g.dtype))
    return sync_fn(unflatten_like(grads, sent)), unflatten_like(grads, new_res)


def init_residuals(params):
    return tree_map(lambda p: torch.zeros(p.shape, dtype=torch.float32, device=p.device), params)
