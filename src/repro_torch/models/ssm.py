"""State-space blocks: Mamba (Jamba's mixer) and RWKV-6 ("Finch") (port of
``repro.models.ssm``).

Both are linear-state recurrences.  The JAX package runs them as
``lax.scan`` over time; the port runs a Python loop over time in f32
(``chunked_scan``), one step at a time.  Each Mamba step forms its own
(B, di, N) discretisation (dA, dBx), as the JAX scan body does, so the
(B, S, di, N) tensors are never built.  Under autograd each chunk of steps
is recomputed in the backward (``torch.utils.checkpoint``), as the JAX
package wraps its inner scan in ``jax.checkpoint``: only the state at chunk
boundaries is kept.  Decode carries O(1) state per layer.

Shapes use (B, S, d) activations; states are dicts of tensors, which the
model threads as it threads KV caches.

On DTensors each scan is a ``local_region`` (``sharding.regions``): the
recurrence runs on each device's local block, in the same Python loop, with
the batch split as the activations split it and the channels (Mamba) or
heads (RWKV-6) split over the model axis as the parameters place them.  Every
step of the recurrence is elementwise in those dims, so nothing crosses a
device inside a scan.
"""

from __future__ import annotations

from typing import Dict

import torch
import torch.nn.functional as F
from torch.distributed.tensor import DTensor, Replicate, Shard
from torch.utils.checkpoint import checkpoint

from repro_torch.models.common import Param, dense
from repro_torch.sharding.regions import local_region


def _scan(step, h, *xs):
    """``step`` over the leading (time) axis of ``xs``: (final h, stacked ys)."""
    ys = []
    for t in range(xs[0].shape[0]):
        h, y = step(h, tuple(x[t] for x in xs))
        ys.append(y)
    return h, torch.stack(ys)


def _ref_places(batch_src, chan_src, chan_dim: int):
    """A scan's split, per mesh dim, of its (B, S, C) activations: the batch
    where ``batch_src`` splits its dim 0, else the channels (or heads, dim 2)
    where the parameter ``chan_src`` splits its dim ``chan_dim``, else none."""
    out = []
    for pb, pc in zip(batch_src.placements, chan_src.placements):
        out.append(Shard(0) if pb == Shard(0) else Shard(2) if pc == Shard(chan_dim) else Replicate())
    return tuple(out)


def _scan_region(scan, ref_places, mesh, layout, *args):
    """``scan(*args)`` on each device's blocks (a ``local_region``) under
    ``ref_places`` (``_ref_places``), or as it is when ``ref_places`` is None.
    ``layout``: for each argument, then each output, its dims that carry the
    batch (0) and the channels (2) of the (B, S, C) activations, None where
    it has none; a non-tensor argument's entry is None.  A plain tensor
    argument (a fresh zero state) is the same on every device."""
    if ref_places is None:
        return scan(*args)

    def places(dims):
        out = []
        for p in ref_places:
            d = dims[(0, 2).index(p.dim)] if isinstance(p, Shard) else None
            out.append(Replicate() if d is None else Shard(d))
        return tuple(out)

    pl = [None if dims is None else places(dims) for dims in layout]
    whole = [Replicate()] * mesh.ndim
    args = [DTensor.from_local(a, mesh, whole, run_check=False)
            if isinstance(a, torch.Tensor) and not isinstance(a, DTensor) else a for a in args]
    n = len(args)
    return local_region(scan, tuple(pl[n:]), tuple(pl[:n]), mesh)(*args)


def chunked_scan(step, init, xs, seq_len: int, chunk: int = 128):
    """A scan of ``step(h, x_t) -> (h, y_t)`` over time-major ``xs`` (a tuple of
    (S, ...) tensors): (the final state, the (S, ...) outputs).  The steps run
    in chunks of ``chunk`` (halved until it divides ``seq_len``); with
    gradients on, each chunk is recomputed in the backward, so autograd keeps
    the state at chunk boundaries only."""
    while seq_len % chunk:
        chunk //= 2
    h, ys = init, []
    for c in range(0, seq_len, chunk):
        xc = tuple(x[c : c + chunk] for x in xs)
        if torch.is_grad_enabled():
            h, yc = checkpoint(_scan, step, h, *xc, use_reentrant=False)
        else:
            h, yc = _scan(step, h, *xc)
        ys.append(yc)
    return h, torch.cat(ys)


# ---------------------------------------------------------------------------
# Mamba (selective SSM, as interleaved in Jamba)
# ---------------------------------------------------------------------------


def mamba_skel(cfg):
    d = cfg.d_model
    di = cfg.ssm_expand * d
    N = cfg.ssm_state_dim
    dt_rank = max(1, d // 16)
    return {
        "in_proj": Param((d, 2 * di), ("embed", "ssm")),
        "conv_w": Param((cfg.ssm_conv_width, di), (None, "ssm"), scale=0.5),
        "conv_b": Param((di,), ("ssm",), init="zeros"),
        "x_proj": Param((di, dt_rank + 2 * N), ("ssm", None)),
        "dt_w": Param((dt_rank, di), (None, "ssm")),
        "dt_b": Param((di,), ("ssm",), init="zeros"),
        "A_log": Param((di, N), ("ssm", None), init="ones"),
        "D": Param((di,), ("ssm",), init="ones"),
        "out_proj": Param((di, d), ("ssm", "embed")),
    }


def _selective_scan(delta, Bm, Cm, x, A, h, single_step: bool):
    """h_t = exp(delta_t A) h_{t-1} + delta_t B_t x_t and y_t = h_t C_t, in f32.
    delta, x: (B, S, di); Bm, Cm: (B, S, N); A: (di, N); h: (B, di, N).
    Returns (ys (B, S, di), the final h)."""

    def step(h, inp):
        delta_t, B_t, C_t, x_t = inp  # (B,di), (B,N), (B,N), (B,di)
        dA_t = torch.exp(delta_t[..., None] * A)  # (B,di,N)
        dBx_t = delta_t[..., None] * B_t[:, None, :] * x_t[..., None]
        h = dA_t * h + dBx_t
        return h, (h * C_t[:, None, :]).sum(-1)  # (B,di)

    if single_step:
        h, y = step(h, (delta[:, 0], Bm[:, 0], Cm[:, 0], x[:, 0]))
        return y[:, None], h
    xs = tuple(t.transpose(0, 1).contiguous() for t in (delta, Bm, Cm, x))
    h, ys = chunked_scan(step, h, xs, delta.shape[1])
    return ys.transpose(0, 1), h


def _mamba_core(cfg, p, xz, conv_state, ssm_state, *, single_step: bool):
    """The selective-scan core shared by forward, prefill and decode.

    xz: (B, S, 2*di).  conv_state: (B, W-1, di).  ssm_state: (B, di, N).
    Returns (y (B, S, di) in xz's type, the new conv_state, the new ssm_state).
    The causal conv runs in x's type, its taps summed in order from 0 and the
    bias added last, each product and sum rounded as the JAX package rounds
    them; the conv state is the last W-1 rows before the conv."""
    d = cfg.d_model
    N = cfg.ssm_state_dim
    W = cfg.ssm_conv_width
    dt_rank = max(1, d // 16)
    x, z = xz.chunk(2, dim=-1)  # (B,S,di) each
    S = x.shape[1]

    # causal depthwise conv over time (width W)
    xpad = torch.cat([conv_state.to(x.dtype), x], dim=1)  # (B, S+W-1, di)
    new_conv_state = xpad[:, -(W - 1):] if W > 1 else conv_state
    conv = 0
    for i in range(W):
        conv = conv + xpad[:, i : i + S] * p["conv_w"][i]
    conv = conv + p["conv_b"]
    x = F.silu(conv.float()).to(x.dtype)

    proj = dense(x, p["x_proj"])  # (B,S,dt_rank+2N)
    dt, Bm, Cm = torch.split(proj, [dt_rank, N, N], dim=-1)
    delta = F.softplus(dense(dt, p["dt_w"]).float() + p["dt_b"].float())  # (B,S,di)
    A = -torch.exp(p["A_log"].float())  # (di,N)
    places = _ref_places(x, p["A_log"], 0) if isinstance(x, DTensor) else None
    # delta, Bm, Cm, x, A, h, single_step -> ys, h
    layout = ((0, 2), (0, None), (0, None), (0, 2), (None, 0), (0, 1), None, (0, 2), (0, 1))
    ys, new_ssm_state = _scan_region(_selective_scan, places, getattr(x, "device_mesh", None), layout, delta,
                                     Bm.float(), Cm.float(), x.float(), A, ssm_state, single_step)
    y = ys + x.float() * p["D"].float()
    y = (y * F.silu(z.float())).to(xz.dtype)
    return y, new_conv_state, new_ssm_state


def mamba_init_state(cfg, batch: int, dtype=torch.float32, device=None) -> Dict[str, torch.Tensor]:
    di = cfg.ssm_expand * cfg.d_model
    return {
        "conv": torch.zeros((batch, cfg.ssm_conv_width - 1, di), dtype=dtype, device=device),
        "ssm": torch.zeros((batch, di, cfg.ssm_state_dim), dtype=torch.float32, device=device),
    }


def mamba_fwd(cfg, p, x):
    """Training/prefill forward (fresh state)."""
    xz = dense(x, p["in_proj"])
    st = mamba_init_state(cfg, x.shape[0], x.dtype, x.device)
    y, _, _ = _mamba_core(cfg, p, xz, st["conv"], st["ssm"], single_step=False)
    return dense(y, p["out_proj"])


def mamba_prefill(cfg, p, x):
    """Prefill returning the state for subsequent decode."""
    xz = dense(x, p["in_proj"])
    st = mamba_init_state(cfg, x.shape[0], x.dtype, x.device)
    y, conv, ssm = _mamba_core(cfg, p, xz, st["conv"], st["ssm"], single_step=False)
    return dense(y, p["out_proj"]), {"conv": conv, "ssm": ssm}


def mamba_decode(cfg, p, x, state: Dict[str, torch.Tensor]):
    xz = dense(x, p["in_proj"])  # (B,1,2di)
    y, conv, ssm = _mamba_core(cfg, p, xz, state["conv"], state["ssm"], single_step=True)
    return dense(y, p["out_proj"]), {"conv": conv, "ssm": ssm}


# ---------------------------------------------------------------------------
# RWKV-6 (Finch): data-dependent decay WKV + channel mix
# ---------------------------------------------------------------------------


def rwkv_skel(cfg):
    d = cfg.d_model
    f = cfg.d_ff
    lora = 64
    return {
        "time": {
            "mu": Param((5, d), (None, "embed"), init="zeros"),  # r,k,v,w,g mixes
            "wr": Param((d, d), ("embed", "heads")),
            "wk": Param((d, d), ("embed", "heads")),
            "wv": Param((d, d), ("embed", "heads")),
            "wg": Param((d, d), ("embed", "heads")),
            "wo": Param((d, d), ("heads", "embed")),
            "w0": Param((d,), ("embed",), init="zeros"),
            "w_lora_a": Param((d, lora), ("embed", None), scale=0.1),
            "w_lora_b": Param((lora, d), (None, "embed"), scale=0.1),
            "u": Param((d,), ("embed",), init="zeros"),
            "ln_w": Param((d,), ("embed",), init="ones"),  # per-head group norm
            "ln_b": Param((d,), ("embed",), init="zeros"),
        },
        "channel": {
            "mu": Param((2, d), (None, "embed"), init="zeros"),  # k,r mixes
            "wk": Param((d, f), ("embed", "mlp")),
            "wv": Param((f, d), ("mlp", "embed")),
            "wr": Param((d, d), ("embed", "heads")),
        },
    }


def _token_shift(x, prev):
    """shifted[t] = x[t-1]; shifted[0] = prev (carried across calls)."""
    return torch.cat([prev[:, None], x[:, :-1]], dim=1)


def _wkv6_scan(r, k, v, w, u, state, single_step: bool):
    """WKV-6 recurrence, f32.  r,k,v,w: (B,S,H,hs); u: (H,hs); state: (B,H,hs,hs).

    y_t = (S_t + diag(u) k_t v_t^T)^T r_t ;  S_{t+1} = diag(w_t) S_t + k_t v_t^T
    Returns (y (B,S,H,hs), the final state)."""

    def step(S, inp):
        r_t, k_t, v_t, w_t = inp  # (B,H,hs) each
        kv = k_t[..., :, None] * v_t[..., None, :]  # (B,H,hs,hs)
        y = ((S + u[:, :, None] * kv) * r_t[..., :, None]).sum(-2)  # (B,H,hs): sum over i
        S = w_t[..., :, None] * S + kv
        return S, y

    if single_step:
        S, y = step(state, (r[:, 0], k[:, 0], v[:, 0], w[:, 0]))
        return y[:, None], S
    xs = tuple(t.transpose(0, 1).contiguous() for t in (r, k, v, w))
    S, ys = chunked_scan(step, state, xs, r.shape[1])
    return ys.transpose(0, 1), S


def rwkv_init_state(cfg, batch: int, dtype=torch.float32, device=None) -> Dict[str, torch.Tensor]:
    d = cfg.d_model
    hs = cfg.rwkv_head_size
    return {
        "shift_t": torch.zeros((batch, d), dtype=dtype, device=device),
        "shift_c": torch.zeros((batch, d), dtype=dtype, device=device),
        "wkv": torch.zeros((batch, d // hs, hs, hs), dtype=torch.float32, device=device),
    }


def _mix(x, xx, mu):
    """x + (xx - x) * sigmoid(mu), the gate in f32 rounded to x's type."""
    return x + (xx - x) * torch.sigmoid(mu.float()).to(x.dtype)


def _group_norm(y, w, b):
    """RWKV's per-head group norm of y (B, S, H, hs), f32: each head's
    ``(y - mean) * rsqrt(var + 64e-5)`` with the population variance (as
    ``jnp.var``; ``torch.var`` defaults to the unbiased one), then the (d,)
    scale and bias.  Returns (B, S, H * hs)."""
    mean = y.mean(-1, keepdim=True)
    var = y.var(-1, keepdim=True, correction=0)
    yf = (y - mean) * torch.rsqrt(var + 64e-5)
    return yf.flatten(2) * w.float() + b.float()


def _rwkv_time_mix(cfg, p, x, shift_prev, wkv_state, single_step):
    """Returns (output, the shift state (x's last row), the wkv state)."""
    d = cfg.d_model
    hs = cfg.rwkv_head_size
    H = d // hs
    B, S = x.shape[:2]
    xx = _token_shift(x, shift_prev)
    xr, xk, xv, xw, xg = (_mix(x, xx, p["mu"][i]) for i in range(5))
    r = dense(xr, p["wr"]).reshape(B, S, H, hs).float()
    k = dense(xk, p["wk"]).reshape(B, S, H, hs).float()
    v = dense(xv, p["wv"]).reshape(B, S, H, hs).float()
    g = F.silu(dense(xg, p["wg"]).float())
    # data-dependent decay (the Finch contribution): an f32 product
    w_dd = torch.tanh(dense(xw, p["w_lora_a"]).float())
    w_dd = torch.matmul(w_dd, p["w_lora_b"].float())
    w = torch.exp(-torch.exp(p["w0"].float() + w_dd))  # (B,S,d) in (0,1)
    w = w.reshape(B, S, H, hs)
    u = p["u"].float().reshape(H, hs)
    places = _ref_places(r, p["wr"], 1) if isinstance(r, DTensor) else None
    # r, k, v, w, u, state, single_step -> y, state
    layout = ((0, 2), (0, 2), (0, 2), (0, 2), (None, 0), (0, 1), None, (0, 2), (0, 1))
    y, wkv_state = _scan_region(_wkv6_scan, places, getattr(r, "device_mesh", None), layout, r, k, v, w, u,
                                wkv_state, single_step)
    yf = _group_norm(y, p["ln_w"], p["ln_b"])
    out = dense((yf * g).to(x.dtype), p["wo"])
    return out, x[:, -1], wkv_state


def _rwkv_channel_mix(cfg, p, x, shift_prev):
    """The squared-ReLU channel mix: (output, the shift state (x's last row))."""
    xx = _token_shift(x, shift_prev)
    xk = _mix(x, xx, p["mu"][0])
    xr = _mix(x, xx, p["mu"][1])
    k = torch.square(torch.relu(dense(xk, p["wk"]).float())).to(x.dtype)
    r = torch.sigmoid(dense(xr, p["wr"]).float()).to(x.dtype)
    return r * dense(k, p["wv"]), x[:, -1]


def rwkv_fwd(cfg, p, x, norm_fn1, norm_fn2):
    """Full RWKV block (time mix + channel mix), training/prefill."""
    st = rwkv_init_state(cfg, x.shape[0], x.dtype, x.device)
    h, _, _ = _rwkv_time_mix(cfg, p["time"], norm_fn1(x), st["shift_t"], st["wkv"], False)
    x = x + h
    h, _ = _rwkv_channel_mix(cfg, p["channel"], norm_fn2(x), st["shift_c"])
    return x + h


def rwkv_prefill(cfg, p, x, norm_fn1, norm_fn2):
    """Forward and the state for decode: the shift states are the last rows
    of the normed inputs of the two mixes."""
    st = rwkv_init_state(cfg, x.shape[0], x.dtype, x.device)
    n1 = norm_fn1(x)
    h, shift_t, wkv = _rwkv_time_mix(cfg, p["time"], n1, st["shift_t"], st["wkv"], False)
    x = x + h
    n2 = norm_fn2(x)
    h, shift_c = _rwkv_channel_mix(cfg, p["channel"], n2, st["shift_c"])
    return x + h, {"shift_t": shift_t, "shift_c": shift_c, "wkv": wkv}


def rwkv_decode(cfg, p, x, state, norm_fn1, norm_fn2):
    n1 = norm_fn1(x)
    h, shift_t, wkv = _rwkv_time_mix(cfg, p["time"], n1, state["shift_t"], state["wkv"], True)
    x = x + h
    n2 = norm_fn2(x)
    h, shift_c = _rwkv_channel_mix(cfg, p["channel"], n2, state["shift_c"])
    return x + h, {"shift_t": shift_t, "shift_c": shift_c, "wkv": wkv}
