"""The arithmetic of the f32 flash kernel (csrc/flash_attention.cu), on the CPU.

The kernel runs each f32 product on the tensor cores as three TF32
products: every operand x is split into hi = rna_tf32(x) and
lo = rna_tf32(x - hi), and A.B is summed from lo_A.hi_B, hi_A.lo_B and
hi_A.hi_B in f32.  The CUDA kernel runs only on the card
(tests/test_torch_gpu.py); here a plain model of that arithmetic, written
below and not taken from the package, is held to the JAX package's flash
kernel (Pallas in interpret mode, as tests/test_kernels.py runs it) at
2e-5, the f32 tolerance of tests/test_kernels.py:16-17, at every head dim the
kernel takes, causal and windowed, output and lse; and one TF32 product
alone must miss 2e-5 on the same inputs, so the tolerance can see a
dropped correction term.  Also the route rule and the smoke's launch count
for its serve_f32 phase.
"""

import dataclasses
import importlib.util
import math
from pathlib import Path

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from repro.kernels import ops as jops
from repro.models import attention as jattn
from repro_torch.configs import get_config, reduced_config
from repro_torch.kernels import flash_attention as tfa
from repro_torch.kernels import ops as tops
from repro_torch.launch import serve as tserve
from repro_torch.models import common as tcommon
from repro_torch.models import transformer as TT
from repro_torch.serving import engine as tengine

ROOT = Path(__file__).resolve().parents[1]
TOL = dict(rtol=2e-5, atol=2e-5)
HEAD_DIMS = tuple(range(16, 257, 16))
# (B, H, Kh, S, causal, window): GQA, one Pallas block of 128 rows.
SHAPES = {"causal": (1, 4, 2, 128, True, 0), "window": (1, 4, 2, 128, True, 24)}


def rna_tf32(x: torch.Tensor) -> torch.Tensor:
    """f32 rounded to TF32 (10 mantissa bits), to nearest with ties away
    from zero, as ``cvt.rna.tf32.f32``: add half of the 13 dropped bits to
    the magnitude, then clear them (the sign bit is not reached)."""
    bits = x.contiguous().view(torch.int32)
    return ((bits + 0x1000) & ~0x1FFF).view(torch.float32)


def split(x: torch.Tensor):
    hi = rna_tf32(x)
    return hi, rna_tf32(x - hi)


def product3(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """a @ b from three TF32 products in f32: the two small ones summed
    apart, then added to hi.hi, as the kernel sums Q K^T."""
    ah, al = split(a)
    bh, bl = split(b)
    return ah @ bh + (al @ bh + ah @ bl)


def product1(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """a @ b from one TF32 product: what the tolerance must catch."""
    return rna_tf32(a) @ rna_tf32(b)


def flash_model(q, k, v, causal, window, product):
    """The kernel's function with every matrix product done by ``product``,
    the softmax in f32: (out, lse), lse = m * scale + log(l), +inf where a
    row sees no key, zeros there in out."""
    B, H, S, D = q.shape
    G = H // k.shape[1]
    kf, vf = k.repeat_interleave(G, dim=1), v.repeat_interleave(G, dim=1)
    scale = 1.0 / math.sqrt(D)
    s = product(q, kf.transpose(-1, -2))
    pos = torch.arange(S)
    mask = torch.ones(S, S, dtype=torch.bool)
    if causal:
        mask &= pos[None, :] <= pos[:, None]
    if window:
        mask &= (pos[:, None] - pos[None, :]) < window
    s = torch.where(mask, s, -torch.inf)
    m = s.amax(-1, keepdim=True)
    p = torch.exp((s - m) * scale)
    l = p.sum(-1, keepdim=True)
    out = product(p, vf) / l
    return out, (m * scale + torch.log(l))[..., 0]


def inputs(B, H, Kh, S, D, seed):
    """q of std 2 and k, v of std 1 (tests/test_torch_gpu.py's ``_qkv``):
    the scaled scores have a std of 2, so the softmax is far from uniform."""
    rng = np.random.RandomState(seed)
    q = (rng.randn(B, H, S, D) * 2).astype(np.float32)
    k = rng.randn(B, Kh, S, D).astype(np.float32)
    v = rng.randn(B, Kh, S, D).astype(np.float32)
    return q, k, v


def jax_flash(q, k, v, causal, window):
    """The JAX package's flash forward (Pallas, interpret mode) and the lse
    its backward saves (``_flash_fwd_impl``: m + log(l))."""
    B, H, S, D = q.shape
    Kh = k.shape[1]
    jq, jk, jv = jnp.asarray(q), jnp.asarray(k), jnp.asarray(v)
    out = np.asarray(jops.flash_attention(jq, jk, jv, causal, window, 0))
    pos = jnp.arange(S, dtype=jnp.int32)
    _, lse = jattn._flash_fwd_impl(jq.reshape(B, Kh, H // Kh, S, D), jk, jv, pos, pos, causal, window)
    return out, np.asarray(lse).reshape(B, H, S)


@pytest.mark.parametrize("D", HEAD_DIMS)
@pytest.mark.parametrize("mask", sorted(SHAPES))
def test_three_tf32_products_meet_the_f32_tolerance(mask, D):
    """Three TF32 products hold the JAX kernel's output and lse to 2e-5 at
    every head dim; one TF32 product misses 2e-5 on the same inputs."""
    B, H, Kh, S, causal, window = SHAPES[mask]
    q, k, v = inputs(B, H, Kh, S, D, seed=D)
    want, want_lse = jax_flash(q, k, v, causal, window)
    tq, tk, tv = (torch.from_numpy(a) for a in (q, k, v))
    got, lse = flash_model(tq, tk, tv, causal, window, product3)
    np.testing.assert_allclose(got.numpy(), want, **TOL)
    np.testing.assert_allclose(lse.numpy(), want_lse, rtol=0, atol=2e-5)
    one, one_lse = flash_model(tq, tk, tv, causal, window, product1)
    assert not np.allclose(one.numpy(), want, **TOL)
    assert not np.allclose(one_lse.numpy(), want_lse, rtol=0, atol=2e-5)


def test_rna_tf32_rounds_to_nearest_ties_away():
    """10 mantissa bits kept; halfway cases go away from zero, on either
    sign; exact TF32 values and zero stay; x - hi is exact, and the split
    leaves at most 2^-22 of |x| behind."""
    ulp = 2.0 ** -10  # TF32's spacing in [1, 2); 2^-9 in [2, 4)
    x = torch.tensor([1.0, 1 + ulp / 2, 1 + ulp / 4, 1 + 3 * ulp / 4, -(1 + ulp / 2), 3 + ulp, 2 - ulp / 2,
                      0.0, -0.0], dtype=torch.float32)
    want = torch.tensor([1.0, 1 + ulp, 1.0, 1 + ulp, -(1 + ulp), 3 + 2 * ulp, 2.0, 0.0, -0.0],
                        dtype=torch.float32)
    got = rna_tf32(x)
    assert torch.equal(got.view(torch.int32), want.view(torch.int32))  # -0.0 keeps its sign
    r = torch.from_numpy(np.random.RandomState(0).randn(100_000).astype(np.float32)) * 1e3
    hi, lo = split(r)
    assert torch.equal((r.double() - hi.double()).float(), r - hi)
    assert ((r.double() - hi.double() - lo.double()).abs() <= 2.0 ** -22 * r.double().abs()).all()


@pytest.mark.parametrize("D", [16, 128, 256])
def test_flash_f32_route(D):
    """f32 goes to the f32 kernel (flash_attention.cu), bf16 to the bf16
    one (flash_attention_sm90.cu), at every head dim; and the launch
    counters carry the route's name."""
    assert tfa.route(torch.float32, D) == "f32" and tfa.route(torch.bfloat16, D) == "tc"
    tops.reset_launch_counts()
    counts = tops.launch_counts()
    assert counts["flash_attention_f32"] == counts["flash_attention_tc"] == 0
    assert "flash_attention_cores" not in counts


def _smoke():
    spec = importlib.util.spec_from_file_location("chip_smoke", ROOT / "chip_smoke.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def test_serve_f32_expects_its_launches():
    """The serve_f32 phase's config (full-width qwen3-14b in f32, 8 of 40
    layers, 8 greedy tokens): 8 f32 flash launches, one a layer in the
    prefill, and RMSNorm 41 in the prefill (ln1, ln2, the q and k norms of
    8 layers, the k norm again, the final norm) and 33 a decode step."""
    CS = _smoke()
    cfg = dataclasses.replace(get_config(CS.ARCH), dtype="float32", param_dtype="float32",
                              num_layers=CS.F32_LAYERS)
    assert CS.F32_LAYERS == 8 and CS.F32_NEW_TOKENS == 8 and cfg.head_dim == 128
    want = CS.expected_launches(cfg, CS.F32_NEW_TOKENS - 1)
    assert want == {"rmsnorm": 41 + 7 * 33, "flash_attention_tc": 0, "flash_attention_f32": 8,
                    "chunk_reduce": 0, "dequant_add": 0}


def test_serve_f32_launch_count_is_the_engines(monkeypatch):
    """On the CPU, reduced qwen3-14b in f32 at the full model's head dim of
    128 through the engine: its calls of the RMSNorm and flash ops, counted
    by route, are ``chip_smoke.expected_launches`` of the same config."""
    CS = _smoke()
    full = get_config(CS.ARCH)
    cfg = dataclasses.replace(reduced_config(full), head_dim=full.head_dim, dtype="float32",
                              param_dtype="float32")
    params = tcommon.init_params(TT.model_skel(cfg), torch.Generator().manual_seed(0), "cpu")
    calls = {"rmsnorm": 0, "flash_attention_tc": 0, "flash_attention_f32": 0}
    rms, flash = tops.rmsnorm, tops.flash_attention

    def counted_rms(*a, **k):
        calls["rmsnorm"] += 1
        return rms(*a, **k)

    def counted_flash(q, *a, **k):
        calls[f"flash_attention_{tfa.route(q.dtype, q.shape[-1])}"] += 1
        return flash(q, *a, **k)

    monkeypatch.setattr(tops, "rmsnorm", counted_rms)
    monkeypatch.setattr(tops, "flash_attention", counted_flash)
    steps = 4
    tengine.Engine(cfg, params, tengine.ServeOptions(max_seq=16, batch_size=2)).generate(
        tserve.random_batch(cfg, 2, 8, 0), steps)
    want = CS.expected_launches(cfg, steps - 1)
    assert calls == {k: want[k] for k in calls}
    assert want["flash_attention_f32"] == cfg.num_layers and want["flash_attention_tc"] == 0
