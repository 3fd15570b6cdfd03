"""The port's CUDA kernels and serve path on the card.

Every test here needs a CUDA device (marker ``gpu``) and skips without one;
on the card they run with

    PYTHONPATH=src python -m pytest -q -m gpu tests/test_torch_gpu.py

This file imports no JAX (the card's machine has none): the kernels are held
against the port's plain versions, which tests/test_torch_kernels.py holds
against the JAX package on the CPU.
"""

import dataclasses
import time

import numpy as np
import pytest
import torch

import torch_rank_cases as cases
from repro_torch.checkpoint.checkpoint import Checkpointer
from repro_torch.configs import get_config, reduced_config
from repro_torch.configs.base import ShapeSpec
from repro_torch.core import collectives as C
from repro_torch.core import group as G
from repro_torch.kernels import chunk_reduce as tcr
from repro_torch.kernels import flash_attention as tfa
from repro_torch.kernels import ops, ref
from repro_torch.kernels import rmsnorm as trn
from repro_torch.launch import serve
from repro_torch.launch import train as LT
from repro_torch.models import moe
from repro_torch.models import transformer as T
from repro_torch.models.common import dense, init_params
from repro_torch.optim import compression
from repro_torch.serving.engine import Engine, ServeOptions
from repro_torch.data import pipeline
from repro_torch.train import step as TS
from repro_torch.tree import leaves, tree_map, unflatten_like

pytestmark = pytest.mark.gpu

DTYPES = [torch.float32, torch.bfloat16]
NO_LAUNCHES = {"rmsnorm": 0, "flash_attention_tc": 0, "flash_attention_f32": 0, "chunk_reduce": 0,
               "dequant_add": 0}
FLASH_CASES = [
    # (B, H, Kh, Sq, Skv, D, causal, window, q_offset)
    (1, 2, 2, 128, 128, 64, True, 0, 0),
    (2, 4, 2, 128, 128, 64, True, 0, 0),
    (1, 4, 1, 256, 256, 32, True, 0, 0),
    (1, 2, 2, 128, 128, 64, False, 0, 0),
    (1, 2, 2, 256, 256, 64, True, 64, 0),
    (1, 2, 1, 64, 512, 64, True, 0, 448),
    (2, 4, 1, 100, 100, 16, True, 0, 0),     # ragged, D = 16
    (1, 5, 1, 33, 70, 48, True, 0, 37),      # D = 48: not a multiple of 32
    (1, 2, 2, 40, 40, 256, True, 5, 0),      # D = 256, narrow window
    (1, 2, 2, 16, 16, 32, True, 0, -4),      # rows with no visible key
    (1, 8, 2, 513, 513, 128, True, 0, 0),    # prefill of prompt + one token
]


def tol(dtype):
    """tests/test_kernels.py:16-17."""
    return dict(rtol=2e-2, atol=2e-2) if dtype == torch.bfloat16 else dict(rtol=2e-5, atol=2e-5)


def _to_cuda(tree):
    if isinstance(tree, dict):
        return {k: _to_cuda(v) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_to_cuda(v) for v in tree]
    return tree.cuda()


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: torch.cuda.is_available() is False")
    torch.backends.cuda.matmul.allow_tf32 = False  # plain versions in full f32
    ops.reset_launch_counts()
    return torch.Generator(device="cuda").manual_seed(0)


def _qkv(gen, B, H, Kh, Sq, Skv, D, dtype):
    """q of std 2 and k, v of std 1: the scaled scores q.k / sqrt(D) have a
    std of 2 (the qk-normed serve path's are near 1), so the softmax is far
    from uniform and the output depends on every score."""
    q = (torch.randn(B, H, Sq, D, generator=gen, device="cuda") * 2).to(dtype)
    k = torch.randn(B, Kh, Skv, D, generator=gen, device="cuda").to(dtype)
    v = torch.randn(B, Kh, Skv, D, generator=gen, device="cuda").to(dtype)
    return q, k, v


@pytest.mark.parametrize("case", FLASH_CASES)
@pytest.mark.parametrize("dtype", DTYPES)
def test_flash_kernel_matches_plain(cuda, case, dtype):
    B, H, Kh, Sq, Skv, D, causal, window, off = case
    q, k, v = _qkv(cuda, B, H, Kh, Sq, Skv, D, dtype)
    got = ops.flash_attention(q, k, v, causal, window, off)
    torch.cuda.synchronize()
    want = ref.flash_attention_ref(q, k, v, causal, window, off)
    assert got.dtype == dtype and got.shape == q.shape
    torch.testing.assert_close(got.float(), want.float(), **tol(dtype))
    assert ops.launch_counts() == dict(NO_LAUNCHES, **{f"flash_attention_{tfa.route(dtype, D)}": 1})


# The tensor-core route (bf16, D a multiple of 16 up to 256): tests/test_kernels.py's
# cases of those head dims, the serve prefill shape and its 513-token variant,
# q_offset = Skv - Sq with Sq != Skv, ragged lengths, and windows whose first
# rows see no key; every head dim that is not a multiple of 64 (the kernel pads
# it to one in shared memory), and stablelm-3b's prefill at D = 80 with the
# same variants; jamba-v0.1-52b's prefill; and past 128 (DP = 192 or 256 in
# shared memory, kv tiles of 64 rows) WIDE_TC_CASES.
TC_CASES = [
    # (B, H, Kh, Sq, Skv, D, causal, window, q_offset)
    (1, 2, 2, 128, 128, 64, True, 0, 0),
    (2, 4, 2, 128, 128, 64, True, 0, 0),
    (1, 2, 2, 128, 128, 64, False, 0, 0),
    (1, 2, 2, 256, 256, 64, True, 64, 0),
    (1, 2, 1, 64, 512, 64, True, 0, 448),
    (4, 40, 8, 512, 512, 128, True, 0, 0),    # the serve prefill
    (4, 40, 8, 513, 513, 128, True, 0, 0),    # prefill of prompt + one token
    (1, 4, 2, 100, 300, 128, True, 0, 200),   # ragged, Sq != Skv
    (2, 4, 4, 70, 190, 64, False, 0, 0),      # ragged, bidirectional
    (1, 2, 2, 300, 300, 128, True, 48, 0),    # narrow window over several tiles
    (1, 2, 1, 200, 200, 64, True, 16, -20),   # window, the first 20 rows see no key
    (1, 2, 2, 16, 16, 128, True, 0, -4),      # rows with no visible key
    (1, 2, 1, 4, 64, 64, True, 0, -10),       # no row sees a key: no kv tile is read
    (1, 2, 1, 40, 0, 128, True, 0, 0),        # no keys at all
    (1, 4, 2, 128, 128, 16, True, 0, 0),
    (1, 4, 1, 256, 256, 32, True, 0, 0),      # MQA
    (1, 5, 1, 33, 70, 48, True, 0, 37),       # ragged, Sq != Skv
    (4, 32, 32, 512, 512, 80, True, 0, 0),    # stablelm-3b's serve prefill (MHA)
    (4, 32, 32, 513, 513, 80, True, 0, 0),    # its prefill of prompt + one token
    (2, 4, 4, 100, 300, 80, True, 0, 200),    # ragged, Sq != Skv
    (1, 4, 4, 200, 200, 80, True, 16, -20),   # window, the first 20 rows see no key
    (2, 4, 2, 100, 100, 96, False, 0, 0),     # ragged, bidirectional
    (1, 2, 2, 300, 300, 112, True, 48, 0),    # narrow window over several tiles
    (4, 32, 8, 512, 512, 128, True, 0, 0),    # jamba's serve prefill (G = 4, no RoPE)
    (4, 32, 8, 513, 513, 128, True, 0, 0),    # its prefill of prompt + one token
    (4, 16, 16, 1500, 1500, 64, False, 0, 0),  # whisper's encoder (1500 = 11 x 128 + 92)
    (4, 16, 16, 384, 1500, 64, False, 0, 0),  # whisper's cross-attention
    (4, 16, 16, 384, 384, 64, True, 0, 0),    # whisper's decoder self-attention
    (2, 4, 4, 220, 92, 64, False, 0, 0),      # bidirectional, one kv edge tile, Sq > Skv
]
WIDE_TC_CASES = [case for D in (144, 192, 208, 256) for case in (
    (2, 4, 2, 100, 300, D, True, 0, 200),     # GQA, ragged, Sq != Skv, q_offset
    (1, 2, 1, 200, 200, D, True, 16, -20),    # MQA, window, the first 20 rows see no key
    (2, 4, 4, 100, 300, D, False, 0, 0),      # bidirectional, Sq != Skv
    (1, 2, 2, 300, 300, D, True, 48, 0),      # narrow window over several kv tiles
    (1, 2, 2, 16, 16, D, True, 0, -4),        # rows with no visible key
)] + [(1, 4, 2, 128, 128, D, True, 0, 0) for D in (160, 176, 224, 240)] + [
    (4, 16, 8, 512, 512, 256, True, 0, 0),    # the smoke's timed shape at D = 256
    (1, 8, 2, 513, 513, 256, True, 0, 0),     # a last q tile of one row
    (2, 4, 4, 220, 92, 256, False, 0, 0),     # bidirectional, one kv edge tile, Sq > Skv
    (2, 8, 8, 512, 512, 160, True, 0, 0),     # MHA at prefill size
    (2, 4, 4, 100, 300, 160, True, 0, 200),   # ragged, Sq != Skv
    (1, 4, 4, 200, 200, 256, True, 16, -20),  # MHA, window, the first 20 rows see no key
]
TC_CASES += WIDE_TC_CASES


@pytest.mark.parametrize("case", TC_CASES)
def test_flash_tensor_cores_match_plain(cuda, case):
    B, H, Kh, Sq, Skv, D, causal, window, off = case
    assert tfa.route(torch.bfloat16, D) == "tc"
    q, k, v = _qkv(cuda, B, H, Kh, Sq, Skv, D, torch.bfloat16)
    got = ops.flash_attention(q, k, v, causal, window, off)
    torch.cuda.synchronize()
    want = ref.flash_attention_ref(q, k, v, causal, window, off)
    assert got.dtype == torch.bfloat16 and got.shape == q.shape
    torch.testing.assert_close(got.float(), want.float(), **tol(torch.bfloat16))
    assert ops.launch_counts() == dict(NO_LAUNCHES, flash_attention_tc=1)
    if want.abs().max() > 0:  # some row sees a key: the check must fail a wrong Q.K^T
        for kk in (k.roll(8, dims=-1), torch.zeros_like(k)):  # a 16-byte unit off; S = 0
            bad = ref.flash_attention_ref(q, kk, v, causal, window, off)
            assert not torch.allclose(got.float(), bad.float(), **tol(torch.bfloat16))


@pytest.mark.parametrize("case", [c for c in TC_CASES if c[0] * c[1] * c[3] <= 4096])
def test_flash_f32_takes_the_f32_kernel(cuda, case):
    """f32 at the bf16 route's cases takes the f32 kernel (three TF32
    products), held to 2e-5."""
    B, H, Kh, Sq, Skv, D, causal, window, off = case
    q, k, v = _qkv(cuda, B, H, Kh, Sq, Skv, D, torch.float32)
    got = ops.flash_attention(q, k, v, causal, window, off)
    torch.cuda.synchronize()
    torch.testing.assert_close(got, ref.flash_attention_ref(q, k, v, causal, window, off), **tol(torch.float32))
    assert ops.launch_counts() == dict(NO_LAUNCHES, flash_attention_f32=1)


# The f32 kernel (three TF32 products) at every head dim it takes: GQA with
# ragged Sq != Skv (neither a multiple of a 64-row tile) and q_offset, MQA with
# a window whose first 20 rows see no key, and MHA bidirectional, ragged.
F32_CASES = [case for D in tfa.TC_HEAD_DIMS for case in (
    (2, 4, 2, 100, 300, D, True, 0, 200),
    (1, 2, 1, 200, 200, D, True, 16, -20),
    (2, 4, 4, 100, 190, D, False, 0, 0),
)]


@pytest.mark.parametrize("case", F32_CASES)
def test_flash_f32_matches_plain_with_its_lse(cuda, case):
    """The f32 kernel's output and lse against the plain version's at 2e-5
    (+inf exactly where a row sees no key), and the check fails a wrong
    Q.K^T (K's columns rolled by one 16-byte unit, and S = 0)."""
    B, H, Kh, Sq, Skv, D, causal, window, off = case
    assert tfa.route(torch.float32, D) == "f32"
    q, k, v = _qkv(cuda, B, H, Kh, Sq, Skv, D, torch.float32)
    out, lse = tfa.flash_attention_fwd(q, k, v, causal, window, off, return_lse=True)
    alone = tfa.flash_attention_fwd(q, k, v, causal, window, off)
    torch.cuda.synchronize()
    want_out, want = ref.flash_attention_ref(q, k, v, causal, window, off, return_lse=True)
    assert torch.equal(out, alone) and out.dtype == torch.float32
    torch.testing.assert_close(out, want_out, **tol(torch.float32))
    torch.testing.assert_close(lse, want, rtol=0, atol=2e-5)
    assert ops.launch_counts() == dict(NO_LAUNCHES, flash_attention_f32=2)
    for kk in (k.roll(4, dims=-1), torch.zeros_like(k)):
        assert not torch.allclose(out, ref.flash_attention_ref(q, kk, v, causal, window, off), **tol(torch.float32))


@pytest.mark.parametrize("D", [16, 80, 128, 208, 256])
@pytest.mark.parametrize("causal", [True, False])
def test_flash_f32_reads_only_its_own_bytes(cuda, D, causal):
    """q, k and v are views at the start of larger NaN-filled buffers, with
    lengths that fill no last tile (Sq = 200, Skv = 300): a read past column
    D of the last row, or past the last row, would bring a NaN in, and a
    store of the last q tile past Sq would leave one."""
    B, H, Kh, Sq, Skv = 1, 4, 2, 200, 300
    views = []
    for t in _qkv(cuda, B, H, Kh, Sq, Skv, D, torch.float32):
        buf = torch.full((t.numel() + 128 * D,), float("nan"), device="cuda")
        views.append(buf[: t.numel()].view(t.shape))
        views[-1].copy_(t)
    q, k, v = views
    got = ops.flash_attention(q, k, v, causal, 0, Skv - Sq)
    torch.cuda.synchronize()
    assert torch.isfinite(got).all()
    torch.testing.assert_close(got, ref.flash_attention_ref(q, k, v, causal, 0, Skv - Sq), **tol(torch.float32))
    assert ops.launch_counts() == dict(NO_LAUNCHES, flash_attention_f32=1)


@pytest.mark.parametrize("D", [64, 128, 256])
def test_flash_f32_refuses_a_misaligned_start(cuda, D):
    """TMA reads from 16-byte aligned addresses; nothing falls over to the
    bf16 kernel or the plain version."""
    q, k, v = _qkv(cuda, 1, 2, 2, 33, 33, D, torch.float32)
    for which in range(3):
        flat = torch.empty((q, k, v)[which].numel() + 1, device="cuda")
        moved = flat[1:].view((q, k, v)[which].shape)
        moved.copy_((q, k, v)[which])
        args = [q, k, v]
        args[which] = moved
        with pytest.raises(ValueError, match="16-byte"):
            tfa.flash_attention_fwd(*args)
    assert ops.launch_counts() == NO_LAUNCHES


LSE_CASES = ([(c, dt) for c in FLASH_CASES for dt in DTYPES] + [(c, torch.bfloat16) for c in TC_CASES]
             + [((1, 40, 8, 4096, 4096, 128, True, 0, 0), torch.bfloat16)])  # the train shape


@pytest.mark.parametrize("case,dtype", LSE_CASES)
def test_flash_lse_matches_plain(cuda, case, dtype):
    """Both routes' log-sum-exp against the plain version's (2e-5 absolute
    in f32, 2e-2 in bf16; +inf on rows with no visible key), with the same
    output as without it; and the check fails a wrong lse (S = 0, and the
    lse in log2 units) on the rows that see a key."""
    B, H, Kh, Sq, Skv, D, causal, window, off = case
    q, k, v = _qkv(cuda, B, H, Kh, Sq, Skv, D, dtype)
    out, lse = tfa.flash_attention_fwd(q, k, v, causal, window, off, return_lse=True)
    alone = tfa.flash_attention_fwd(q, k, v, causal, window, off)
    torch.cuda.synchronize()
    assert tfa.lse_launches == 1
    want_out, want = ref.flash_attention_ref(q, k, v, causal, window, off, return_lse=True)
    assert lse.dtype == torch.float32 and lse.shape == (B, H, Sq)
    assert torch.equal(out, alone)
    atol = 2e-5 if dtype == torch.float32 else 2e-2
    torch.testing.assert_close(lse, want, rtol=0, atol=atol)
    torch.testing.assert_close(out.float(), want_out.float(), **tol(dtype))
    seen = torch.isfinite(want)
    if seen.any():
        zero_s = ref.flash_attention_ref(q, torch.zeros_like(k), v, causal, window, off, return_lse=True)[1]
        for bad in (zero_s, want / 0.6931471805599453):
            assert not torch.allclose(lse[seen], bad[seen], rtol=0, atol=atol)


@pytest.mark.parametrize("case,dtype", [((1, 40, 8, 512, 512, 128, True, 0, 0), torch.bfloat16),
                                        ((2, 4, 2, 100, 100, 64, True, 16, 0), torch.bfloat16),
                                        ((1, 4, 1, 256, 256, 32, True, 0, 0), torch.float32)])
def test_flash_backward_on_the_card_matches_the_cpu(cuda, case, dtype):
    """The autograd function on the card (the kernel's forward and lse, the
    plain backward) against the same on the CPU (the plain forward): f32 at
    2e-4 / 1e-5, bf16 at 2e-2 of each gradient's largest magnitude (the
    tensor-core kernel rounds P to bf16, the CPU's plain forward keeps it)."""
    B, H, Kh, Sq, Skv, D, causal, window, off = case
    q, k, v = _qkv(cuda, B, H, Kh, Sq, Skv, D, dtype)
    dout = torch.randn(q.shape, generator=cuda, device="cuda").to(dtype)
    grads = []
    for dev in ("cuda", "cpu"):
        ts = [t.to(dev).requires_grad_() for t in (q, k, v)]
        out = ops.flash_attention(*ts, causal, window, off)
        grads.append([g.cpu().float() for g in torch.autograd.grad(out, ts, dout.to(dev))])
    route = tfa.route(dtype, D)
    assert ops.launch_counts() == dict(NO_LAUNCHES, **{f"flash_attention_{route}": 1})
    for g, w in zip(*grads):
        if dtype == torch.float32:
            torch.testing.assert_close(g, w, rtol=2e-4, atol=1e-5)
        else:
            assert (g - w).abs().max() <= 2e-2 * w.abs().max()


def test_rmsnorm_backward_on_the_card_matches_the_cpu(cuda):
    x = torch.randn(3, 7, 256, generator=cuda, device="cuda").bfloat16()
    w = (torch.randn(256, generator=cuda, device="cuda") * 0.1).bfloat16()
    dy = torch.randn(x.shape, generator=cuda, device="cuda").bfloat16()
    grads = []
    for dev in ("cuda", "cpu"):
        ts = [x.to(dev).requires_grad_(), w.to(dev).requires_grad_()]
        grads.append([g.cpu().float() for g in torch.autograd.grad(ops.rmsnorm(*ts), ts, dy.to(dev))])
    assert ops.launch_counts() == dict(NO_LAUNCHES, rmsnorm=1)
    for g, want in zip(*grads):
        torch.testing.assert_close(g, want, **tol(torch.bfloat16))


@pytest.mark.parametrize("tied", [False, True])
def test_unembed_gradient_on_the_card(cuda, tied):
    """``_unembed``'s f32 product of bf16 operands has no derivative in
    torch; its autograd function's dx and dw (bf16 products of the rounded
    cotangent, f32 accumulation) against the CPU's exact f32 gradients, at
    2e-2 of the largest magnitude."""
    cfg = reduced_config(get_config("qwen3-14b"))
    x = torch.randn(2, 3, 512, generator=cuda, device="cuda").bfloat16()
    w = torch.randn(512, 1000, generator=cuda, device="cuda").bfloat16()
    c = torch.randn(2, 3, 1000, generator=cuda, device="cuda")
    grads = []
    for dev in ("cuda", "cpu"):
        xx, ww = x.to(dev).requires_grad_(), w.to(dev).requires_grad_()
        params = {"embed": ww.T} if tied else {"lm_head": ww}
        y = T._unembed(cfg, params, xx)
        assert y.dtype == torch.float32
        grads.append([g.cpu().float() for g in torch.autograd.grad((y * c.to(dev)).sum(), [xx, ww])])
    for g, want in zip(*grads):
        assert (g - want).abs().max() <= 2e-2 * want.abs().max()


def test_train_step_on_the_card_matches_the_cpu(cuda):
    """Two steps of reduced qwen3-14b (f32, the f32 flash route), two
    microbatches, full remat: the card against the CPU, metrics at 1e-4
    relative and every weight within lr (AdamW moves a weight whose gradient
    is at the f32 noise by a noisy fraction of lr), and the launches that the
    step's forward and recompute make."""
    cfg = reduced_config(get_config("qwen3-14b"))
    shape = ShapeSpec("t", 32, 4, "train")
    adam = TS.AdamWConfig(lr=3e-3, warmup_steps=2)
    opts = TS.TrainOptions(num_microbatches=2, remat="full", adamw=adam)
    runs = []
    for dev in ("cuda", "cpu"):
        state = TS.init_state(cfg, seed=1, device="cpu")
        state = _to_cuda(state) if dev == "cuda" else state
        step = TS.make_train_step(cfg, opts)
        metrics = []
        for i in range(2):
            state, m = step(state, pipeline.device_batch(cfg, shape, i, torch.device(dev)))
            metrics.append([float(m[k]) for k in ("loss", "grad_norm", "lr")])
        runs.append((metrics, [t.cpu() for t in leaves(state["params"])]))
    np.testing.assert_allclose(runs[0][0], runs[1][0], rtol=1e-4)
    for a, b in zip(runs[0][1], runs[1][1]):
        torch.testing.assert_close(a, b, rtol=0, atol=adam.lr)
    L = cfg.num_layers
    assert ops.launch_counts() == dict(NO_LAUNCHES, rmsnorm=2 * 2 * (4 * L * 2 + 1),
                                       flash_attention_f32=2 * 2 * L * 2)


def _rel_l2(a, b) -> float:
    return ((a.float() - b.float()).norm() / b.float().norm()).item()


def test_bf16_train_gradients_on_the_card(cuda):
    """The bf16 train path on the card (the tensor-core flash forward and its
    lse, the plain backward, RMSNorm, the f32-output lm_head product and its
    autograd function) on a small config with head dim 64: each gradient lies
    no further from the f32 gradient of the same weights than twice the CPU's
    bf16 gradient does (both round in bf16, at different places)."""
    cfg = dataclasses.replace(reduced_config(get_config("qwen3-14b")), head_dim=64)
    bf16 = dataclasses.replace(cfg, dtype="bfloat16", param_dtype="bfloat16")
    params = init_params(T.model_skel(cfg), torch.Generator().manual_seed(2), "cpu", "bfloat16")
    rng = np.random.RandomState(2)
    for blk in params["stages"][0]["pos0"].values():
        for name in ("w", "q_norm", "k_norm"):
            if name in blk:
                blk[name].copy_(torch.from_numpy(rng.randn(*blk[name].shape).astype(np.float32) * 0.3))
    batch = pipeline.host_batch(cfg, ShapeSpec("t", 96, 2, "train"), 0)

    def grads(c, p, dev):
        ps = [t.to(dev).requires_grad_() for t in leaves(p)]
        tree = unflatten_like(p, ps)
        loss = T.train_loss(c, tree, {k: torch.from_numpy(v).to(dev) for k, v in batch.items()})
        return [g.cpu() for g in torch.autograd.grad(loss, ps)]

    f32 = grads(cfg, tree_map(lambda t: t.float(), params), "cpu")
    cpu = grads(bf16, params, "cpu")
    card = grads(bf16, params, "cuda")
    assert ops.launch_counts()["flash_attention_tc"] == cfg.num_layers
    for g, c, w in zip(card, cpu, f32):
        assert g.dtype == torch.bfloat16
        assert _rel_l2(g, w) <= 2 * _rel_l2(c, w), (_rel_l2(g, w), _rel_l2(c, w))


def _bits(t: torch.Tensor) -> torch.Tensor:
    return t.view({2: torch.int16, 4: torch.int32}[t.element_size()]) if t.is_floating_point() else t


def test_a_checkpoint_written_from_the_card_restores_bit_for_bit(cuda, tmp_path):
    """A bf16 train state after one step on the card, saved asynchronously
    while the next step updates it in place: restored onto the card and onto
    the CPU, every leaf is the state as it was saved, bit for bit, and the
    step from the restored state gives the uninterrupted step's loss."""
    cfg = dataclasses.replace(reduced_config(get_config("qwen3-14b")), head_dim=64, dtype="bfloat16",
                              param_dtype="bfloat16")
    shape = ShapeSpec("t", 32, 4, "train")
    step = TS.make_train_step(cfg, TS.TrainOptions(num_microbatches=2))
    batch = lambda i: pipeline.device_batch(cfg, shape, i, torch.device("cuda"))
    state, _ = step(TS.init_state(cfg, 0, "cuda"), batch(0))
    want = tree_map(torch.clone, state)
    ck = Checkpointer(str(tmp_path))
    ck.save_async(1, state)
    _, m = step(state, batch(1))
    ck.wait()
    for dev in ("cuda", "cpu"):
        n, got = ck.restore(TS.abstract_state(cfg), device=dev)
        assert n == 1
        for a, b in zip(leaves(got), leaves(want)):
            assert a.device.type == dev and a.dtype == b.dtype and a.shape == b.shape
            assert torch.equal(_bits(a.cpu()), _bits(b.cpu()))
    assert any(t.dtype == torch.bfloat16 for t in leaves(want))
    _, again = step(ck.restore(TS.abstract_state(cfg), device="cuda")[1], batch(1))
    assert float(again["loss"]) == float(m["loss"])


def test_pods_on_the_card_end_bit_for_bit_the_same(cuda):
    """The launcher's multi-pod run on the card: 2 pods of reduced qwen3-14b
    in bf16 (head dim 64: the tensor-core flash), each a rank process with a
    replica, hoplite_chain between them.  After every step both replicas
    hash the same, and each pod launched the hop kernel once a gradient leaf
    (the pairwise exchange of 2 ranks) and the flash twice a layer (remat)."""
    cfg = dataclasses.replace(reduced_config(get_config("qwen3-14b")), head_dim=64, dtype="bfloat16",
                              param_dtype="bfloat16")
    _, recs = LT.run(cfg, ShapeSpec("t", 32, 4, "train"), TS.TrainOptions(pod_sync="hoplite_chain"), "cuda",
                     steps=3, log=lambda _: None, pods=2, return_state=False)
    n_leaves = len(list(leaves(T.model_skel(cfg))))
    assert [r["step"] for r in recs] == [1, 2, 3]
    for r in recs:
        assert len(r["digests"]) == 2 and len(set(r["digests"])) == 1
        for p in r["pods"]:
            assert p["launches"]["chunk_reduce"] == n_leaves and p["sync_ms"] > 0
            assert p["launches"]["flash_attention_tc"] == 2 * cfg.num_layers


@pytest.mark.parametrize("D", [80, 208, 256])
def test_flash_tensor_cores_read_only_their_own_bytes(cuda, D):
    """q, k and v at D = 80, 208 and 256 are views at the start of larger
    NaN-filled buffers: a read past column D of the last row, or past the
    last row, would bring a NaN into the output."""
    B, H, Kh, S = 1, 4, 4, 200
    views = []
    for t in _qkv(cuda, B, H, Kh, S, S, D, torch.bfloat16):
        buf = torch.full((t.numel() + 128 * D,), float("nan"), dtype=torch.bfloat16, device="cuda")
        views.append(buf[: t.numel()].view(t.shape))
        views[-1].copy_(t)
    q, k, v = views
    got = ops.flash_attention(q, k, v, True, 0, 0)
    torch.cuda.synchronize()
    assert torch.isfinite(got).all()
    want = ref.flash_attention_ref(q, k, v, True, 0, 0)
    torch.testing.assert_close(got.float(), want.float(), **tol(torch.bfloat16))
    assert ops.launch_counts() == dict(NO_LAUNCHES, flash_attention_tc=1)


@pytest.mark.parametrize("D", [64, 256])
@pytest.mark.parametrize("Sq,Skv", [(200, 1500), (1500, 1500), (300, 92)])
def test_flash_tensor_cores_bidirectional_read_only_their_own_bytes(cuda, Sq, Skv, D):
    """Bidirectional attention at D = 64 and 256 with the lengths of
    whisper's cross and encoder attention, neither a multiple of a kv tile
    (128 rows, or 64 past D = 128): q, k and v are views at the start of
    larger NaN-filled buffers, so a read past the last row (the kv edge tile
    has no causal mask to hide it) or a store of the last q tile past Sq
    would bring a NaN in or leave one."""
    B, H, Kh = 1, 4, 4
    views = []
    for t in _qkv(cuda, B, H, Kh, Sq, Skv, D, torch.bfloat16):
        buf = torch.full((t.numel() + 128 * D,), float("nan"), dtype=torch.bfloat16, device="cuda")
        views.append(buf[: t.numel()].view(t.shape))
        views[-1].copy_(t)
    q, k, v = views
    got = ops.flash_attention(q, k, v, False, 0, 0)
    torch.cuda.synchronize()
    assert torch.isfinite(got).all()
    want = ref.flash_attention_ref(q, k, v, False, 0, 0)
    torch.testing.assert_close(got.float(), want.float(), **tol(torch.bfloat16))
    assert not torch.allclose(got.float(), ref.flash_attention_ref(q, k[:, :, : Skv - 92], v[:, :, : Skv - 92],
                                                                   False, 0, 0).float(), **tol(torch.bfloat16))
    assert ops.launch_counts() == dict(NO_LAUNCHES, flash_attention_tc=1)


@pytest.mark.parametrize("D", [64, 256])
def test_flash_tensor_cores_refuse_a_misaligned_start(cuda, D):
    """TMA reads from 16-byte aligned addresses; the route does not change."""
    q, k, v = _qkv(cuda, 1, 2, 2, 33, 33, D, torch.bfloat16)
    flat = torch.empty(q.numel() + 1, dtype=torch.bfloat16, device="cuda")
    q1 = flat[1:].view(q.shape)
    q1.copy_(q)
    with pytest.raises(ValueError, match="16-byte"):
        tfa.flash_attention_fwd(q1, k, v)
    assert ops.launch_counts() == NO_LAUNCHES


# The serve and train paths' widths: the qk-norm's head dim (qwen3, gemma3) and
# d_model of jamba, qwen3 and llama4-scout, gemma3, mixtral, qwen2-vl.
RMSNORM_WIDTHS = (128, 4096, 5120, 5376, 6144, 8192)
RMSNORM_SHAPES = [
    (4, 64), (3, 7, 256), (1000, 128), (2048, 5120), (5, 16383), (2, 1025),
    # prefill and the decode rows (4, d) at every width; 4 tokens' 40 and 8 heads
    *[(2048, d) for d in RMSNORM_WIDTHS if d != 5120], *[(4, d) for d in RMSNORM_WIDTHS], (160, 128), (32, 128),
    # row counts that fill no last warp (4 rows of 128 a warp in bf16, 2 in f32), block or grid
    (1, 128), (1001, 128), (16385, 128), (37, 5120), (2049, 8192),
]


@pytest.mark.parametrize("shape", RMSNORM_SHAPES)
@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("wdtype", DTYPES)
def test_rmsnorm_kernel_matches_plain(cuda, shape, dtype, wdtype):
    x = torch.randn(shape, generator=cuda, device="cuda").to(dtype)
    w = (torch.randn(shape[-1], generator=cuda, device="cuda") * 0.1).to(wdtype)
    got = ops.rmsnorm(x, w)
    torch.cuda.synchronize()
    assert got.dtype == dtype and got.shape == x.shape
    torch.testing.assert_close(got.float(), ref.rmsnorm_ref(x, w).float(), **tol(dtype))
    assert ops.launch_counts() == dict(NO_LAUNCHES, rmsnorm=1)


@pytest.mark.parametrize("shape", [(4, 128), (1001, 128), (4, 4096), (2048, 5120), (4, 6144), (4, 8192), (3, 1025)])
@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("wdtype", DTYPES)
def test_rmsnorm_kernel_takes_a_misaligned_view(cuda, shape, dtype, wdtype):
    """A contiguous view that starts one element past a 16-byte boundary
    takes the kernel's scalar path (its generic kernel), never the plain
    version."""
    x = torch.randn(shape, generator=cuda, device="cuda").to(dtype)
    w = (torch.randn(shape[-1], generator=cuda, device="cuda") * 0.1).to(wdtype)
    flat = torch.empty(x.numel() + 1, dtype=dtype, device="cuda")
    xv = flat[1:].view(shape)
    xv.copy_(x)
    assert xv.is_contiguous() and xv.data_ptr() % 16 != 0
    got = ops.rmsnorm(xv, w)
    torch.cuda.synchronize()
    assert got.dtype == dtype and got.shape == x.shape
    torch.testing.assert_close(got.float(), ref.rmsnorm_ref(x, w).float(), **tol(dtype))
    assert ops.launch_counts() == dict(NO_LAUNCHES, rmsnorm=1)


@pytest.mark.parametrize("d", RMSNORM_WIDTHS)
@pytest.mark.parametrize("dtype", DTYPES)
def test_rmsnorm_rows_alone_equal_rows_in_a_batch(cuda, d, dtype):
    """A row's result depends on its values, d and the types only: rows normed
    alone, as decode norms one token's, equal the same rows normed in a
    batch of 2048, as prefill norms them, bit for bit."""
    x = torch.randn(2048, d, generator=cuda, device="cuda").to(dtype)
    w = (torch.randn(d, generator=cuda, device="cuda") * 0.1).to(dtype)
    batch = ops.rmsnorm(x, w)
    parts = [slice(0, 1), slice(1, 5), slice(100, 260), slice(2047, 2048), slice(1023, 2048)]
    for rows in parts:
        assert torch.equal(ops.rmsnorm(x[rows].clone(), w), batch[rows]), rows
    assert ops.launch_counts() == dict(NO_LAUNCHES, rmsnorm=1 + len(parts))


def test_wrappers_refuse_what_the_kernels_do_not_take(cuda):
    x = torch.randn(8, 64, device="cuda")
    with pytest.raises(ValueError, match="contiguous"):
        trn.rmsnorm(x.t(), torch.zeros(8, device="cuda"))
    with pytest.raises(TypeError):
        trn.rmsnorm(x.half(), torch.zeros(64, device="cuda"))
    q = torch.randn(1, 2, 8, 24, device="cuda")
    with pytest.raises(ValueError, match="multiple of 16"):
        tfa.flash_attention_fwd(q, q, q)
    q = torch.randn(1, 3, 8, 32, device="cuda")
    with pytest.raises(ValueError):
        tfa.flash_attention_fwd(q, q[:, :2].contiguous(), q[:, :2].contiguous())
    assert ops.launch_counts() == NO_LAUNCHES


def test_reduced_model_on_the_card_matches_the_cpu(cuda):
    """The whole slice in f32: CUDA kernels and cuBLAS against the CPU's plain path."""
    cfg = reduced_config(get_config("qwen3-14b"))
    params = init_params(T.model_skel(cfg), torch.Generator().manual_seed(1), "cpu", "float32")
    rng = np.random.RandomState(1)
    for blk in params["stages"][0]["pos0"].values():
        for name in ("w", "q_norm", "k_norm"):
            if name in blk:
                blk[name].copy_(torch.from_numpy(rng.randn(*blk[name].shape).astype(np.float32) * 0.3))
    gparams = _to_cuda(params)
    toks = torch.from_numpy(serve.random_batch(cfg, 2, 13, 1)["tokens"])
    cl, cc = T.prefill(cfg, params, {"tokens": toks}, 24)
    gl, gc = T.prefill(cfg, gparams, {"tokens": toks.cuda()}, 24)
    torch.testing.assert_close(gl.cpu(), cl, rtol=1e-4, atol=1e-4)
    for t in range(13, 17):
        tok = cl[:, : cfg.vocab_size].argmax(-1)[:, None]
        cl, cc = T.decode_step(cfg, params, tok, t, cc)
        gl, gc = T.decode_step(cfg, gparams, tok.cuda(), t, gc)
        torch.testing.assert_close(gl.cpu(), cl, rtol=1e-4, atol=1e-4)
    counts = ops.launch_counts()
    assert counts["flash_attention_f32"] == cfg.num_layers and counts["flash_attention_tc"] == 0
    assert counts["rmsnorm"] == 5 * 2 + 1 + 4 * (4 * 2 + 1)
    opts = ServeOptions(max_seq=32, batch_size=2)
    got = Engine(cfg, gparams, opts).generate({"tokens": toks}, 6)
    want = Engine(cfg, params, opts).generate({"tokens": toks}, 6)
    np.testing.assert_array_equal(got, want)


def test_full_width_moe_layer_on_the_card_matches_the_cpu(cuda):
    """One full-width mixtral MoE layer (bf16 weights drawn on the CPU from a
    seed: the router and 8 experts of 6144 x 16384) on 2 x 16 tokens: the
    card's dense and no-drop dropping dispatches (cuBLAS f32 products)
    against the CPU's (products of the upcast operands), within 2e-2 of the
    largest magnitude on the tokens both route alike.  A token may route
    differently only where the CPU's margin (its k-th and (k+1)-th router
    logits) lies within 2e-2 of its largest router-logit magnitude, and at
    least 90% must route alike."""
    cfg = get_config("mixtral-8x22b")
    p = init_params(moe.moe_skel(cfg), torch.Generator().manual_seed(2), "cpu", "bfloat16")
    x = torch.randn(2, 16, cfg.d_model, generator=torch.Generator().manual_seed(3)).bfloat16()
    gp, gx = _to_cuda(p), x.cuda()
    E, k = cfg.num_experts, cfg.top_k
    logits = dense(x, p["router"]).float().reshape(-1, E)
    s = logits.sort(dim=-1, descending=True).values
    margin = (s[:, k - 1] - s[:, k]) / s.abs().amax(-1)
    cw, caux = moe._route(cfg, p, x)
    gw, gaux = moe._route(cfg, gp, gx)
    alike = ((cw > 0) == (gw.cpu() > 0)).all(-1).reshape(-1)
    assert (margin[~alike] <= 2e-2).all() and alike.float().mean() >= 0.9, (alike, margin)
    torch.testing.assert_close(gaux.cpu(), caux, rtol=2e-2, atol=0)
    room = E / k
    for name, fn in (("dense", moe.moe_fwd), ("dropping", lambda c, p_, x_: moe.moe_fwd_dropping(c, p_, x_, room))):
        want, _ = fn(cfg, p, x)
        got, _ = fn(cfg, gp, gx)
        assert got.dtype == torch.bfloat16 and got.shape == want.shape, name
        g, w = got.cpu().float().reshape(-1, cfg.d_model)[alike], want.float().reshape(-1, cfg.d_model)[alike]
        err = (g - w).abs().max() / w.abs().max()
        assert err <= 2e-2, (name, float(err))
    assert ops.launch_counts() == NO_LAUNCHES


def test_reduced_mixtral_ring_decode_on_the_card_matches_the_cpu(cuda):
    """reduced mixtral in f32 (4 experts top-2, window 8): prefill of 12
    tokens into caches of cache_seq 16, a ring of 8 slots (the roll path),
    and six decode steps past its wrap, the card (the f32 flash at head
    dim 16, cuBLAS) against the CPU's plain path at 1e-4, and the engine's
    greedy tokens; with the launches the path makes."""
    cfg = reduced_config(get_config("mixtral-8x22b"))
    params = init_params(T.model_skel(cfg), torch.Generator().manual_seed(1), "cpu", "float32")
    rng = np.random.RandomState(1)
    for blk in params["stages"][0]["pos0"].values():
        if "w" in blk:
            blk["w"].copy_(torch.from_numpy(rng.randn(*blk["w"].shape).astype(np.float32) * 0.3))
    gparams = _to_cuda(params)
    toks = torch.from_numpy(serve.random_batch(cfg, 2, 18, 1)["tokens"])
    cl, cc = T.prefill(cfg, params, {"tokens": toks[:, :12]}, 16)
    gl, gc = T.prefill(cfg, gparams, {"tokens": toks[:, :12].cuda()}, 16)
    assert gc[0]["pos0"]["k"].shape[2] == 8
    torch.testing.assert_close(gl.cpu(), cl, rtol=1e-4, atol=1e-4)
    for t in range(12, 18):
        cl, cc = T.decode_step(cfg, params, toks[:, t : t + 1], t, cc)
        gl, gc = T.decode_step(cfg, gparams, toks[:, t : t + 1].cuda(), t, gc)
        torch.testing.assert_close(gl.cpu(), cl, rtol=1e-4, atol=1e-4)
    torch.testing.assert_close(gc[0]["pos0"]["k"].cpu(), cc[0]["pos0"]["k"], rtol=1e-4, atol=1e-4)
    counts = ops.launch_counts()
    L = cfg.num_layers
    assert counts["flash_attention_f32"] == L and counts["flash_attention_tc"] == 0
    assert counts["rmsnorm"] == (2 * L + 1) * 7
    opts = ServeOptions(max_seq=16, batch_size=2)
    got = Engine(cfg, gparams, opts).generate({"tokens": toks[:, :12]}, 6)
    want = Engine(cfg, params, opts).generate({"tokens": toks[:, :12]}, 6)
    np.testing.assert_array_equal(got, want)


def _perturbed_norms(params, seed: int):
    """Random non-zero norm weights (and LayerNorm biases): zeros would hide
    the 1 + w.  So too the SSM leaves that init_params makes zeros or ones
    (RWKV's mixes, bonus, decay base and group norm, Mamba's biases, A_log
    and D), which would hide a wrong term."""
    rng = np.random.RandomState(seed)

    def walk(node, in_norm=False):
        items = node.items() if isinstance(node, dict) else enumerate(node)
        for name, v in items:
            norm = in_norm or name in ("ln1", "ln2", "ln_cross", "final_norm", "q_norm", "k_norm", "mu", "u", "w0",
                                       "ln_w",
                                       "ln_b", "conv_b", "dt_b", "A_log", "D")
            if isinstance(v, (dict, list)):
                walk(v, norm)
            elif norm:
                v.copy_(torch.from_numpy(rng.randn(*v.shape).astype(np.float32) * 0.3))

    walk(params)


def _max_err(got, want) -> float:
    g, w = got.cpu().float(), want.float()
    return float((g - w).abs().max() / w.abs().max())


def test_reduced_gemma3_bf16_on_the_card_matches_the_cpu(cuda):
    """reduced gemma3 in bf16 at its own head dim of 128 (so flash takes the
    tensor cores, as at full width): two stages, rings of 8 beside linear
    caches of 24; a prompt of 12 takes the roll path and eight decode steps
    wrap the rings.  Each step's logits within 2e-2 of their largest
    magnitude of the CPU's, and the launches the path makes."""
    cfg = dataclasses.replace(reduced_config(get_config("gemma3-27b")), head_dim=128, dtype="bfloat16",
                              param_dtype="bfloat16")
    params = init_params(T.model_skel(cfg), torch.Generator().manual_seed(1), "cpu")
    _perturbed_norms(params, 1)
    gparams = _to_cuda(params)
    toks = torch.from_numpy(serve.random_batch(cfg, 2, 20, 1)["tokens"])
    cl, cc = T.prefill(cfg, params, {"tokens": toks[:, :12]}, 24)
    gl, gc = T.prefill(cfg, gparams, {"tokens": toks[:, :12].cuda()}, 24)
    assert [g["pos0"]["k"].shape[2] for g in gc] == [8, 8] and gc[0]["pos5"]["k"].shape[2] == 24
    assert _max_err(gl, cl) <= 2e-2
    for t in range(12, 20):
        cl, cc = T.decode_step(cfg, params, toks[:, t : t + 1], t, cc)
        gl, gc = T.decode_step(cfg, gparams, toks[:, t : t + 1].cuda(), t, gc)
        assert _max_err(gl, cl) <= 2e-2, t
    L = cfg.num_layers
    assert ops.launch_counts() == dict(NO_LAUNCHES, flash_attention_tc=L, rmsnorm=(5 * L + 1) + 8 * (4 * L + 1))


def _mrope_positions(B: int, S: int) -> torch.Tensor:
    """Three distinct position streams: row b has b text tokens, an image block
    of grid (2, 1, 2) (temporal, height, width ids offset by the text before
    it), then text resuming past the largest id."""
    out = torch.zeros(3, B, S, dtype=torch.long)
    grid = torch.stack(torch.meshgrid(torch.arange(2), torch.arange(1), torch.arange(2), indexing="ij")).reshape(3, -1)
    for b in range(B):
        out[:, b, :b] = torch.arange(b)
        out[:, b, b : b + 4] = b + grid
        out[:, b, b + 4:] = b + 2 + torch.arange(S - b - 4)
    return out


def test_reduced_qwen2_vl_with_position_streams_on_the_card_matches_the_cpu(cuda):
    """reduced qwen2-vl in f32 with three distinct position streams: forward
    and prefill on the card (the f32 flash at head dim 16, cuBLAS) against
    the CPU's plain path at 1e-4, then decode steps; the streams are seen
    (broadcast ones give other logits)."""
    cfg = reduced_config(get_config("qwen2-vl-72b"))
    params = init_params(T.model_skel(cfg), torch.Generator().manual_seed(2), "cpu", "float32")
    _perturbed_norms(params, 2)
    gparams = _to_cuda(params)
    toks = torch.from_numpy(serve.random_batch(cfg, 2, 16, 2)["tokens"])
    pos = _mrope_positions(2, 12)
    full, _ = T.forward(cfg, params, {"tokens": toks[:, :12], "positions_3d": pos})
    gfull, _ = T.forward(cfg, gparams, {"tokens": toks[:, :12].cuda(), "positions_3d": pos.cuda()})
    torch.testing.assert_close(gfull.cpu(), full, rtol=1e-4, atol=1e-4)
    flat, _ = T.forward(cfg, params, {"tokens": toks[:, :12]})
    assert not torch.allclose(flat, full, rtol=1e-2, atol=1e-2)
    cl, cc = T.prefill(cfg, params, {"tokens": toks[:, :12], "positions_3d": pos}, 16)
    gl, gc = T.prefill(cfg, gparams, {"tokens": toks[:, :12].cuda(), "positions_3d": pos.cuda()}, 16)
    torch.testing.assert_close(gl.cpu(), cl, rtol=1e-4, atol=1e-4)
    for t in range(12, 16):
        cl, cc = T.decode_step(cfg, params, toks[:, t : t + 1], t, cc)
        gl, gc = T.decode_step(cfg, gparams, toks[:, t : t + 1].cuda(), t, gc)
        torch.testing.assert_close(gl.cpu(), cl, rtol=1e-4, atol=1e-4)
    L = cfg.num_layers
    assert ops.launch_counts() == dict(NO_LAUNCHES, flash_attention_f32=2 * L, rmsnorm=2 * (2 * L + 1) + 4 * (2 * L + 1))


def test_full_width_starcoder2_layer_on_the_card_matches_the_cpu(cuda):
    """One full-width starcoder2 layer (LayerNorm, the gelu FFN of 3072 x
    12288, 24 q / 2 kv heads at head dim 128), bf16 weights drawn on the CPU
    from a seed, on 2 x 64 tokens: the card (tensor-core flash, cuBLAS,
    F.layer_norm) against the CPU, within 2e-2 of the largest magnitude; no
    RMSNorm launch."""
    cfg = dataclasses.replace(get_config("starcoder2-3b"), num_layers=1)
    spec = cfg.pattern[0]
    lp = init_params(T.layer_skel(cfg, spec), torch.Generator().manual_seed(3), "cpu", "bfloat16")
    _perturbed_norms(lp, 3)
    lp["ln1"]["w"] += 1  # LayerNorm's scale near one
    lp["ln2"]["w"] += 1
    x = torch.randn(2, 64, cfg.d_model, generator=torch.Generator().manual_seed(4)).bfloat16()
    q_pos = torch.arange(64)
    want, _ = T.layer_fwd(cfg, spec, lp, x, q_pos)
    got, _ = T.layer_fwd(cfg, spec, _to_cuda(lp), x.cuda(), q_pos.cuda())
    assert got.dtype == torch.bfloat16 and got.shape == want.shape
    assert _max_err(got - x.cuda(), want - x) <= 2e-2
    assert ops.launch_counts() == dict(NO_LAUNCHES, flash_attention_tc=1)


@pytest.mark.parametrize("arch,position", [("jamba-v0.1-52b", 2), ("rwkv6-1.6b", 0)])
def test_full_width_ssm_layer_on_the_card_matches_the_cpu(cuda, arch, position):
    """One full-width layer of each SSM family, bf16 weights drawn on the CPU
    from a seed with their zero and one leaves drawn anew, on 2 x 64 tokens:
    the card in bf16 against the port's f32 run on the CPU of the same
    weights and inputs, upcast, within 2e-2 of the largest magnitude of the
    layer's update.  jamba's position 2 is a Mamba layer (d 4096, di 8192,
    N 16, conv 4, dt_rank 256) with its FFN (RMSNorm: two launches);
    rwkv6's is an RWKV-6 block (d 2048, 32 heads of 64, d_ff 7168;
    LayerNorm: none)."""
    full = get_config(arch)
    cfg = dataclasses.replace(full, num_layers=len(full.pattern))
    spec = cfg.pattern[position]
    assert spec.kind == ("mamba" if arch.startswith("jamba") else "rwkv") and not spec.moe
    lp = init_params(T.layer_skel(cfg, spec), torch.Generator().manual_seed(5), "cpu", "bfloat16")
    _perturbed_norms(lp, 5)
    if cfg.norm == "layernorm":  # LayerNorm's scale near one
        lp["ln1"]["w"] += 1
        lp["ln2"]["w"] += 1
    x = torch.randn(2, 64, cfg.d_model, generator=torch.Generator().manual_seed(6)).bfloat16()
    q_pos = torch.arange(64)
    cfg32 = dataclasses.replace(cfg, dtype="float32", param_dtype="float32")
    want, _ = T.layer_fwd(cfg32, spec, tree_map(lambda t: t.float(), lp), x.float(), q_pos)
    got, _ = T.layer_fwd(cfg, spec, _to_cuda(lp), x.cuda(), q_pos.cuda())
    assert got.dtype == torch.bfloat16 and got.shape == want.shape
    assert _max_err(got.float() - x.cuda().float(), want - x.float()) <= 2e-2
    assert ops.launch_counts() == dict(NO_LAUNCHES, rmsnorm=2 if cfg.norm == "rmsnorm" else 0)


@pytest.mark.parametrize("tied", [False, True])
def test_unembed_on_the_card_is_an_f32_product(cuda, tied):
    """The card's branch of ``_unembed`` (cuBLAS with an f32 output) against
    the f32 product of the upcast bf16 values.  The tolerance lies far under
    bf16's rounding (2^-9 relative), which the last assert shows it catches."""
    cfg = reduced_config(get_config("qwen3-14b"))
    x = torch.randn(2, 3, 512, generator=cuda, device="cuda").bfloat16()
    w = torch.randn(512, 1000, generator=cuda, device="cuda").bfloat16()
    params = {"embed": w.T.contiguous()} if tied else {"lm_head": w}
    got = T._unembed(cfg, params, x)
    want = torch.mm(x.reshape(-1, 512).float(), w.float()).reshape(2, 3, 1000)
    assert got.dtype == torch.float32 and got.shape == want.shape
    torch.testing.assert_close(got, want, rtol=1e-4, atol=1e-3)
    rounded = torch.mm(x.reshape(-1, 512), w).float().reshape(2, 3, 1000)
    assert not torch.allclose(rounded, want, rtol=1e-4, atol=1e-3)


def test_reduced_whisper_on_the_card_matches_the_cpu(cuda):
    """reduced whisper in bf16 at its own head dim of 64 (flash on the tensor
    cores, as at full width) over 1500 frames a row: the encoder and the
    forward logits, then prefill and four decode steps against the static
    cross cache, each within 2e-2 of the CPU's largest magnitude; the
    launches (flash per encoder layer, decoder self-attention and
    cross-attention; LayerNorm: no RMSNorm), and the engine's tokens on the
    card from the same frames."""
    cfg = dataclasses.replace(reduced_config(get_config("whisper-medium")), head_dim=64, encoder_seq=1500,
                              dtype="bfloat16", param_dtype="bfloat16")
    params = init_params(T.model_skel(cfg), torch.Generator().manual_seed(5), "cpu")
    _perturbed_norms(params, 5)
    gparams = _to_cuda(params)
    host = serve.random_batch(cfg, 2, 16, 5)
    batch = {k: torch.from_numpy(v) for k, v in host.items()}
    gbatch = {k: v.cuda() for k, v in batch.items()}
    enc = T._run_encoder(cfg, params, batch["encoder_frames"])
    assert _max_err(T._run_encoder(cfg, gparams, gbatch["encoder_frames"]), enc) <= 2e-2
    full, _ = T.forward(cfg, params, batch)
    gfull, _ = T.forward(cfg, gparams, gbatch)
    assert _max_err(gfull, full) <= 2e-2
    pre = dict(batch, tokens=batch["tokens"][:, :12])
    cl, cc = T.prefill(cfg, params, pre, 24)
    gl, gc = T.prefill(cfg, gparams, {k: v.cuda() for k, v in pre.items()}, 24)
    assert _max_err(gl, cl) <= 2e-2
    assert _max_err(gc[0]["pos0"]["cross_k"], cc[0]["pos0"]["cross_k"]) <= 2e-2
    toks = batch["tokens"]
    for t in range(12, 16):
        cl, cc = T.decode_step(cfg, params, toks[:, t : t + 1], t, cc)
        gl, gc = T.decode_step(cfg, gparams, toks[:, t : t + 1].cuda(), t, gc)
        assert _max_err(gl, cl) <= 2e-2, t
    L, E = cfg.num_layers, cfg.encoder_layers
    assert ops.launch_counts() == dict(NO_LAUNCHES, flash_attention_tc=E + 2 * (E + 2 * L))
    out = Engine(cfg, gparams, ServeOptions(max_seq=24, batch_size=2)).generate(host, 6)
    assert out.shape == (2, 6) and out.min() >= 0 and out.max() < cfg.vocab_size


def test_serve_main_defaults_to_the_card(cuda, capsys):
    out = serve.main(["--arch", "qwen3-14b", "--reduced", "--batch", "2", "--new-tokens", "4"])
    assert out.shape == (2, 4)
    assert torch.cuda.get_device_name() in capsys.readouterr().out
    assert ops.launch_counts()["flash_attention_f32"] == 2  # the reduced config: f32, head dim 16


@pytest.mark.parametrize("n", [17, 4096, 100_000])
@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("alpha", [1.0, 0.5])
@pytest.mark.parametrize("into", ["new", "dst"])
def test_chunk_reduce_kernel_matches_plain(cuda, n, dtype, alpha, into):
    """Bit for bit: the kernel rounds the product and the sum apart, as the plain version."""
    dst = torch.randn(n, generator=cuda, device="cuda").to(dtype)
    src = torch.randn(n, generator=cuda, device="cuda").to(dtype)
    want = ref.chunk_reduce_ref(dst, src, alpha)
    got = ops.chunk_reduce(dst, src, alpha, out=dst if into == "dst" else None)
    torch.cuda.synchronize()
    assert (got is dst) == (into == "dst") and got.dtype == dtype
    torch.testing.assert_close(got.float(), want.float(), **tol(dtype))
    assert torch.equal(got, want)
    assert ops.launch_counts() == dict(NO_LAUNCHES, chunk_reduce=1)


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("into", ["new", "dst"])
@pytest.mark.parametrize("alpha", [1.0, 0.5])
def test_chunk_reduce_on_the_rows_of_a_chunked_buffer(cuda, dtype, into, alpha):
    """The chain hop's case: dst is row k of ``buf.reshape(C, chunk)`` (as
    ``collectives._to_chunks`` lays a leaf out) with an odd chunk, so the rows
    start at every 2-byte (bf16) or 4-byte (f32) offset from a 16-byte
    boundary, and src is a fresh tensor.  Bit for bit, and no other row moves."""
    C, chunk = 8, 10_007
    buf = torch.randn(C * chunk, generator=cuda, device="cuda").to(dtype)
    rows = buf.reshape(C, chunk)
    for k in range(C):
        before = buf.clone()
        dst = rows[k]
        src = torch.randn(chunk, generator=cuda, device="cuda").to(dtype)
        want = ref.chunk_reduce_ref(dst, src, alpha)
        got = ops.chunk_reduce(dst, src, alpha, out=dst if into == "dst" else None)
        torch.cuda.synchronize()
        assert torch.equal(got, want), f"row {k}"
        others = torch.ones(C, dtype=torch.bool, device="cuda")
        others[k] = into == "new"
        assert torch.equal(buf.reshape(C, chunk)[others], before.reshape(C, chunk)[others])
    assert ops.launch_counts() == dict(NO_LAUNCHES, chunk_reduce=C)


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("into", ["new", "dst"])
@pytest.mark.parametrize("n", [1, 5, 17, 4099, 100_003])
def test_chunk_reduce_with_a_misaligned_src(cuda, dtype, into, n):
    """An aligned dst against src views that start at every element offset
    from a 16-byte boundary, and both misaligned by different offsets."""
    per = 16 // torch.tensor([], dtype=dtype).element_size()
    big_src = torch.randn(n + per, generator=cuda, device="cuda").to(dtype)
    big_dst = torch.randn(n + per, generator=cuda, device="cuda").to(dtype)
    launches = 0
    for s in range(per):
        for d in (0, (s * 3 + 1) % per):
            src = big_src[s : s + n]
            dst = big_dst[d : d + n].clone() if d == 0 else big_dst[d : d + n]
            want = ref.chunk_reduce_ref(dst, src, 1.0)
            got = ops.chunk_reduce(dst, src, 1.0, out=dst if into == "dst" else None)
            torch.cuda.synchronize()
            launches += 1
            assert torch.equal(got, want), f"src offset {s}, dst offset {d}"
    assert ops.launch_counts() == dict(NO_LAUNCHES, chunk_reduce=launches)


@pytest.mark.parametrize("into", ["new", "dst"])
@pytest.mark.parametrize("n", [1, 5, 17, 4099, 100_003])
def test_chunk_reduce_f16_at_unaligned_windows_matches_plain(cuda, into, n):
    """The f16 instance, bit for bit: dst and src windows of one buffer at
    every element offset from a 16-byte boundary (the data plane folds
    windows of its uint8 buffers, resumed from any element-aligned
    watermark), with alpha 1 and 0.5."""
    per = 8
    buf_d = torch.randn(n + per, generator=cuda, device="cuda").half()
    buf_s = torch.randn(n + per, generator=cuda, device="cuda").half()
    launches = 0
    for d in range(per):
        for s in (d, (d * 3 + 1) % per):
            for alpha in (1.0, 0.5):
                dst = buf_d[d: d + n] if into == "new" else buf_d.clone()[d: d + n]  # offset d either way
                src = buf_s[s: s + n]
                want = ref.chunk_reduce_ref(dst, src, alpha)
                got = ops.chunk_reduce(dst, src, alpha, out=dst if into == "dst" else None)
                torch.cuda.synchronize()
                launches += 1
                assert got.dtype == torch.float16 and torch.equal(got, want), (d, s, alpha)
    assert ops.launch_counts() == dict(NO_LAUNCHES, chunk_reduce=launches)


@pytest.mark.parametrize("op", ["reduce", "allreduce"])
def test_dataplane_on_the_card_is_exact_through_the_kernel(cuda, op):
    """A 32 MB f32 reduce (or allreduce) over 8 nodes whose stores lie on
    the card, integer-valued data: the exact sum on every node, each fold
    window one ``chunk_reduce`` launch (the cluster's ``fold_ops``)."""
    from repro_torch.core.api import SUM
    from repro_torch.core.local import LocalCluster

    n, elems = 8, (32 << 20) // 4
    c = LocalCluster(n)
    assert c.device.type == "cuda"
    xs = [torch.randint(-1000, 1000, (elems,), generator=cuda, device="cuda").float() for _ in range(n)]
    want = torch.stack(xs).sum(0)
    for i, x in enumerate(xs):
        c.put(i, f"g{i}", x)
    SUM.reset_counts()
    ids = [f"g{i}" for i in range(n)]
    if op == "reduce":
        c.reduce(0, "out", ids, SUM, timeout=120.0)
        nodes = [0]
    else:
        c.allreduce(list(range(n)), "out", ids, SUM, timeout=120.0)
        nodes = list(range(n))
    for i in nodes:
        got = c.get(i, "out", timeout=60.0)
        assert got.device.type == "cuda" and torch.equal(got, want), i
    folds = c.stats["fold_ops"]
    assert folds >= (n - 1) * 16 and SUM.counts == {"chunk_reduce": folds}
    assert ops.launch_counts() == dict(NO_LAUNCHES, chunk_reduce=folds)
    c.shutdown()


def test_dataplane_window_spans_carry_the_cards_completion(cuda):
    """A traced 32 MB f32 allreduce over 8 nodes on the card: every window
    span carries ``card_done``, resolved from its CUDA event against the
    recorder's anchors, at or after the window's advance (less the anchors'
    own uncertainty) and before the read; with the recorder off no event is
    made."""
    from repro_torch.core.api import SUM
    from repro_torch.core.local import LocalCluster

    n, elems = 8, (32 << 20) // 4
    c = LocalCluster(n)
    xs = [torch.randint(-1000, 1000, (elems,), generator=cuda, device="cuda").float() for _ in range(n)]
    for i, x in enumerate(xs):
        c.put(i, f"g{i}", x)
    ids = [f"g{i}" for i in range(n)]
    c.allreduce(list(range(n)), "off", ids, SUM, timeout=120.0)
    assert c.trace.events() == []
    s0 = c.stats
    c.trace.enable()
    c.allreduce(list(range(n)), "on", ids, SUM, timeout=120.0)
    c.trace.disable()
    s1 = c.stats
    t_read = time.perf_counter()
    windows = [e for e in c.trace.events() if e[4] == "window"]
    assert len(windows) == s1["windows"] - s0["windows"] > 0
    slack = max(half for _ev, _t, half in c.trace._anchors) + 1e-4
    for ts, _node, _tid, _cat, _name, dur, _oid, args in windows:
        assert isinstance(args["card_done"], float)
        assert ts + dur - slack <= args["card_done"] <= t_read + slack
    assert abs(c.trace.card_skew()) < 1e-2
    assert torch.equal(c.get(0, "on"), c.get(0, "off"))
    c.shutdown()


def test_serve_ensemble_on_the_card_folds_through_the_kernel(cuda):
    """Hoplite-Serve on the card: 8 replicas of a 1 MB f32 weight matrix,
    256 KB f32 payloads, a quorum of 5.  Each value is the mean of five
    equal replies x @ W within the folds' rounding, every SUM fold of the
    replies is one ``chunk_reduce`` launch, and the requests leave nothing
    behind."""
    from repro_torch.core.api import SUM
    from repro_torch.runtime import Runtime
    from repro_torch.serve import EnsembleConfig, EnsembleGroup

    rt = Runtime(num_nodes=8, executors_per_node=4)
    assert rt.cluster.device.type == "cuda"
    w = torch.randn(512, 512, generator=cuda, device="cuda") / 512 ** 0.5
    ens = EnsembleGroup(rt, lambda a, b: torch.matmul(b, a), EnsembleConfig(num_replicas=8, quorum=5))
    k = ens.config.quorum
    ens.deploy(w)
    weight_ids = {r.id for r in ens.deployment.held_refs()}

    def request_state():
        return (sum(1 for s in rt.cluster.stores for oid in s.objects if oid not in weight_ids),
                sum(1 for rid in rt._refs if rid not in weight_ids),
                sum(1 for rid in rt._lineage if rid not in weight_ids))

    before = request_state()
    SUM.reset_counts()
    ops.reset_launch_counts()
    folds0 = rt.cluster.stats["fold_ops"]
    xs = [torch.randn(128, 512, generator=cuda, device="cuda") for _ in range(6)]
    for x in xs:
        got = ens.handle_request(x)
        y = torch.matmul(x, w).double()
        assert got.device.type == "cuda" and got.dtype == torch.float32
        # k - 1 folds and the division: (k-1) u sum|y_i| / k + u |mean|, with k equal replies
        assert bool(((got.double() - y).abs() <= k * 2.0 ** -24 * y.abs()).all())
    folds = rt.cluster.stats["fold_ops"] - folds0 + ens.lineage_folds
    assert folds >= (k - 1) * len(xs) and SUM.counts == {"chunk_reduce": folds}
    assert ops.launch_counts() == dict(NO_LAUNCHES, chunk_reduce=folds)
    deadline = time.time() + 30.0
    while request_state() != before and time.time() < deadline:
        time.sleep(0.01)  # straggler replies are deleted as their tasks finish
    assert request_state() == before
    rt.cluster.shutdown()


@pytest.mark.parametrize("n", [300, 70_000])
@pytest.mark.parametrize("dtype", DTYPES)
def test_dequant_add_kernel_matches_plain(cuda, n, dtype):
    dst = torch.randn(n, generator=cuda, device="cuda").to(dtype)
    q, scale = compression.quantize_int8(torch.randn(n, generator=cuda, device="cuda"))
    q = q.reshape(-1)
    got = ops.dequant_add(dst, q, scale)
    torch.cuda.synchronize()
    want = ref.dequant_add_ref(dst, q, scale, 256)
    assert got.dtype == dtype and got.shape == dst.shape
    torch.testing.assert_close(got.float(), want.float(), **tol(dtype))
    assert torch.equal(got, want)
    assert ops.launch_counts() == dict(NO_LAUNCHES, dequant_add=1)


def test_hop_wrappers_refuse_what_the_kernels_do_not_take(cuda):
    x = torch.randn(8, 64, device="cuda")
    with pytest.raises(ValueError, match="contiguous"):
        tcr.chunk_reduce(x.t(), x.t())
    with pytest.raises(ValueError, match="must match"):
        tcr.chunk_reduce(x, x.bfloat16())
    with pytest.raises(TypeError):
        tcr.chunk_reduce(x.double(), x.double())
    with pytest.raises(TypeError):  # f16 takes chunk_reduce (the data plane's folds), not dequant_add
        tcr.dequant_add(torch.zeros(256, device="cuda").half(), torch.zeros(256, dtype=torch.int8, device="cuda"),
                        torch.ones(1, device="cuda"))
    q = torch.zeros(512, dtype=torch.int8, device="cuda")
    with pytest.raises(ValueError, match="do not fit"):
        tcr.dequant_add(torch.zeros(600, device="cuda"), q, torch.ones(2, device="cuda"))
    with pytest.raises(TypeError):
        tcr.dequant_add(torch.zeros(300, device="cuda"), q.float(), torch.ones(2, device="cuda"))
    assert ops.launch_counts() == NO_LAUNCHES


def test_ranks_on_the_card_launch_the_hop_and_match_the_cpu(cuda):
    """Four rank processes share the card: every hop is the CUDA kernel, as
    many times as hop_launches predicts, and the results are the CPU ranks'
    bit for bit."""
    x = np.random.RandomState(0).rand(4, 1536).astype(np.float32)
    gpu = G.run_ranks(cases.card_cases, 4, "cuda", x, timeout=300)
    cpu = G.run_ranks(cases.card_cases, 4, "cpu", x, timeout=300)
    pinned = C.CollectiveConfig(num_chunks=4)
    methods = {"chain_allreduce/4": "chain", "two_level_allreduce/4": "chain2d", "rs_ag_allreduce": "rs_ag"}
    for r, (g, c) in enumerate(zip(gpu, cpu)):
        for name, calls in g["calls"].items():
            assert calls["devices"] == ["cuda"]
            assert calls["launches"] == calls["chunk_reduce"]
            if name in methods:
                assert calls["launches"] == C.hop_launches(methods[name], 4, r, 1536 * 4, pinned)
            out, want = g["out"][name], c["out"][name]
            for a, b in (zip(out.values(), want.values()) if isinstance(out, dict) else [(out, want)]):
                assert torch.equal(a, b)
    assert sum(g["calls"]["chain_allreduce/4"]["launches"] for g in gpu) == 3 * 4


def test_run_ranks_on_the_card_by_default(cuda):
    out = G.run_ranks(cases.card_cases, 2, None, np.ones((2, 1536), np.float32), timeout=300)
    assert all(p["calls"]["rs_ag_allreduce"]["devices"] == ["cuda"] for p in out)


# ---------------------------------------------------------------------------
# the partitioner within a pod on the card: 8 rank processes, the staged backend
# ---------------------------------------------------------------------------


def _same_bits(a: torch.Tensor, b: torch.Tensor) -> bool:
    if a.dtype != b.dtype or a.shape != b.shape:
        return False
    if a.dtype == torch.bfloat16:
        a, b = a.view(torch.int16), b.view(torch.int16)
    return torch.equal(a, b)


def test_the_staged_backend_on_the_card_gives_gloos_bits(cuda):
    """Every collective a DTensor program issues, on CUDA tensors through the
    staged backend, against gloo's own on host copies of the same inputs:
    the same bits (f32, bf16, uneven all-to-all, an uneven DTensor)."""
    out = G.run_ranks(cases.staged_collective_cases, 8, "cuda", 0, timeout=600)
    for r, o in enumerate(out):
        bad = [k for k, (got, want) in o["cases"].items() if not _same_bits(got, want)]
        assert not bad, (r, bad)
        assert {"all_gather", "reduce_scatter", "all_reduce", "all_to_all"} <= set(o["counts"]), o["counts"]


def test_every_local_block_of_state_batch_and_caches_lies_on_cuda(cuda):
    out = G.run_ranks(cases.placed_devices, 8, "cuda", "qwen3-14b", timeout=600)
    for r, o in enumerate(out):
        assert o["mesh_device"] == "cuda" and o["refused"], (r, o)
        assert o["types"] == {"state": ["cuda"], "batch": ["cuda"], "caches": ["cuda"]}, (r, o["types"])
    assert [o["whole_leaves_held"] for o in out] == [1] + [0] * 7


def test_two_train_steps_on_the_card_mesh_match_one_process_on_the_card(cuda):
    """``launch.train.run`` on the card's (4, 2) mesh of 8 rank processes
    against one process on the card, reduced qwen3-14b in f32, 2
    microbatches: loss and gradient norm within 1e-5 relative; each
    parameter's update (final - initial) within 1e-3 of one process's in
    relative L2 and every element within lr (AdamW moves a weight by up to lr
    a step whatever its gradient's size, so an element whose gradient is at
    the f32 noise of sums in another order moves by a noisy fraction of lr);
    every rank launched the flash and RMSNorm kernels."""
    cfg = reduced_config(get_config("qwen3-14b"))
    shape = ShapeSpec("t", 16, 4, "train")
    opts = TS.TrainOptions(num_microbatches=2, remat="full", pod_sync="gspmd")
    state, recs = LT.run(cfg, shape, opts, "cuda", steps=2, log_every=1, log=lambda _: None, mesh=LT.mesh_for(8))
    one_state, one = LT.run(cfg, shape, opts, "cuda", steps=2, log_every=1, log=lambda _: None)
    for r, w in zip(recs, one):
        for key in ("loss", "grad_norm", "lr"):
            np.testing.assert_allclose(r[key], w[key], rtol=1e-5, err_msg=f"step {r['step']} {key}")
        for rank in r["ranks"]:
            assert rank["launches"]["rmsnorm"] > 0 and rank["launches"]["flash_attention_f32"] > 0, rank
            assert rank["peak_bytes"] > 0
    init = TS.init_state(cfg, 0, "cuda")["params"]  # the launcher's draw (seed 0) on the card
    lr = max(r["lr"] for r in one)  # the warmup's largest step
    for a, b, p0 in zip(leaves(state["params"]), leaves(one_state["params"]), leaves(init)):
        a, b, p0 = a.numpy(), b.cpu().numpy(), p0.cpu().numpy()
        du, dw = a - p0, b - p0
        assert np.abs(dw).max() > lr  # every leaf moved
        assert np.linalg.norm(du - dw) <= 1e-3 * np.linalg.norm(dw)
        np.testing.assert_allclose(a, b, rtol=0, atol=lr)
