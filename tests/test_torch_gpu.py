"""The port's CUDA kernels and serve path on the card.

Every test here needs a CUDA device (marker ``gpu``) and skips without one;
on the card they run with

    PYTHONPATH=src python -m pytest -q -m gpu tests/test_torch_gpu.py

This file imports no JAX (the card's machine has none): the kernels are held
against the port's plain versions, which tests/test_torch_kernels.py holds
against the JAX package on the CPU.
"""

import numpy as np
import pytest
import torch

from repro_torch.configs import get_config, reduced_config
from repro_torch.kernels import flash_attention as tfa
from repro_torch.kernels import ops, ref
from repro_torch.kernels import rmsnorm as trn
from repro_torch.launch import serve
from repro_torch.models import transformer as T
from repro_torch.models.common import init_params
from repro_torch.serving.engine import Engine, ServeOptions

pytestmark = pytest.mark.gpu

DTYPES = [torch.float32, torch.bfloat16]
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


@pytest.mark.parametrize("case", FLASH_CASES)
@pytest.mark.parametrize("dtype", DTYPES)
def test_flash_kernel_matches_plain(cuda, case, dtype):
    B, H, Kh, Sq, Skv, D, causal, window, off = case
    q = (torch.randn(B, H, Sq, D, generator=cuda, device="cuda") / D ** 0.5).to(dtype)
    k = (torch.randn(B, Kh, Skv, D, generator=cuda, device="cuda") / D ** 0.5).to(dtype)
    v = torch.randn(B, Kh, Skv, D, generator=cuda, device="cuda").to(dtype)
    got = ops.flash_attention(q, k, v, causal, window, off)
    torch.cuda.synchronize()
    want = ref.flash_attention_ref(q, k, v, causal, window, off)
    assert got.dtype == dtype and got.shape == q.shape
    torch.testing.assert_close(got.float(), want.float(), **tol(dtype))
    assert ops.launch_counts() == {"rmsnorm": 0, "flash_attention": 1}


@pytest.mark.parametrize("shape", [(4, 64), (3, 7, 256), (1000, 128), (2048, 5120), (5, 16383), (2, 1025)])
@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("wdtype", DTYPES)
def test_rmsnorm_kernel_matches_plain(cuda, shape, dtype, wdtype):
    x = torch.randn(shape, generator=cuda, device="cuda").to(dtype)
    w = (torch.randn(shape[-1], generator=cuda, device="cuda") * 0.1).to(wdtype)
    got = ops.rmsnorm(x, w)
    torch.cuda.synchronize()
    assert got.dtype == dtype and got.shape == x.shape
    torch.testing.assert_close(got.float(), ref.rmsnorm_ref(x, w).float(), **tol(dtype))
    assert ops.launch_counts() == {"rmsnorm": 1, "flash_attention": 0}


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
    assert ops.launch_counts() == {"rmsnorm": 0, "flash_attention": 0}


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
    toks = torch.from_numpy(serve.random_prompts(cfg, 2, 13, 1))
    cl, cc = T.prefill(cfg, params, {"tokens": toks}, 24)
    gl, gc = T.prefill(cfg, gparams, {"tokens": toks.cuda()}, 24)
    torch.testing.assert_close(gl.cpu(), cl, rtol=1e-4, atol=1e-4)
    for t in range(13, 17):
        tok = cl[:, : cfg.vocab_size].argmax(-1)[:, None]
        cl, cc = T.decode_step(cfg, params, tok, t, cc)
        gl, gc = T.decode_step(cfg, gparams, tok.cuda(), t, gc)
        torch.testing.assert_close(gl.cpu(), cl, rtol=1e-4, atol=1e-4)
    counts = ops.launch_counts()
    assert counts["flash_attention"] == cfg.num_layers and counts["rmsnorm"] == 5 * 2 + 1 + 4 * (4 * 2 + 1)
    opts = ServeOptions(max_seq=32, batch_size=2)
    got = Engine(cfg, gparams, opts).generate({"tokens": toks}, 6)
    want = Engine(cfg, params, opts).generate({"tokens": toks}, 6)
    np.testing.assert_array_equal(got, want)


def test_serve_main_defaults_to_the_card(cuda, capsys):
    out = serve.main(["--arch", "qwen3-14b", "--reduced", "--batch", "2", "--new-tokens", "4"])
    assert out.shape == (2, 4)
    assert torch.cuda.get_device_name() in capsys.readouterr().out
    assert ops.launch_counts()["flash_attention"] == 2
