"""The port's kernels on the CPU: their plain versions against the JAX
package's kernels (Pallas in interpret mode) and plain versions, over the
sweeps of tests/test_kernels.py, plus the dispatch and build rules.

The CUDA kernels themselves run only on the card: tests/test_torch_gpu.py.
"""

import ctypes
import re

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from repro.kernels import ops as jops
from repro.kernels import ref as jref
from repro.models import attention as jattn
from repro.optim.compression import quantize_int8
from repro_torch.configs import ARCHS, get_config, reduced_config
from repro_torch.kernels import _build
from repro_torch.kernels import chunk_reduce as tcr
from repro_torch.kernels import flash_attention as tfa
from repro_torch.kernels import ops as tops
from repro_torch.kernels import ref as tref
from repro_torch.kernels import rmsnorm as trn

DTYPES = ["float32", "bfloat16"]

FLASH_CASES = [
    # (B, H, Kh, Sq, Skv, D, causal, window), as tests/test_kernels.py
    (1, 2, 2, 128, 128, 64, True, 0),
    (2, 4, 2, 128, 128, 64, True, 0),     # GQA 2:1
    (1, 4, 1, 256, 256, 32, True, 0),     # MQA
    (1, 2, 2, 128, 128, 64, False, 0),    # bidirectional (encoder)
    (1, 2, 2, 256, 256, 64, True, 64),    # sliding window
    (1, 2, 1, 64, 512, 64, True, 0),      # Sq != Skv
]

# The tensor-core route's head dims that FLASH_CASES does not reach (it takes
# every multiple of 16 up to 256; the kernel pads D to a multiple of 64 in
# shared memory): the plain version, the card's yardstick for those
# instances, against the Pallas kernel in interpret mode.
HEAD_DIM_CASES = [
    # (B, H, Kh, Sq, Skv, D, causal, window)
    (1, 4, 2, 128, 128, 16, True, 0),
    (1, 4, 2, 128, 128, 48, True, 0),
    (1, 4, 2, 128, 128, 80, True, 0),
    (1, 4, 2, 128, 128, 96, True, 0),
    (1, 4, 2, 128, 128, 112, True, 0),
    (1, 4, 4, 128, 128, 80, True, 0),     # MHA at D = 80, as stablelm-3b's heads
]
# Past 128 the kernel holds D in three or four 64-column boxes (DP = 192 for
# D = 144 and 192, DP = 256 for 208 and 256) and takes kv tiles of 64 rows:
# each such D causal with GQA (Kh < H), and windowed.
WIDE_HEAD_DIM_CASES = [
    case for D in (144, 192, 208, 256)
    for case in ((1, 4, 2, 128, 128, D, True, 0), (1, 2, 1, 256, 256, D, True, 64))
]

# Shapes the Pallas kernel cannot take (it asserts tile divisibility), held
# against the JAX package's plain version: ragged lengths, a prompt of 513
# tokens (prefill of prompt + first token), and rows with no visible key.
RAGGED_CASES = [
    # (B, H, Kh, Sq, Skv, D, causal, window, q_offset)
    (2, 4, 1, 100, 100, 16, True, 0, 0),
    (1, 5, 1, 33, 33, 48, True, 0, 0),
    (1, 2, 1, 7, 70, 32, True, 0, 63),
    (1, 2, 2, 40, 40, 32, True, 5, 0),
    (1, 2, 2, 16, 16, 32, True, 0, -4),   # first 4 rows see no key: zeros
    (1, 4, 1, 513, 513, 16, True, 0, 0),
    (1, 4, 2, 100, 300, 256, False, 0, 0),  # bidirectional, Sq != Skv, D = 256
]

RMSNORM_SHAPES = [(4, 64), (3, 7, 256), (1000, 128)]

NO_LAUNCHES = {"rmsnorm": 0, "flash_attention_tc": 0, "flash_attention_cores": 0, "chunk_reduce": 0,
               "dequant_add": 0}


def tol(dtype):
    """tests/test_kernels.py:16-17."""
    return dict(rtol=2e-2, atol=2e-2) if dtype == "bfloat16" else dict(rtol=2e-5, atol=2e-5)


def both(a: np.ndarray, dtype: str):
    """The same numbers as a JAX array and a torch tensor of ``dtype``."""
    j = jnp.asarray(a, getattr(jnp, dtype))
    t = torch.from_numpy(np.array(j, np.float32)).to(getattr(torch, dtype))  # exact
    return j, t


def f32(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        return x.float().numpy()
    return np.asarray(x, np.float32)


def flash_inputs(B, H, Kh, Sq, Skv, D, dtype, seed=0):
    rng = np.random.RandomState(seed)
    q = rng.randn(B, H, Sq, D) / np.sqrt(D)
    k = rng.randn(B, Kh, Skv, D) / np.sqrt(D)
    v = rng.randn(B, Kh, Skv, D)
    return both(q, dtype), both(k, dtype), both(v, dtype)


@pytest.fixture(autouse=True)
def _zero_counts():
    tops.reset_launch_counts()
    yield
    tops.reset_launch_counts()


@pytest.mark.parametrize("case", FLASH_CASES + HEAD_DIM_CASES + WIDE_HEAD_DIM_CASES)
@pytest.mark.parametrize("dtype", DTYPES)
def test_flash_ref_matches_jax_kernel(case, dtype):
    B, H, Kh, Sq, Skv, D, causal, window = case
    (jq, q), (jk, k), (jv, v) = flash_inputs(B, H, Kh, Sq, Skv, D, dtype)
    q_offset = Skv - Sq if Sq != Skv else 0
    want = jops.flash_attention(jq, jk, jv, causal, window, q_offset)
    got = tref.flash_attention_ref(q, k, v, causal, window, q_offset)
    assert got.dtype == getattr(torch, dtype) and got.shape == (B, H, Sq, D)
    np.testing.assert_allclose(f32(got), f32(want), **tol(dtype))


@pytest.mark.parametrize("case", WIDE_HEAD_DIM_CASES)
@pytest.mark.parametrize("dtype", DTYPES)
def test_flash_ref_lse_matches_jax_at_wide_head_dims(case, dtype):
    """The lse of the plain version (the card's yardstick for the wide
    instances' lse) against the JAX package's ``_flash_fwd_impl``, which
    saves ``m + log(l)`` for its backward; the output too."""
    B, H, Kh, Sq, Skv, D, causal, window = case
    (jq, q), (jk, k), (jv, v) = flash_inputs(B, H, Kh, Sq, Skv, D, dtype, seed=2)
    pos = jnp.arange(Sq, dtype=jnp.int32)
    out_j, lse_j = jattn._flash_fwd_impl(jq.reshape(B, Kh, H // Kh, Sq, D), jk, jv, pos, pos, causal, window)
    out_t, lse_t = tref.flash_attention_ref(q, k, v, causal, window, 0, return_lse=True)
    assert lse_t.dtype == torch.float32 and lse_t.shape == (B, H, Sq)
    np.testing.assert_allclose(f32(lse_t), np.asarray(lse_j).reshape(B, H, Sq), **tol(dtype))
    np.testing.assert_allclose(f32(out_t), f32(out_j).reshape(B, H, Sq, D), **tol(dtype))


@pytest.mark.parametrize("case", [c + (c[4] - c[3],) for c in FLASH_CASES] + RAGGED_CASES)
@pytest.mark.parametrize("dtype", DTYPES)
def test_flash_ops_on_cpu_matches_jax_ref(case, dtype):
    B, H, Kh, Sq, Skv, D, causal, window, q_offset = case
    (jq, q), (jk, k), (jv, v) = flash_inputs(B, H, Kh, Sq, Skv, D, dtype, seed=1)
    want = jref.flash_attention_ref(jq, jk, jv, causal, window, q_offset)
    got = tops.flash_attention(q, k, v, causal, window, q_offset)
    np.testing.assert_allclose(f32(got), f32(want), **tol(dtype))
    assert tops.launch_counts() == NO_LAUNCHES


def test_flash_fully_masked_rows_are_zero():
    (_, q), (_, k), (_, v) = flash_inputs(1, 2, 2, 16, 16, 32, "float32")
    out = tops.flash_attention(q, k, v, True, 0, -4)
    assert torch.all(out[:, :, :4] == 0) and torch.all(out[:, :, 4:].abs().sum(-1) > 0)


@pytest.mark.parametrize("shape", RMSNORM_SHAPES)
@pytest.mark.parametrize("dtype", DTYPES)
def test_rmsnorm_ref_matches_jax_kernel(shape, dtype):
    rng = np.random.RandomState(4)
    jx, x = both(rng.randn(*shape), dtype)
    jw, w = both(rng.randn(shape[-1]) * 0.1, dtype)
    want = jops.rmsnorm(jx, jw)
    got = tref.rmsnorm_ref(x, w)
    assert got.dtype == x.dtype and got.shape == x.shape
    np.testing.assert_allclose(f32(got), f32(want), **tol(dtype))


@pytest.mark.parametrize("shape", RMSNORM_SHAPES + [(5, 16383)])
@pytest.mark.parametrize("dtype", DTYPES)
def test_rmsnorm_ops_on_cpu_matches_jax_ref(shape, dtype):
    rng = np.random.RandomState(5)
    jx, x = both(rng.randn(*shape), dtype)
    jw, w = both(rng.randn(shape[-1]) * 0.1, "float32")  # w keeps its own type
    want = jref.rmsnorm_ref(jx, jw)
    got = tops.rmsnorm(x, w)
    np.testing.assert_allclose(f32(got), f32(want), **tol(dtype))
    assert tops.launch_counts() == NO_LAUNCHES


# ---------------------------------------------------------------------------
# chunk_reduce and dequant_add (tests/test_kernels.py:71-100)
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("n", [17, 4096, 100_000])
@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("alpha", [1.0, 0.5])
def test_chunk_reduce_ref_matches_jax_kernel(n, dtype, alpha):
    rng = np.random.RandomState(2)
    jd, d = both(rng.randn(n), dtype)
    js, s = both(rng.randn(n), dtype)
    want = jops.chunk_reduce(jd, js, alpha=alpha)
    got = tref.chunk_reduce_ref(d, s, alpha)
    assert got.dtype == d.dtype and got.shape == d.shape
    np.testing.assert_allclose(f32(got), f32(want), **tol(dtype))
    np.testing.assert_array_equal(f32(got), f32(jref.chunk_reduce_ref(jd, js, alpha)))  # same roundings


@pytest.mark.parametrize("n", [17, 4096, 100_000])
@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("alpha", [1.0, 0.5])
@pytest.mark.parametrize("into", ["new", "dst"])
def test_chunk_reduce_ops_on_cpu(n, dtype, alpha, into):
    rng = np.random.RandomState(3)
    jd, d = both(rng.randn(n), dtype)
    js, s = both(rng.randn(n), dtype)
    want = f32(jref.chunk_reduce_ref(jd, js, alpha))
    got = tops.chunk_reduce(d, s, alpha, out=d if into == "dst" else None)
    assert (got is d) == (into == "dst")
    np.testing.assert_array_equal(f32(got), want)
    assert tops.launch_counts() == NO_LAUNCHES


@pytest.mark.parametrize("n", [300, 70_000])
def test_dequant_add_ref_matches_jax_kernel(n):
    rng = np.random.RandomState(3)
    dst = rng.randn(n).astype(np.float32)
    q, scale = quantize_int8(jnp.asarray(rng.randn(n), jnp.float32))
    q = q.reshape(-1)
    want = jops.dequant_add(jnp.asarray(dst), q, scale)
    got = tops.dequant_add(torch.from_numpy(dst), torch.from_numpy(np.array(q)), torch.from_numpy(np.array(scale)))
    np.testing.assert_allclose(f32(got), np.asarray(want), rtol=1e-5, atol=1e-5)
    np.testing.assert_array_equal(f32(got), np.asarray(jref.dequant_add_ref(jnp.asarray(dst), q, scale, 256)))
    assert tops.launch_counts() == NO_LAUNCHES


def test_dequant_add_ref_keeps_bf16():
    rng = np.random.RandomState(5)
    jd, d = both(rng.randn(2, 150), "bfloat16")
    q, scale = quantize_int8(jnp.asarray(rng.randn(300), jnp.float32))
    q = q.reshape(-1)
    want = jref.dequant_add_ref(jd, q, scale, 256)
    got = tref.dequant_add_ref(d, torch.from_numpy(np.array(q)), torch.from_numpy(np.array(scale)), 256)
    assert got.dtype == torch.bfloat16 and got.shape == (2, 150)
    np.testing.assert_array_equal(f32(got), f32(want))


# ---------------------------------------------------------------------------
# rules: no fallback, no build at import, a missing toolkit raises
# ---------------------------------------------------------------------------


def test_kernel_wrappers_refuse_cpu_tensors():
    x = torch.randn(4, 8)
    with pytest.raises(ValueError, match="CUDA"):
        trn.rmsnorm(x, torch.zeros(8))
    q = torch.randn(1, 2, 8, 16)
    with pytest.raises(ValueError, match="CUDA"):
        tfa.flash_attention_fwd(q, q[:, :1].contiguous(), q[:, :1].contiguous())
    with pytest.raises(ValueError, match="CUDA"):
        tcr.chunk_reduce(x, x)
    with pytest.raises(ValueError, match="CUDA"):
        tcr.dequant_add(torch.zeros(256), torch.zeros(256, dtype=torch.int8), torch.ones(1))
    assert tops.launch_counts() == NO_LAUNCHES


def test_ops_send_non_cpu_tensors_to_the_kernel():
    """A tensor off the CPU never takes the plain version: here (meta) the
    kernel wrapper refuses it instead of computing anything."""
    x = torch.empty(4, 8, device="meta")
    with pytest.raises(ValueError, match="CUDA"):
        tops.rmsnorm(x, torch.empty(8, device="meta"))
    q = torch.empty(1, 2, 8, 16, device="meta")
    with pytest.raises(ValueError, match="CUDA"):
        tops.flash_attention(q, q, q)
    with pytest.raises(ValueError, match="CUDA"):
        tops.chunk_reduce(x, x)
    with pytest.raises(ValueError, match="CUDA"):
        tops.dequant_add(torch.empty(256, device="meta"), torch.empty(256, dtype=torch.int8, device="meta"),
                         torch.empty(1, device="meta"))


def test_build_raises_without_nvcc(monkeypatch, tmp_path):
    monkeypatch.setenv("PATH", str(tmp_path))
    monkeypatch.delenv("CUDA_HOME", raising=False)
    monkeypatch.setattr(_build, "TOOLKIT_NVCC", str(tmp_path / "nvcc"))
    monkeypatch.setattr(_build, "BUILD_ROOT", tmp_path / "build")
    with pytest.raises(RuntimeError, match="nvcc not found"):
        _build.build()
    assert not (tmp_path / "build").exists()


C_TYPES = {"const void*": ctypes.c_void_p, "void*": ctypes.c_void_p, "int": ctypes.c_int,
           "long long": ctypes.c_longlong, "float": ctypes.c_float}


@pytest.mark.parametrize("wrapper,name", [(trn, "rmsnorm_fwd"), (tfa, "flash_attention_fwd"),
                                          (tfa, "flash_attention_fwd_sm90"),
                                          (tcr, "chunk_reduce_fwd"), (tcr, "dequant_add_fwd")])
def test_ctypes_signature_matches_the_c_interface(wrapper, name):
    """The wrapper's argtypes follow the extern "C" prototype in csrc/, one
    for one: ctypes would otherwise pass a pointer cut to 32 bits or refuse.
    A wrapper of several entry points keeps a dict of them by name."""
    src = "\n".join(p.read_text() for p in sorted(_build.CSRC.glob("*.cu")))
    proto = re.search(r'extern "C" int ' + name + r"\(([^)]*)\)", src).group(1)
    params = [" ".join(p.split()[:-1]).replace(" *", "*") for p in proto.split(",")]
    argtypes = wrapper.ARGTYPES[name] if isinstance(wrapper.ARGTYPES, dict) else wrapper.ARGTYPES
    assert [C_TYPES[p] for p in params] == argtypes


def test_ctypes_signatures_cover_every_entry_point():
    """Every extern "C" function in csrc/ has its argtypes in a wrapper."""
    src = "\n".join(p.read_text() for p in sorted(_build.CSRC.glob("*.cu")))
    names = set(re.findall(r'extern "C" int (\w+)\(', src))
    bound = {"rmsnorm_fwd"} | set(tfa.ARGTYPES) | set(tcr.ARGTYPES)
    assert names == bound


def test_build_key_covers_every_source(monkeypatch, tmp_path):
    """Every source is built, and the key moves with any source or header."""
    assert {p.stem for p in _build.CSRC.glob("*.cu")} == set(_build.SOURCES)
    csrc = tmp_path / "csrc"
    csrc.mkdir()
    for p in _build.CSRC.iterdir():
        (csrc / p.name).write_bytes(p.read_bytes())
    monkeypatch.setattr(_build, "CSRC", csrc)
    keys = [_build._build_dir()]
    (csrc / "common.cuh").write_text("// a header\n")
    keys.append(_build._build_dir())
    (csrc / "common.cuh").write_text("// a header, changed\n")
    keys.append(_build._build_dir())
    (csrc / "flash_attention_sm90.cu").write_text((csrc / "flash_attention_sm90.cu").read_text() + "\n")
    keys.append(_build._build_dir())
    assert len(set(keys)) == 4


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32, torch.float16])
@pytest.mark.parametrize("D", range(16, 257, 16))
def test_flash_route_is_a_function_of_dtype_and_head_dim(dtype, D):
    """bf16 at every D the kernels take (a multiple of 16 up to 256) takes
    the tensor cores; f32 (held to 2e-5) at every D takes the exact
    CUDA-core kernel."""
    want = "tc" if dtype == torch.bfloat16 else "cores"
    assert tfa.route(dtype, D) == want


@pytest.mark.parametrize("arch", sorted(ARCHS))
def test_flash_routes_of_the_configs(arch):
    """Every registered config (bf16, head dim 80 to 128) takes the tensor
    cores; its reduced config (f32, head dim 16) the CUDA cores."""
    cfg = get_config(arch)
    assert cfg.dtype == "bfloat16" and cfg.head_dim % 16 == 0 and cfg.head_dim <= 128
    assert tfa.route(getattr(torch, cfg.dtype), cfg.head_dim) == "tc"
    small = reduced_config(cfg)
    assert tfa.route(getattr(torch, small.dtype), small.head_dim) == "cores"
