"""The port's configs and model modules against the JAX package's, on the CPU.

Weights are drawn once by the JAX package (``init_params`` in f32), their
norm weights replaced by non-zero numbers from a numpy seed (zeros would hide
the ``1 + w``), and carried to the port by ``convert.params_from_jax``.
Tolerance 1e-5 in f32: both sides do the same f32 arithmetic, in other orders.
"""

import dataclasses

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from repro import configs as jconfigs
from repro.models import attention as jattn
from repro.models import common as jcommon
from repro.models import moe as jmoe
from repro.models import transformer as JT
from repro_torch import configs as tconfigs
from repro_torch import convert
from repro_torch.configs.base import LayerSpec
from repro_torch.models import attention as tattn
from repro_torch.models import common as tcommon
from repro_torch.models import moe as tmoe
from repro_torch.models import transformer as TT

TOL = dict(rtol=1e-5, atol=1e-5)
NORMS = ("ln1", "ln2", "ln_cross", "final_norm", "q_norm", "k_norm")


def perturbed_jax_params(cfg, seed=0):
    """JAX-initialised f32 weights as numpy, with random non-zero norm weights."""
    tree = jcommon.init_params(JT.model_skel(cfg), jax.random.PRNGKey(seed), dtype_override=jnp.float32)
    rng = np.random.RandomState(seed)

    def fix(path, a):
        a = np.array(a)
        names = [getattr(k, "key", None) for k in path]
        if any(n in NORMS for n in names):
            a = (rng.randn(*a.shape) * 0.3).astype(a.dtype)
        return a

    return jax.tree_util.tree_map_with_path(fix, tree)


@pytest.fixture(scope="module", params=[1, 2], ids=["kv1", "kv2"])
def small(request):
    """reduced qwen3-14b (1 kv head for 4 q heads), and a variant with 2 kv
    heads, where a swap of the K and G axes in the head layout h = k*G + g
    would show."""
    kv = dict(num_kv_heads=request.param)
    cfg = dataclasses.replace(tconfigs.reduced_config(tconfigs.get_config("qwen3-14b")), **kv)
    jcfg = dataclasses.replace(jconfigs.reduced_config(jconfigs.get_config("qwen3-14b")), **kv)
    np_params = perturbed_jax_params(jcfg)
    jparams = jax.tree_util.tree_map(jnp.asarray, np_params)
    tparams = convert.params_from_jax(np_params, cfg, device="cpu")
    return cfg, jcfg, jparams, tparams


def layer0(tree, *keys):
    node = tree["stages"][0]["pos0"]
    for k in keys:
        node = node[k]
    return jax.tree_util.tree_map(lambda a: a[0], node)


def np32(x):
    return x.detach().float().numpy() if isinstance(x, torch.Tensor) else np.asarray(x, np.float32)


# ---------------------------------------------------------------------------
# configs and parameter trees
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("reduced", [False, True])
@pytest.mark.parametrize("arch", sorted(tconfigs.ARCHS))
def test_config_copy_equals_jax(arch, reduced):
    t = tconfigs.get_config(arch)
    j = jconfigs.get_config(arch)
    if reduced:
        t, j = tconfigs.reduced_config(t), jconfigs.reduced_config(j)
    assert dataclasses.asdict(t) == dataclasses.asdict(j)
    assert t.param_count() == j.param_count()
    assert (t.padded_vocab, t.num_blocks, t.q_dim, t.kv_dim) == (j.padded_vocab, j.num_blocks, j.q_dim, j.kv_dim)


def test_full_width_param_count():
    assert round(tconfigs.get_config("qwen3-14b").param_count() / 1e9, 2) == 14.77


@pytest.mark.parametrize("reduced", [False, True])
@pytest.mark.parametrize("arch", sorted(tconfigs.ARCHS))
def test_skeleton_matches_jax(arch, reduced):
    """Same leaf names, shapes, logical axes and init rule (no allocation):
    LayerNorm's ones and zeros, the gelu FFN's two weights."""
    cfg = tconfigs.get_config(arch)
    jcfg = jconfigs.get_config(arch)
    if reduced:
        cfg, jcfg = tconfigs.reduced_config(cfg), jconfigs.reduced_config(jcfg)
    jleaves = jax.tree_util.tree_flatten_with_path(JT.model_skel(jcfg), is_leaf=jcommon.is_param)[0]
    want = {jax.tree_util.keystr(p): (l.shape, l.axes, l.init, l.scale, jnp.dtype(l.dtype).name) for p, l in jleaves}
    got = {}

    def walk(node, path):
        if tcommon.is_param(node):
            got[path] = (node.shape, node.axes, node.init, node.scale, node.dtype)
        elif isinstance(node, dict):
            for k, v in node.items():
                walk(v, f"{path}[{k!r}]")
        else:
            for i, v in enumerate(node):
                walk(v, f"{path}[{i}]")

    walk(TT.model_skel(cfg), "")
    assert got == want


def test_init_params_std_rule_and_seed():
    cfg = tconfigs.reduced_config(tconfigs.get_config("qwen3-14b"))
    skel = TT.model_skel(cfg)
    a = tcommon.init_params(skel, torch.Generator().manual_seed(3), device="cpu", dtype_override="float32")
    b = tcommon.init_params(skel, torch.Generator().manual_seed(3), device="cpu", dtype_override="float32")
    assert torch.equal(a["embed"], b["embed"])
    assert torch.all(a["final_norm"]["w"] == 0) and torch.all(a["stages"][0]["pos0"]["attn"]["q_norm"] == 0)
    for leaf in (a["embed"], a["stages"][0]["pos0"]["ffn"]["wi"]):
        want = 1.0 / np.sqrt(leaf.shape[-2])
        assert abs(float(leaf.std()) / want - 1) < 0.03
    bf = tcommon.init_params(skel, torch.Generator().manual_seed(3), device="cpu")
    assert bf["embed"].dtype == torch.bfloat16  # the skeleton's own type


def test_init_params_defaults_to_the_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    cfg = tconfigs.reduced_config(tconfigs.get_config("qwen3-14b"))
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tcommon.init_params(TT.model_skel(cfg), torch.Generator())


def test_convert_keeps_bf16_and_checks_the_tree():
    cfg = tconfigs.reduced_config(tconfigs.get_config("qwen3-14b"))
    jcfg = jconfigs.reduced_config(jconfigs.get_config("qwen3-14b"))
    tree = jax.tree_util.tree_map(np.asarray, jcommon.init_params(JT.model_skel(jcfg), jax.random.PRNGKey(1)))
    p = convert.params_from_jax(tree, cfg, device="cpu")
    wq = p["stages"][0]["pos0"]["attn"]["wq"]
    assert wq.dtype == torch.bfloat16 and wq.shape == (2, 64, 64)
    np.testing.assert_array_equal(wq.float().numpy(), np.asarray(tree["stages"][0]["pos0"]["attn"]["wq"], np.float32))
    assert convert.params_from_jax(tree, cfg, device="cpu", dtype="float32")["embed"].dtype == torch.float32
    bad = dict(tree, extra=np.zeros(1))
    with pytest.raises(ValueError, match="keys"):
        convert.params_from_jax(bad, cfg, device="cpu")
    bad = dict(tree, embed=np.zeros((3, 3)))
    with pytest.raises(ValueError, match="shape"):
        convert.params_from_jax(bad, cfg, device="cpu")


# An encoder and cross-attention (whisper's) over each kind of decoder layer:
# attention and Mamba layers take a cross-attention block, RWKV blocks none.
ENCODER = dict(encoder_layers=2, encoder_seq=32)
ENCODER_OVER = {
    "attn": ENCODER,
    "mamba": dict(pattern=(LayerSpec(kind="mamba"),), **ENCODER),
    "rwkv": dict(pattern=(LayerSpec(kind="rwkv"),), **ENCODER),
}


@pytest.mark.parametrize("what", sorted(ENCODER_OVER))
def test_encoder_over_each_decoder_kind_matches_jax(what):
    """reduced qwen3 (RMSNorm, qk-norm, RoPE) with an encoder of 2 layers over
    32 frames, its decoder layers attention, Mamba or RWKV: ``forward``,
    prefill and two decode steps in f32 against the JAX package, and the
    cross caches only where the reference has them (none for RWKV)."""
    changes = ENCODER_OVER[what]
    cfg = dataclasses.replace(tconfigs.reduced_config(tconfigs.get_config("qwen3-14b")), **changes)
    jcfg = dataclasses.replace(jconfigs.reduced_config(jconfigs.get_config("qwen3-14b")), **changes)
    np_params = perturbed_jax_params(jcfg)
    jp = jax.tree_util.tree_map(jnp.asarray, np_params)
    tp = convert.params_from_jax(np_params, cfg, device="cpu")
    assert ("cross" in tp["stages"][0]["pos0"]) == (what != "rwkv")
    rng = np.random.RandomState(3)
    toks = rng.randint(0, cfg.vocab_size, (2, 12)).astype(np.int32)
    frames = rng.randn(2, 32, cfg.d_model).astype(np.float32)
    tol = lambda w: dict(rtol=2e-5, atol=2e-5 * max(1.0, float(np.abs(np32(w)).max())))
    jl, _ = JT.forward(jcfg, jp, {"tokens": jnp.asarray(toks), "encoder_frames": jnp.asarray(frames)})
    tl, _ = TT.forward(cfg, tp, {"tokens": torch.from_numpy(toks), "encoder_frames": torch.from_numpy(frames)})
    np.testing.assert_allclose(np32(tl), np32(jl), **tol(jl))
    jl, jc = JT.prefill(jcfg, jp, {"tokens": jnp.asarray(toks[:, :10]), "encoder_frames": jnp.asarray(frames)}, 16)
    tl, tc = TT.prefill(cfg, tp, {"tokens": torch.from_numpy(toks[:, :10]),
                                  "encoder_frames": torch.from_numpy(frames)}, 16)
    np.testing.assert_allclose(np32(tl), np32(jl), **tol(jl))
    assert ("cross_k" in tc[0]["pos0"]) == ("cross_k" in jc[0]["pos0"]) == (what != "rwkv")
    for t in (10, 11):
        jl, jc = JT.decode_step(jcfg, jp, jnp.asarray(toks[:, t : t + 1]), jnp.int32(t), jc)
        tl, tc = TT.decode_step(cfg, tp, torch.from_numpy(toks[:, t : t + 1]), t, tc)
        np.testing.assert_allclose(np32(tl), np32(jl), **tol(jl), err_msg=f"decode at {t}")


# ---------------------------------------------------------------------------
# modules
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("shape", [(2, 5, 64), (2, 5, 1, 4, 16), (7, 128)])
def test_common_rmsnorm_with_nonzero_weight(shape):
    rng = np.random.RandomState(6)
    x = rng.randn(*shape).astype(np.float32)
    w = (rng.randn(shape[-1]) * 0.5).astype(np.float32)
    want = jcommon.rmsnorm(jnp.asarray(x), jnp.asarray(w))
    got = tcommon.rmsnorm(torch.from_numpy(x), torch.from_numpy(w))
    np.testing.assert_allclose(np32(got), np32(want), **TOL)


@pytest.mark.parametrize("theta,offset", [(1e4, 0), (1e6, 0), (1e6, 500)])
def test_apply_rope(theta, offset):
    rng = np.random.RandomState(7)
    x = rng.randn(2, 9, 3, 16).astype(np.float32)
    pos = (np.arange(9) + offset)[None, :]
    want = jcommon.apply_rope(jnp.asarray(x), jnp.asarray(pos, jnp.int32), theta)
    got = tcommon.apply_rope(torch.from_numpy(x), torch.from_numpy(pos), theta)
    np.testing.assert_allclose(np32(got), np32(want), **TOL)


def _hidden(cfg, B, S, seed):
    return np.random.RandomState(seed).randn(B, S, cfg.d_model).astype(np.float32)


@pytest.mark.parametrize("S", [16, 13])
def test_attention_fwd(small, S):
    cfg, jcfg, jp, tp = small
    x = _hidden(cfg, 2, S, 8)
    spec = cfg.pattern[0]
    want = jattn.attention_fwd(jcfg, layer0(jp, "attn"), jnp.asarray(x), jcfg.pattern[0], jnp.arange(S, dtype=jnp.int32))
    got = tattn.attention_fwd(cfg, layer0(tp, "attn"), torch.from_numpy(x), spec, torch.arange(S))
    np.testing.assert_allclose(np32(got), np32(want), **TOL)


def test_attention_prefill_kv(small):
    cfg, jcfg, jp, tp = small
    x = _hidden(cfg, 2, 11, 9)
    jk, jv = jattn.attention_prefill_kv(jcfg, layer0(jp, "attn"), jnp.asarray(x), jnp.arange(11, dtype=jnp.int32))
    tk, tv = tattn.attention_prefill_kv(cfg, layer0(tp, "attn"), torch.from_numpy(x), torch.arange(11))
    np.testing.assert_allclose(np32(tk), np32(jk), **TOL)
    np.testing.assert_allclose(np32(tv), np32(jv), **TOL)


@pytest.mark.parametrize("t", [0, 5, 15])
def test_attention_decode_linear_cache(small, t):
    cfg, jcfg, jp, tp = small
    B, C, K, D = 2, 16, cfg.num_kv_heads, cfg.head_dim
    rng = np.random.RandomState(10 + t)
    x = rng.randn(B, 1, cfg.d_model).astype(np.float32)
    kc = rng.randn(B, C, K, D).astype(np.float32)
    vc = rng.randn(B, C, K, D).astype(np.float32)
    jout, (jkc, jvc) = jattn.attention_decode(
        jcfg, layer0(jp, "attn"), jnp.asarray(x), jcfg.pattern[0], (jnp.asarray(kc), jnp.asarray(vc)), jnp.int32(t))
    tk, tv = torch.from_numpy(kc.copy()), torch.from_numpy(vc.copy())
    tout, (tkc, tvc) = tattn.attention_decode(cfg, layer0(tp, "attn"), torch.from_numpy(x), cfg.pattern[0], (tk, tv), t)
    assert tkc is tk and tvc is tv  # updated in place
    np.testing.assert_allclose(np32(tout), np32(jout), **TOL)
    np.testing.assert_allclose(np32(tkc), np32(jkc), **TOL)
    np.testing.assert_allclose(np32(tvc), np32(jvc), **TOL)


def test_ffn_fwd(small):
    cfg, jcfg, jp, tp = small
    x = _hidden(cfg, 2, 6, 11)
    want = jmoe.ffn_fwd(jcfg, layer0(jp, "ffn"), jnp.asarray(x))
    got = tmoe.ffn_fwd(cfg, layer0(tp, "ffn"), torch.from_numpy(x))
    np.testing.assert_allclose(np32(got), np32(want), **TOL)


@pytest.mark.parametrize("tied", [False, True], ids=["lm_head", "tied"])
def test_unembed_is_an_f32_product_of_bf16_operands(tied):
    """Logits of bf16 activations and weights: the JAX package asks its dot
    for an f32 result, so the port may not round the product to bf16 first
    (that differs by about 2^-9 relative)."""
    cfg = tconfigs.reduced_config(tconfigs.get_config("qwen3-14b"))
    rng = np.random.RandomState(12)
    x = jnp.asarray(rng.randn(2, 3, cfg.d_model), jnp.bfloat16)
    w = jnp.asarray(rng.randn(cfg.d_model, cfg.padded_vocab) / 8, jnp.bfloat16)
    jparams = {"embed": w.T} if tied else {"lm_head": w}
    tparams = convert.tree_from_numpy(jax.tree_util.tree_map(np.asarray, jparams), device="cpu")
    want = JT._unembed(cfg, jparams, x)
    got = TT._unembed(cfg, tparams, convert.tree_from_numpy(np.asarray(x), device="cpu"))
    assert got.dtype == torch.float32 and want.dtype == jnp.float32 and got.shape == want.shape
    np.testing.assert_allclose(np32(got), np32(want), **TOL)


# ---------------------------------------------------------------------------
# dense: mixed operand types promote as JAX's dot_general does
# ---------------------------------------------------------------------------


def test_dense_promotes_a_bf16_input_against_an_f32_weight():
    """bf16 x times f32 w multiplies in f32 (JAX promotes both operands) and
    rounds once to bf16: within one bf16 ulp of the JAX package's ``dense``.
    Rounding w to bf16 first is off by several ulps on these inputs."""
    rng = np.random.RandomState(4)
    x = jnp.asarray(rng.randn(4, 8), jnp.bfloat16)
    w = jnp.asarray(rng.randn(8, 3), jnp.float32)
    want = np32(jcommon.dense(x, w))
    got = tcommon.dense(torch.from_numpy(np32(x)).bfloat16(), torch.from_numpy(np.array(w)))
    assert got.dtype == torch.bfloat16 and got.shape == (4, 3)
    ulp = 2.0 ** (np.floor(np.log2(np.abs(want))) - 7)  # bf16 keeps 8 significant bits
    assert np.all(np.abs(np32(got) - want) <= ulp)


def test_dense_of_one_type_makes_no_copy():
    """bf16 x bf16 (the card's serve path) is one matmul: no upcast copy of
    either operand."""
    from torch.profiler import ProfilerActivity, profile

    x = torch.randn(4, 8).bfloat16()
    w = torch.randn(8, 3).bfloat16()
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        y = tcommon.dense(x, w)
    names = [e.name for e in prof.events()]
    assert y.dtype == torch.bfloat16 and "aten::matmul" in names
    assert not [n for n in names if "copy" in n], names


# ---------------------------------------------------------------------------
# the modules in bf16, as the card runs them
# ---------------------------------------------------------------------------

BF16 = dict(dtype="bfloat16", param_dtype="bfloat16")
BF16_TOL = dict(rtol=2e-2, atol=2e-2)  # tests/test_kernels.py:16-17


def perturbed_bf16_jax_params(cfg, seed=0):
    """JAX-initialised bf16 weights as numpy (ml_dtypes bfloat16), with random
    non-zero norm weights rounded to bf16."""
    tree = jcommon.init_params(JT.model_skel(cfg), jax.random.PRNGKey(seed))
    rng = np.random.RandomState(seed)

    def fix(path, a):
        a = np.array(a)
        if any(getattr(k, "key", None) in NORMS for k in path):
            a = (rng.randn(*a.shape) * 0.3).astype(a.dtype)
        return a

    return jax.tree_util.tree_map_with_path(fix, tree)


@pytest.fixture(scope="module")
def small_bf16():
    """reduced qwen3-14b with bf16 activations and weights in both packages."""
    cfg = dataclasses.replace(tconfigs.reduced_config(tconfigs.get_config("qwen3-14b")), **BF16)
    jcfg = dataclasses.replace(jconfigs.reduced_config(jconfigs.get_config("qwen3-14b")), **BF16)
    np_params = perturbed_bf16_jax_params(jcfg)
    jparams = jax.tree_util.tree_map(jnp.asarray, np_params)
    tparams = convert.params_from_jax(np_params, cfg, device="cpu")
    assert tparams["embed"].dtype == torch.bfloat16 and jparams["embed"].dtype == jnp.bfloat16
    return cfg, jcfg, jparams, tparams


def _hidden_bf16(cfg, B, S, seed):
    """The same bf16 hidden states for both packages."""
    j = jnp.asarray(_hidden(cfg, B, S, seed), jnp.bfloat16)
    return j, torch.from_numpy(np32(j)).bfloat16()


@pytest.mark.parametrize("S", [16, 13, 64])
def test_attention_fwd_bf16(small_bf16, S):
    """The port's prefill attention (``ref.flash_attention_ref``, the
    kernel's contract) and the JAX model's ``flash_ref`` both round P to bf16
    before PV, and q, k, v and the output to bf16 at the same places."""
    cfg, jcfg, jp, tp = small_bf16
    jx, tx = _hidden_bf16(cfg, 2, S, 8)
    want = jattn.attention_fwd(jcfg, layer0(jp, "attn"), jx, jcfg.pattern[0], jnp.arange(S, dtype=jnp.int32))
    got = tattn.attention_fwd(cfg, layer0(tp, "attn"), tx, cfg.pattern[0], torch.arange(S))
    assert got.dtype == torch.bfloat16 and want.dtype == jnp.bfloat16 and got.shape == want.shape
    np.testing.assert_allclose(np32(got), np32(want), **BF16_TOL)


def test_ffn_fwd_bf16(small_bf16):
    cfg, jcfg, jp, tp = small_bf16
    jx, tx = _hidden_bf16(cfg, 2, 6, 11)
    want = jmoe.ffn_fwd(jcfg, layer0(jp, "ffn"), jx)
    got = tmoe.ffn_fwd(cfg, layer0(tp, "ffn"), tx)
    assert got.dtype == torch.bfloat16 and got.shape == want.shape
    np.testing.assert_allclose(np32(got), np32(want), **BF16_TOL)
