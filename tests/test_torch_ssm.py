"""The port's SSM families against the JAX package's, on the CPU: rwkv6-1.6b
(RWKV-6 blocks: token shift, the data-dependent decay, the WKV-6 scan, the
per-head group norm, the squared-ReLU channel mix; LayerNorm) and
jamba-v0.1-52b (Mamba layers with one attention layer in eight and no rotary
embedding, MoE on every second layer; RMSNorm), each in its reduced config
(d=64, rwkv head size 16, SSM state 8, 2 RWKV blocks or 16 Jamba layers),
and the modules they add (``models/ssm.py``, ``rope="none"`` attention, the
state caches).

Weights are drawn once by the JAX package.  Every leaf it initialises to
zeros or ones (the mixes ``mu``, the bonus ``u``, the decay base ``w0``, the
group norm's ``ln_w``/``ln_b``, the conv and step biases, ``A_log``, ``D``)
and every norm weight get random numbers added from a numpy seed: with
``u = 0`` or ``mu = 0`` a wrong bonus term or shift mix would not show.  They
cross to the port through ``convert.params_from_jax``; inputs are drawn with
numpy.  Tolerances (tests/test_kernels.py:16-17): 2e-5 in f32, 2e-2 in bf16,
relative and, absolute, of the largest magnitude compared (at least 1).
Jamba in bf16 may route a token differently within tests/test_torch_moe.py's
routing rule; such a row is not compared.
"""

import dataclasses
import functools

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from repro import configs as jconfigs
from repro.data import pipeline as jpipeline
from repro.models import attention as jattn
from repro.models import common as jcommon
from repro.models import ssm as jssm
from repro.models import transformer as JT
from repro.serving import engine as jengine
from repro_torch import configs as tconfigs
from repro_torch import convert
from repro_torch.configs.base import ShapeSpec
from repro_torch.kernels import ops as tops
from repro_torch.launch import serve as tserve
from repro_torch.models import attention as tattn
from repro_torch.models import common as tcommon
from repro_torch.models import ssm as tssm
from repro_torch.models import transformer as TT
from repro_torch.serving import engine as tengine
from repro_torch.tree import leaves, unflatten_like
from test_torch_moe import CS, RoutingLog, paired
from test_torch_train import rounded_as_written

ARCHS = ["rwkv6-1.6b", "jamba-v0.1-52b"]
DTYPES = ["float32", "bfloat16"]
BF16 = dict(dtype="bfloat16", param_dtype="bfloat16")
FRAC = {"float32": 2e-5, "bfloat16": 2e-2}
# leaves the JAX package initialises to zeros or ones, and the norms (ln_cross:
# whisper's, for tests/test_torch_encdec.py, which shares these helpers)
PERTURBED = ("mu", "u", "w0", "ln_w", "ln_b", "conv_b", "dt_b", "A_log", "D", "ln1", "ln2", "ln_cross", "final_norm")


def np32(x):
    return x.detach().float().numpy() if isinstance(x, torch.Tensor) else np.asarray(x, np.float32)


def close(got, want, dtype: str, what: str = "", rows=None):
    """rtol and atol of ``FRAC[dtype]``, atol times the largest |want| (at least 1); ``rows``
    picks the batch rows (axis 0) compared."""
    g, w = np32(got), np32(want)
    assert g.shape == w.shape, (what, g.shape, w.shape)
    if rows is not None:
        g, w = g[rows], w[rows]
    frac = FRAC[dtype]
    np.testing.assert_allclose(g, w, rtol=frac, atol=frac * max(1.0, float(np.abs(w).max())), err_msg=what)


def configs(arch, dtype="float32"):
    cfg = tconfigs.reduced_config(tconfigs.get_config(arch))
    jcfg = jconfigs.reduced_config(jconfigs.get_config(arch))
    if dtype == "bfloat16":
        cfg, jcfg = dataclasses.replace(cfg, **BF16), dataclasses.replace(jcfg, **BF16)
    return cfg, jcfg


@functools.lru_cache(maxsize=None)
def perturbed_jax_params(jcfg, dtype: str, seed=0):
    """JAX-initialised weights as numpy in ``dtype`` (bf16 as ml_dtypes), with
    0.5 x N(0, 1) added to every PERTURBED leaf.  Drawn once per (config,
    dtype, seed) and shared: callers copy (``params_from_jax`` does) and never
    write to it."""
    tree = jcommon.init_params(JT.model_skel(jcfg), jax.random.PRNGKey(seed), dtype_override=getattr(jnp, dtype))
    rng = np.random.RandomState(seed)

    def fix(path, a):
        a = np.array(a)
        if any(getattr(k, "key", None) in PERTURBED for k in path):
            a = (a.astype(np.float32) + 0.5 * rng.randn(*a.shape)).astype(a.dtype)
        return a

    return jax.tree_util.tree_map_with_path(fix, tree)


def both_params(cfg, jcfg, dtype, seed=0):
    np_params = perturbed_jax_params(jcfg, dtype, seed)
    return jax.tree_util.tree_map(jnp.asarray, np_params), convert.params_from_jax(np_params, cfg, device="cpu")


def layer(tree, pos, *keys):
    """Block 0 of pattern position ``pos`` of the first stage, down ``keys``."""
    node = tree["stages"][0][pos]
    for k in keys:
        node = node[k]
    return _first(node)


def _first(node):
    return {k: _first(v) for k, v in node.items()} if isinstance(node, dict) else node[0]


def hidden(shape, seed, dtype="float32", scale=1.0):
    """The same inputs for both packages (rounded to bf16 first in bf16)."""
    j = jnp.asarray(np.random.RandomState(seed).randn(*shape).astype(np.float32) * scale, getattr(jnp, dtype))
    return j, torch.from_numpy(np.array(np32(j))).to(getattr(torch, dtype))


def prompts(cfg, B, S, seed):
    return np.random.RandomState(seed).randint(0, cfg.vocab_size, (B, S)).astype(np.int32)


@pytest.fixture(autouse=True)
def _no_launches():
    tops.reset_launch_counts()
    yield
    assert not any(tops.launch_counts().values()), "a CPU test launched a kernel"


# ---------------------------------------------------------------------------
# configs, parameters, what the port runs
# ---------------------------------------------------------------------------


def test_registry_equals_jax_and_every_config_runs():
    """The port's registry holds the JAX package's configs, all ten, and
    ``check_supported`` passes each; a layer kind the port lacks still
    raises, naming it."""
    assert set(tconfigs.ARCHS) == set(jconfigs.ARCHS) and len(tconfigs.ARCHS) == 10
    for cfg in tconfigs.ARCHS.values():
        TT.check_supported(cfg)
    bad = dataclasses.replace(tconfigs.get_config("rwkv6-1.6b"),
                              pattern=(dataclasses.replace(tconfigs.get_config("rwkv6-1.6b").pattern[0], kind="conv"),))
    with pytest.raises(NotImplementedError, match=r"missing: conv layers$"):
        TT.check_supported(bad)


@pytest.mark.parametrize("arch", ARCHS)
def test_convert_carries_the_ssm_leaves(arch):
    """Every Mamba and RWKV leaf crosses exactly, in its own type (bf16 here);
    a tree without one raises."""
    cfg, jcfg = configs(arch, "bfloat16")
    tree = perturbed_jax_params(jcfg, "bfloat16")
    p = convert.params_from_jax(tree, cfg, device="cpu")
    pos, block = ("pos0", "rwkv") if arch.startswith("rwkv") else ("pos1", "mixer")
    n = 0
    for path, t, a in paired(p["stages"][0][pos][block], tree["stages"][0][pos][block]):
        assert t.dtype == torch.bfloat16 and t.shape == a.shape, path
        np.testing.assert_array_equal(np32(t), np.asarray(a, np.float32), err_msg=path)
        n += 1
    assert n == (16 if block == "rwkv" else 9)
    bad = jax.tree_util.tree_map(lambda a: a, tree)
    if block == "rwkv":
        del bad["stages"][0][pos][block]["time"]["u"]
    else:
        del bad["stages"][0][pos][block]["A_log"]
    with pytest.raises(ValueError, match="keys"):
        convert.params_from_jax(bad, cfg, device="cpu")


def test_sinusoidal_positions_match_jax():
    """The absolute positions ``forward`` adds to a dense ``rope="none"``
    model (no config has one; rwkv6 and jamba, ssm and hybrid, add none)."""
    np.testing.assert_array_equal(np32(tcommon.sinusoidal_positions(37, 64)),
                                  np.asarray(jcommon.sinusoidal_positions(37, 64)))


@pytest.mark.parametrize("arch", ARCHS)
def test_state_caches_take_the_jax_shapes_and_types(arch):
    """Prefill's caches have ``cache_skel``'s shapes and types, position by
    position, in bf16: the conv and shift states in bf16, the SSM and wkv
    states in f32, K/V only at jamba's attention position."""
    cfg, jcfg = configs(arch, "bfloat16")
    params = tcommon.init_params(TT.model_skel(cfg), torch.Generator().manual_seed(0), "cpu")
    _, caches = TT.prefill(cfg, params, {"tokens": torch.from_numpy(prompts(cfg, 2, 6, 0))}, 16)
    want = JT.cache_skel(jcfg, 2, 16)
    assert len(caches) == len(want)
    for path, t, s in paired(caches, want):
        assert tuple(t.shape) == tuple(s.shape) and str(t.dtype).split(".")[1] == str(s.dtype), path
    assert [TT.cache_len_for(cfg, s, 16) for s in cfg.pattern] == [16 if s.kind == "attn" else 0 for s in cfg.pattern]


# ---------------------------------------------------------------------------
# Mamba
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("single_step", [False, True], ids=["scan", "step"])
def test_mamba_core_matches_jax(single_step, dtype):
    """``_mamba_core`` from a non-zero conv and SSM state: 24 steps (three
    chunks of 8) or one; y, the new conv state and the new SSM state."""
    cfg, jcfg = configs("jamba-v0.1-52b", dtype)
    jp, tp = both_params(cfg, jcfg, dtype)
    jm, tm = layer(jp, "pos1", "mixer"), layer(tp, "pos1", "mixer")
    di, W, N = cfg.ssm_expand * cfg.d_model, cfg.ssm_conv_width, cfg.ssm_state_dim
    S = 1 if single_step else 24
    jxz, txz = hidden((2, S, 2 * di), 1, dtype)
    jconv, tconv = hidden((2, W - 1, di), 2, dtype)
    jh, th = hidden((2, di, N), 3)
    jy, jc, js = jssm._mamba_core(jcfg, jm, jxz, jconv, jh, single_step=single_step)
    ty, tc, ts = tssm._mamba_core(cfg, tm, txz, tconv, th, single_step=single_step)
    assert ty.dtype == txz.dtype and tc.dtype == txz.dtype and ts.dtype == torch.float32
    close(ty, jy, dtype, "y")
    close(tc, jc, dtype, "conv state")
    close(ts, js, dtype, "ssm state")


def test_mamba_conv_state_is_the_rows_before_the_conv():
    """The conv state is the last W-1 rows of the input to the conv (the
    prompt itself where it is longer), not of the conv's output."""
    cfg, jcfg = configs("jamba-v0.1-52b")
    _, tp = both_params(cfg, jcfg, "float32")
    tm = layer(tp, "pos1", "mixer")
    di, W = cfg.ssm_expand * cfg.d_model, cfg.ssm_conv_width
    _, xz = hidden((2, 6, 2 * di), 4)
    st = tssm.mamba_init_state(cfg, 2)
    _, conv, _ = tssm._mamba_core(cfg, tm, xz, st["conv"], st["ssm"], single_step=False)
    assert torch.equal(conv, xz[:, -(W - 1):, :di])


@pytest.mark.parametrize("dtype", DTYPES)
def test_mamba_fwd_prefill_and_decode_match_jax(dtype):
    """``mamba_fwd`` and ``mamba_prefill`` on 12 tokens, then two
    ``mamba_decode`` steps, each package from its own state."""
    cfg, jcfg = configs("jamba-v0.1-52b", dtype)
    jp, tp = both_params(cfg, jcfg, dtype)
    jm, tm = layer(jp, "pos1", "mixer"), layer(tp, "pos1", "mixer")
    jx, tx = hidden((2, 14, cfg.d_model), 5, dtype)
    close(tssm.mamba_fwd(cfg, tm, tx[:, :12]), jssm.mamba_fwd(jcfg, jm, jx[:, :12]), dtype, "fwd")
    jy, jst = jssm.mamba_prefill(jcfg, jm, jx[:, :12])
    ty, tst = tssm.mamba_prefill(cfg, tm, tx[:, :12])
    close(ty, jy, dtype, "prefill")
    for t in (12, 13):
        for name in ("conv", "ssm"):
            close(tst[name], jst[name], dtype, f"{name} state before {t}")
        jy, jst = jssm.mamba_decode(jcfg, jm, jx[:, t : t + 1], jst)
        ty, tst = tssm.mamba_decode(cfg, tm, tx[:, t : t + 1], tst)
        close(ty, jy, dtype, f"decode at {t}")


# ---------------------------------------------------------------------------
# RWKV-6
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("single_step", [False, True], ids=["scan", "step"])
def test_wkv6_scan_matches_jax(single_step, dtype):
    """The WKV-6 recurrence from a non-zero state, decays in (0, 1) and a
    non-zero bonus u: 24 steps (three chunks of 8) or one.  In bf16 the
    inputs are rounded to bf16 first (the scan itself is f32 in both)."""
    S = 1 if single_step else 24
    shape = (2, S, 4, 16)
    (jr, tr), (jk, tk), (jv, tv) = (hidden(shape, s, dtype) for s in (6, 7, 8))
    jw, tw = hidden(shape, 9, dtype)
    jw, tw = jax.nn.sigmoid(jw.astype(jnp.float32) + 2), torch.sigmoid(tw.float() + 2)
    ju, tu = hidden((4, 16), 10)
    js, ts = hidden((2, 4, 16, 16), 11)
    f32 = lambda *ts_: [t.astype(jnp.float32) if isinstance(t, jax.Array) else t.float() for t in ts_]
    jy, jS = jssm._wkv6_scan(*f32(jr, jk, jv, jw), ju, js, single_step)
    ty, tS = tssm._wkv6_scan(*f32(tr, tk, tv, tw), tu, ts, single_step)
    close(ty, jy, dtype, "y")
    close(tS, jS, dtype, "state")


def test_group_norm_takes_the_population_variance():
    """Each head normed by its population variance (and eps 64e-5), then
    scaled and shifted; the unbiased variance (torch.var's default) gives
    another result, as does the norm over the whole of d."""
    rng = np.random.RandomState(12)
    y = rng.randn(2, 3, 4, 16) * 3 + 1
    w, b = 1 + rng.randn(64) * 0.3, rng.randn(64) * 0.3
    got = tssm._group_norm(torch.from_numpy(y).float(), torch.from_numpy(w).float(), torch.from_numpy(b).float())
    want = ((y - y.mean(-1, keepdims=True)) / np.sqrt(y.var(-1, keepdims=True) + 64e-5)).reshape(2, 3, 64) * w + b
    np.testing.assert_allclose(np32(got), want, rtol=2e-5, atol=2e-5 * np.abs(want).max())
    unbiased = ((y - y.mean(-1, keepdims=True)) / np.sqrt(y.var(-1, ddof=1, keepdims=True) + 64e-5))
    assert not np.allclose(np32(got), unbiased.reshape(2, 3, 64) * w + b, rtol=1e-3, atol=1e-3)
    flat = y.reshape(2, 3, 64)
    whole = (flat - flat.mean(-1, keepdims=True)) / np.sqrt(flat.var(-1, keepdims=True) + 64e-5) * w + b
    assert not np.allclose(np32(got), whole, rtol=1e-3, atol=1e-3)


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("single_step", [False, True], ids=["scan", "step"])
def test_rwkv_time_mix_matches_jax(single_step, dtype):
    """The time mix from a non-zero shift and wkv state: its output, the new
    shift state (the input's last row) and the new wkv state."""
    cfg, jcfg = configs("rwkv6-1.6b", dtype)
    jp, tp = both_params(cfg, jcfg, dtype)
    jm, tm = layer(jp, "pos0", "rwkv", "time"), layer(tp, "pos0", "rwkv", "time")
    S, H, hs = 1 if single_step else 12, cfg.d_model // cfg.rwkv_head_size, cfg.rwkv_head_size
    jx, tx = hidden((2, S, cfg.d_model), 13, dtype)
    jsh, tsh = hidden((2, cfg.d_model), 14, dtype)
    jS, tS = hidden((2, H, hs, hs), 15)
    jo, jshift, jwkv = jssm._rwkv_time_mix(jcfg, jm, jx, jsh, jS, single_step)
    to, tshift, twkv = tssm._rwkv_time_mix(cfg, tm, tx, tsh, tS, single_step)
    assert to.dtype == tx.dtype and twkv.dtype == torch.float32
    close(to, jo, dtype, "out")
    assert torch.equal(tshift, tx[:, -1])
    close(twkv, jwkv, dtype, "wkv state")


@pytest.mark.parametrize("dtype", DTYPES)
def test_rwkv_channel_mix_matches_jax(dtype):
    cfg, jcfg = configs("rwkv6-1.6b", dtype)
    jp, tp = both_params(cfg, jcfg, dtype)
    jm, tm = layer(jp, "pos0", "rwkv", "channel"), layer(tp, "pos0", "rwkv", "channel")
    jx, tx = hidden((2, 9, cfg.d_model), 16, dtype)
    jsh, tsh = hidden((2, cfg.d_model), 17, dtype)
    jo, _ = jssm._rwkv_channel_mix(jcfg, jm, jx, jsh)
    to, tshift = tssm._rwkv_channel_mix(cfg, tm, tx, tsh)
    assert to.dtype == tx.dtype and torch.equal(tshift, tx[:, -1])
    close(to, jo, dtype, "out")


@pytest.mark.parametrize("dtype", DTYPES)
def test_rwkv_fwd_prefill_and_decode_match_jax(dtype):
    """The whole block with its LayerNorms: ``rwkv_fwd`` and ``rwkv_prefill``
    on 10 tokens (the shift states are the normed inputs' last rows), then
    two ``rwkv_decode`` steps, each package from its own state."""
    cfg, jcfg = configs("rwkv6-1.6b", dtype)
    jp, tp = both_params(cfg, jcfg, dtype)
    jl, tl = layer(jp, "pos0"), layer(tp, "pos0")
    jn = [lambda t, k=k: jcommon.apply_norm(jcfg, jl[k], t) for k in ("ln1", "ln2")]
    tn = [lambda t, k=k: tcommon.apply_norm(cfg, tl[k], t) for k in ("ln1", "ln2")]
    jx, tx = hidden((2, 12, cfg.d_model), 18, dtype)
    close(tssm.rwkv_fwd(cfg, tl["rwkv"], tx[:, :10], *tn), jssm.rwkv_fwd(jcfg, jl["rwkv"], jx[:, :10], *jn), dtype,
          "fwd")
    jy, jst = jssm.rwkv_prefill(jcfg, jl["rwkv"], jx[:, :10], *jn)
    ty, tst = tssm.rwkv_prefill(cfg, tl["rwkv"], tx[:, :10], *tn)
    close(ty, jy, dtype, "prefill")
    assert torch.equal(tst["shift_t"], tn[0](tx[:, :10])[:, -1])
    for t in (10, 11):
        for name in ("shift_t", "shift_c", "wkv"):
            close(tst[name], jst[name], dtype, f"{name} before {t}")
        jy, jst = jssm.rwkv_decode(jcfg, jl["rwkv"], jx[:, t : t + 1], jst, *jn)
        ty, tst = tssm.rwkv_decode(cfg, tl["rwkv"], tx[:, t : t + 1], tst, *tn)
        close(ty, jy, dtype, f"decode at {t}")


# ---------------------------------------------------------------------------
# attention without rotary embedding (Jamba's)
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("dtype", DTYPES)
def test_attention_without_rope_matches_jax(dtype):
    """``rope="none"`` (G = 4): prefill attention, the K/V it caches (the plain
    projections, unrotated) and a decode step at position 12 against a
    linear cache of 16."""
    cfg, jcfg = configs("jamba-v0.1-52b", dtype)
    assert cfg.rope == "none" and cfg.num_heads // cfg.num_kv_heads == 4
    jp, tp = both_params(cfg, jcfg, dtype)
    ja, ta = layer(jp, "pos0", "attn"), layer(tp, "pos0", "attn")
    spec = cfg.pattern[0]
    jx, tx = hidden((2, 13, cfg.d_model), 19, dtype)
    jpos, tpos = jnp.arange(12), torch.arange(12)
    close(tattn.attention_fwd(cfg, ta, tx[:, :12], spec, tpos),
          jattn.attention_fwd(jcfg, ja, jx[:, :12], jcfg.pattern[0], jpos), dtype, "attention_fwd")
    jk, jv = jattn.attention_prefill_kv(jcfg, ja, jx[:, :12], jpos)
    tk, tv = tattn.attention_prefill_kv(cfg, ta, tx[:, :12], tpos)
    K, D = cfg.num_kv_heads, cfg.head_dim
    assert torch.equal(tk, tcommon.dense(tx[:, :12], ta["wk"]).reshape(2, 12, K, D))
    close(tk, jk, dtype, "k")
    close(tv, jv, dtype, "v")
    tcache = [torch.zeros(2, 16, K, D, dtype=tk.dtype) for _ in "kv"]
    tcache[0][:, :12], tcache[1][:, :12] = tk, tv
    jcache = tuple(jnp.zeros((2, 16, K, D), jk.dtype).at[:, :12].set(a) for a in (jk, jv))
    jo, (jkc, jvc) = jattn.attention_decode(jcfg, ja, jx[:, 12:], jcfg.pattern[0], jcache, jnp.int32(12))
    to, (tkc, tvc) = tattn.attention_decode(cfg, ta, tx[:, 12:], spec, tuple(tcache), 12)
    close(to, jo, dtype, "decode")
    close(tkc, jkc, dtype, "k cache")
    close(tvc, jvc, dtype, "v cache")


# ---------------------------------------------------------------------------
# the whole models against the JAX package
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module", params=[(a, d) for d in DTYPES for a in ARCHS], ids=lambda p: f"{p[0]}-{p[1]}")
def model(request):
    arch, dtype = request.param
    cfg, jcfg = configs(arch, dtype)
    jp, tp = both_params(cfg, jcfg, dtype)
    return dtype, cfg, jcfg, jp, tp


def _rows(cfg, dtype, monkeypatch, B):
    """A routing log when rows may route apart (jamba in bf16), else None."""
    return RoutingLog(monkeypatch, cfg, None) if cfg.num_experts and dtype == "bfloat16" else None


def test_forward_logits_match_jax(model, monkeypatch):
    dtype, cfg, jcfg, jp, tp = model
    toks = prompts(cfg, 2, 16, seed=3)
    log = _rows(cfg, dtype, monkeypatch, 2)
    jl, jaux = rounded_as_written(lambda p, t: JT.forward(jcfg, p, {"tokens": t}), jp, jnp.asarray(toks))
    tl, taux = TT.forward(cfg, tp, {"tokens": torch.from_numpy(toks)})
    rows = log.rows_alike(2) if log else None
    assert tl.dtype == torch.float32 and tl.shape == (2, 16, cfg.padded_vocab)
    assert rows is None or rows.sum() >= 1
    close(tl, jl, dtype, "forward logits", rows)
    if dtype == "float32":
        np.testing.assert_allclose(float(taux), float(jaux), rtol=2e-5, atol=2e-5)


def test_prefill_and_two_decode_steps_match_jax(model, monkeypatch):
    """A prompt of 10 into caches of 16, then two decode steps: the logits at
    every step, and every cache leaf (K/V, conv, SSM, shift, wkv) at the end."""
    dtype, cfg, jcfg, jp, tp = model
    B, S, C = 2, 10, 16
    toks = prompts(cfg, B, S + 2, seed=4)
    log = _rows(cfg, dtype, monkeypatch, B)
    jl, jc = rounded_as_written(lambda p, t: JT.prefill(jcfg, p, {"tokens": t}, C), jp, jnp.asarray(toks[:, :S]))
    tl, tc = TT.prefill(cfg, tp, {"tokens": torch.from_numpy(toks[:, :S])}, C)
    rows = log.rows_alike(B) if log else np.ones(B, bool)
    close(tl, jl, dtype, "prefill", rows)
    for t in (S, S + 1):
        jl, jc = rounded_as_written(lambda p, tok, i, c: JT.decode_step(jcfg, p, tok, i, c), jp,
                                    jnp.asarray(toks[:, t : t + 1]), jnp.int32(t), jc)
        tl, tc = TT.decode_step(cfg, tp, torch.from_numpy(toks[:, t : t + 1]), t, tc)
        if log:
            rows &= log.rows_alike(B)
        assert rows.sum() >= 1
        close(tl, jl, dtype, f"decode at {t}", rows)
    n = 0
    for path, t, j in paired(tc, jc):
        assert t.dtype == {"bfloat16": torch.bfloat16, "float32": torch.float32}[str(j.dtype)], path
        close(t.transpose(0, 1), np.asarray(j, np.float32).swapaxes(0, 1), dtype, path, rows)
        n += 1
    assert n == (3 if cfg.family == "ssm" else 2 + 2 * 7)


@pytest.mark.parametrize("arch", ARCHS)
def test_decode_step_matches_the_prefill_of_one_more_token(arch):
    """f32: decode at position S from the caches of a prefill of S tokens
    gives the logits of a prefill of S + 1 (and of ``forward`` there)."""
    cfg, jcfg = configs(arch)
    _, tp = both_params(cfg, jcfg, "float32")
    toks = torch.from_numpy(prompts(cfg, 2, 13, seed=5))
    _, caches = TT.prefill(cfg, tp, {"tokens": toks[:, :12]}, 16)
    step, _ = TT.decode_step(cfg, tp, toks[:, 12:], 12, caches)
    longer, _ = TT.prefill(cfg, tp, {"tokens": toks}, 16)
    close(step, longer, "float32", "decode vs prefill")
    full, _ = TT.forward(cfg, tp, {"tokens": toks})
    close(step, full[:, 12], "float32", "decode vs forward")


@pytest.mark.parametrize("arch", ARCHS)
def test_train_loss_and_every_gradient_match_jax(arch):
    """f32: the loss (with jamba's aux term) at 2e-5 and the gradient of every
    leaf within 2e-5 of its leaf's largest magnitude; the port's scan
    recomputes each chunk in the backward."""
    cfg, jcfg = configs(arch)
    jp, tp = both_params(cfg, jcfg, "float32")
    batch = jpipeline.host_batch(jcfg, ShapeSpec("t", 16, 2, "train"), 0, seed=1)
    jloss, jgrads = rounded_as_written(jax.value_and_grad(lambda p: JT.train_loss(jcfg, p, batch)), jp)
    flat = [t.detach().clone().requires_grad_() for t in leaves(tp)]
    tparams = unflatten_like(tp, flat)
    tloss = TT.train_loss(cfg, tparams, {k: torch.from_numpy(v) for k, v in batch.items()})
    tgrads = unflatten_like(tp, list(torch.autograd.grad(tloss, flat)))
    np.testing.assert_allclose(float(tloss.detach()), float(jloss), rtol=2e-5, atol=2e-5)
    n = 0
    for path, g, w in paired(tgrads, jgrads):
        w = np32(w)
        assert np.abs(w).max() > 0, path
        np.testing.assert_allclose(np32(g), w, rtol=2e-5, atol=2e-5 * np.abs(w).max(), err_msg=path)
        n += 1
    assert n == len(jax.tree_util.tree_leaves(jgrads))


def test_chunked_scan_halves_the_chunk_and_recomputes_under_autograd():
    """Chunks of 8 for 24 steps (128 halved until it divides), the same result
    with and without gradients, and the gradient of a loss over the outputs
    and the final state equal to that of one plain loop."""
    A = torch.randn(4, dtype=torch.float64, requires_grad=True)
    xs = (torch.randn(24, 3, 4, dtype=torch.float64, requires_grad=True),)
    step = lambda h, inp: (h * torch.sigmoid(A) + inp[0], (h * inp[0]).sum(-1))
    h0 = torch.randn(3, 4, dtype=torch.float64)
    with torch.no_grad():
        h_ng, ys_ng = tssm.chunked_scan(step, h0, xs, 24)
    h, ys = tssm.chunked_scan(step, h0, xs, 24)
    assert ys.shape == (24, 3) and torch.equal(h, h_ng) and torch.equal(ys, ys_ng)
    got = torch.autograd.grad(h.sum() + ys.square().sum(), (A, xs[0]))
    hh, ref = h0, []
    for t in range(24):
        hh, y = step(hh, (xs[0][t],))
        ref.append(y)
    want = torch.autograd.grad(hh.sum() + torch.stack(ref).square().sum(), (A, xs[0]))
    for g, w in zip(got, want):
        torch.testing.assert_close(g, w, rtol=1e-12, atol=1e-12)


# ---------------------------------------------------------------------------
# serving: the engine and the CLI
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("arch", ARCHS)
def test_engine_greedy_tokens_equal_jax(arch):
    cfg, jcfg = configs(arch)
    jp, tp = both_params(cfg, jcfg, "float32")
    toks = prompts(cfg, 3, 9, seed=4)
    jeng = jengine.Engine(jcfg, None, jp, jengine.ServeOptions(max_seq=16, batch_size=3))
    teng = tengine.Engine(cfg, tp, tengine.ServeOptions(max_seq=16, batch_size=3))
    want = jeng.generate({"tokens": jnp.asarray(toks)}, 7)
    got = teng.generate({"tokens": toks}, 7)
    assert got.dtype == np.int32 and got.shape == (3, 7)
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("arch", ARCHS)
def test_serve_main_runs_the_ssm_archs_on_cpu(arch, capsys):
    argv = ["--arch", arch, "--reduced", "--device", "cpu", "--batch", "2", "--prompt-len", "12",
            "--new-tokens", "6", "--max-seq", "24", "--seed", "3"]
    a, b = tserve.main(argv), tserve.main(argv)
    assert a.shape == (2, 6) and np.array_equal(a, b)
    assert f"{arch}-smoke on cpu" in capsys.readouterr().out


# ---------------------------------------------------------------------------
# chip_smoke.py's cache check, rehearsed on the CPU (its launch counts:
# tests/test_torch_moe.py, every served arch)
# ---------------------------------------------------------------------------


def _state_fault(fault, monkeypatch):
    """Plants a fault in the state caches that prefill hands decode: every
    wkv state zeroed, or every Mamba conv state off by one row (rolled one
    step along its W-1 rows)."""
    prefill = TT.prefill

    def faulty(cfg, params, batch, cache_seq):
        logits, caches = prefill(cfg, params, batch, cache_seq)
        for stage in caches:
            for c in stage.values():
                if fault == "wkv zeroed" and "wkv" in c:
                    c["wkv"].zero_()
                if fault == "conv off by one row" and "conv" in c:
                    c["conv"].copy_(torch.roll(c["conv"], 1, dims=2))
        return logits, caches

    monkeypatch.setattr(TT, "prefill", faulty)


@pytest.mark.parametrize("arch,fault", [("rwkv6-1.6b", None), ("rwkv6-1.6b", "wkv zeroed"),
                                        ("jamba-v0.1-52b", None), ("jamba-v0.1-52b", "conv off by one row")])
def test_chip_smoke_cache_check_fails_a_state_fault(arch, fault, monkeypatch):
    """``chip_smoke.check_cache`` on the reduced arch in bf16 (jamba's routing
    rule included): 4 prompts of 12 tokens, decode at 12.  It passes the port
    as it is and fails a zeroed wkv state and a conv state off by one row
    (jamba's by a routing that parts outside the rule, or by the logits)."""
    cfg = dataclasses.replace(tconfigs.reduced_config(tconfigs.get_config(arch)), **BF16)
    _, jcfg = configs(arch, "bfloat16")
    params = convert.params_from_jax(perturbed_jax_params(jcfg, "bfloat16"), cfg, device="cpu")
    eng = tengine.Engine(cfg, params, tengine.ServeOptions(max_seq=16, batch_size=4))
    toks = torch.from_numpy(prompts(cfg, 4, 12, 0).astype(np.int64))
    if fault is None:
        rel, _, _ = CS.check_cache(torch, TT, eng, toks, "test")
        assert rel <= CS.CACHE_REL_L2_TOL
    else:
        _state_fault(fault, monkeypatch)
        with pytest.raises(AssertionError):
            CS.check_cache(torch, TT, eng, toks, "test")
