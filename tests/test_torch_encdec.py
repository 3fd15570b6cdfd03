"""The port's encoder-decoder (whisper-medium) against the JAX package's, on
the CPU: the reduced config (d=64, 4 heads of 16, 2 encoder and 2 decoder
layers, 32 frames), cross-attention (``kv_x``), the encoder's bidirectional
self-attention, the static cross cache in decode, the encoder, ``forward``,
prefill with decode, the loss with every gradient, the engine and the serve
launcher, and ``chip_smoke``'s cache check (its launch counts for whisper
are cases of ``tests/test_torch_moe.py``'s launch-count test).

Weights are drawn once by the JAX package; every LayerNorm weight and bias
(``ln1``, ``ln2``, ``ln_cross``, the decoder's and the encoder's final norm)
gets 0.5 x N(0, 1) added from a numpy seed first: with ones and zeros, two
norms swapped would not show.  They cross to the port through
``convert.params_from_jax``; inputs are drawn with numpy.  Tolerances
(tests/test_kernels.py:16-17): 2e-5 in f32, 2e-2 in bf16, relative and, of
the largest magnitude compared (at least 1), absolute.  The helpers that
draw weights and inputs and compare are ``tests/test_torch_ssm.py``'s.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from repro.data import pipeline as jpipeline
from repro.models import attention as jattn
from repro.models import transformer as JT
from repro.serving import engine as jengine
from repro_torch import configs as tconfigs
from repro_torch import convert
from repro_torch.configs.base import ShapeSpec
from repro_torch.kernels import flash_attention as tfa
from repro_torch.kernels import ops as tops
from repro_torch.launch import serve as tserve
from repro_torch.models import attention as tattn
from repro_torch.models import common as tcommon
from repro_torch.models import transformer as TT
from repro_torch.serving import engine as tengine
from repro_torch.tree import leaves, unflatten_like
from test_torch_moe import CS, paired
from test_torch_ssm import _first, both_params, close, configs, hidden, np32, perturbed_jax_params
from test_torch_train import rounded_as_written

ARCH = "whisper-medium"
DTYPES = ["float32", "bfloat16"]
BF16 = dict(dtype="bfloat16", param_dtype="bfloat16")


def inputs(cfg, B, S, seed, E=None):
    """Prompts and f32 frames (B, E, d) as numpy, for either package."""
    rng = np.random.RandomState(seed)
    toks = rng.randint(0, cfg.vocab_size, (B, S)).astype(np.int32)
    frames = rng.randn(B, E or cfg.encoder_seq, cfg.d_model).astype(np.float32)
    return {"tokens": toks, "encoder_frames": frames}


def jbatch(batch):
    return {k: jnp.asarray(v) for k, v in batch.items()}


def tbatch(batch):
    return {k: torch.from_numpy(v) for k, v in batch.items()}


@pytest.fixture(autouse=True)
def _no_launches():
    tops.reset_launch_counts()
    yield
    assert not any(tops.launch_counts().values()), "a CPU test launched a kernel"


# ---------------------------------------------------------------------------
# parameters
# ---------------------------------------------------------------------------


def test_convert_carries_the_encoder_and_cross_leaves():
    """The encoder subtree and every decoder layer's ``cross`` and
    ``ln_cross`` cross exactly, in their own type (bf16 here); the cross
    block has no qk-norm; a tree without the encoder raises."""
    cfg, jcfg = configs(ARCH, "bfloat16")
    tree = perturbed_jax_params(jcfg, "bfloat16")
    p = convert.params_from_jax(tree, cfg, device="cpu")
    dec, jdec = p["stages"][0]["pos0"], tree["stages"][0]["pos0"]
    assert set(p["encoder"]) == {"stage", "final_norm"} and set(dec["cross"]) == {"wq", "wk", "wv", "wo"}
    assert p["encoder"]["stage"]["pos0"]["ln1"]["w"].shape[0] == cfg.encoder_layers
    got = {"encoder": p["encoder"], "cross": dec["cross"], "ln_cross": dec["ln_cross"]}
    want = {"encoder": tree["encoder"], "cross": jdec["cross"], "ln_cross": jdec["ln_cross"]}
    n = 0
    for path, t, a in paired(got, want):
        assert t.dtype == torch.bfloat16 and t.shape == a.shape, path
        np.testing.assert_array_equal(np32(t), np.asarray(a, np.float32), err_msg=path)
        n += 1
    # the encoder's layer: ln1, ln2 (w, b), wq, wk, wv, wo, the FFN's wi, wo; its
    # final norm; the cross block's four weights and ln_cross's w, b
    assert n == 10 + 2 + 4 + 2
    bad = dict(tree)
    del bad["encoder"]
    with pytest.raises(ValueError, match="keys"):
        convert.params_from_jax(bad, cfg, device="cpu")


def test_the_full_config_serves_whole():
    """whisper-medium: 24 + 24 layers at d = 1024, 16 heads of 64 (MHA), vocab
    51865 padded to 51872, 1500 frames; 0.81 B parameters, 1.62 GB in bf16."""
    cfg = tconfigs.get_config(ARCH)
    assert (cfg.num_layers, cfg.encoder_layers, cfg.d_model, cfg.num_heads, cfg.num_kv_heads, cfg.head_dim,
            cfg.d_ff, cfg.padded_vocab, cfg.encoder_seq) == (24, 24, 1024, 16, 16, 64, 4096, 51872, 1500)
    assert (cfg.norm, cfg.act, cfg.rope, cfg.tie_embeddings) == ("layernorm", "gelu", "none", False)
    assert round(cfg.param_count() / 1e9, 2) == 0.81
    assert tfa.route(torch.bfloat16, cfg.head_dim) == "tc"
    assert CS.ENCDEC_RUNS[ARCH][0] == cfg.num_layers


# ---------------------------------------------------------------------------
# attention: cross, bidirectional, the static cross cache
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("kind,E", [("cross", 32), ("bidirectional", 0), ("cross", 1500), ("bidirectional", 1500)],
                         ids=["cross", "bidirectional", "cross-1500", "bidirectional-1500"])
def test_attention_fwd_matches_jax(kind, E, dtype):
    """``attention_fwd`` with ``kv_x`` (10 queries against E frames, or 1500,
    where JAX's blocks are 4 keys) and with ``causal=False`` (over 12
    positions, or the 1500 frames).  Cross-attention takes no rotary
    embedding or mask: rolling the frames leaves it as it is, and it differs
    from the decoder's causal self-attention; the bidirectional one differs
    from the causal one."""
    cfg, jcfg = configs(ARCH, dtype)
    jp, tp = both_params(cfg, jcfg, dtype)
    layer = "cross" if kind == "cross" else "attn"
    ja, ta = _first(jp["stages"][0]["pos0"][layer]), _first(tp["stages"][0]["pos0"][layer])
    spec, jspec = cfg.pattern[0], jcfg.pattern[0]
    S = 10 if kind == "cross" else (E or 12)
    jx, tx = hidden((2, S, cfg.d_model), 1, dtype)
    jpos, tpos = jnp.arange(S), torch.arange(S)
    if kind == "cross":
        je, te = hidden((2, E, cfg.d_model), 2, dtype)
        want = jattn.attention_fwd(jcfg, ja, jx, jspec, jpos, kv_x=je)
        got = tattn.attention_fwd(cfg, ta, tx, spec, tpos, kv_x=te)
        rolled = tattn.attention_fwd(cfg, ta, tx, spec, tpos, kv_x=te.roll(3, dims=1))
        close(rolled, got, dtype, "frames rolled")
        other = tattn.attention_fwd(cfg, ta, tx, spec, tpos)
    else:
        want = jattn.attention_fwd(jcfg, ja, jx, jspec, jpos, causal=False)
        got = tattn.attention_fwd(cfg, ta, tx, spec, tpos, causal=False)
        other = tattn.attention_fwd(cfg, ta, tx, spec, tpos)
    assert got.dtype == tx.dtype
    close(got, want, dtype, kind)
    assert not np.allclose(np32(other), np32(got), rtol=2e-2, atol=2e-2)


@pytest.mark.parametrize("dtype", DTYPES)
def test_cross_decode_reads_the_static_cache(dtype):
    """``attention_decode(cross=True)`` against a cross cache of 32 frames at
    position 5: the JAX package's output, every slot seen (t plays no part),
    and the cache left as it was."""
    cfg, jcfg = configs(ARCH, dtype)
    jp, tp = both_params(cfg, jcfg, dtype)
    ja, ta = _first(jp["stages"][0]["pos0"]["cross"]), _first(tp["stages"][0]["pos0"]["cross"])
    K, D = cfg.num_kv_heads, cfg.head_dim
    jx, tx = hidden((2, 1, cfg.d_model), 3, dtype)
    jk, tk = hidden((2, 32, K, D), 4, dtype)
    jv, tv = hidden((2, 32, K, D), 5, dtype)
    saved = (tk.clone(), tv.clone())
    jo, _ = jattn.attention_decode(jcfg, ja, jx, jcfg.pattern[0], (jk, jv), jnp.int32(5), cross=True)
    to, (tkc, tvc) = tattn.attention_decode(cfg, ta, tx, cfg.pattern[0], (tk, tv), 5, cross=True)
    close(to, jo, dtype, "cross decode")
    assert torch.equal(tkc, saved[0]) and torch.equal(tvc, saved[1])
    late, _ = tattn.attention_decode(cfg, ta, tx, cfg.pattern[0], (tk, tv), 400, cross=True)
    assert torch.equal(late, to)


# ---------------------------------------------------------------------------
# the encoder and the whole model against the JAX package
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module", params=DTYPES)
def model(request):
    dtype = request.param
    cfg, jcfg = configs(ARCH, dtype)
    jp, tp = both_params(cfg, jcfg, dtype)
    return dtype, cfg, jcfg, jp, tp


def test_run_encoder_matches_jax(model):
    """The frames (f32) and their positions each cast to the model's type and
    summed, the bidirectional encoder stage, its final norm."""
    dtype, cfg, jcfg, jp, tp = model
    frames = inputs(cfg, 2, 4, 6)["encoder_frames"]
    want = rounded_as_written(lambda p, f: JT._run_encoder(jcfg, p, f), jp, jnp.asarray(frames))
    got = TT._run_encoder(cfg, tp, torch.from_numpy(frames))
    assert got.dtype == getattr(torch, dtype) and got.shape == frames.shape
    close(got, want, dtype, "encoder output")


def test_forward_logits_match_jax(model):
    """The decoder adds its sinusoidal positions once (the encoder's output,
    not the frames, reaches cross-attention)."""
    dtype, cfg, jcfg, jp, tp = model
    batch = inputs(cfg, 2, 16, 7)
    jl, jaux = rounded_as_written(lambda p, b: JT.forward(jcfg, p, b), jp, jbatch(batch))
    tl, taux = TT.forward(cfg, tp, tbatch(batch))
    assert tl.dtype == torch.float32 and tl.shape == (2, 16, cfg.padded_vocab)
    close(tl, jl, dtype, "forward logits")
    assert float(taux) == float(jaux) == 0.0


def test_prefill_and_two_decode_steps_match_jax(model):
    """A prompt of 10 into caches of 16, then two decode steps: the logits at
    every step, and every cache leaf (self K/V, cross K/V) at the end, in the
    model's type."""
    dtype, cfg, jcfg, jp, tp = model
    B, S, C = 2, 10, 16
    batch = inputs(cfg, B, S + 2, 8)
    pre = dict(batch, tokens=batch["tokens"][:, :S])
    jl, jc = rounded_as_written(lambda p, b: JT.prefill(jcfg, p, b, C), jp, jbatch(pre))
    tl, tc = TT.prefill(cfg, tp, tbatch(pre), C)
    close(tl, jl, dtype, "prefill")
    toks = batch["tokens"]
    for t in (S, S + 1):
        jl, jc = rounded_as_written(lambda p, tok, i, c: JT.decode_step(jcfg, p, tok, i, c), jp,
                                    jnp.asarray(toks[:, t : t + 1]), jnp.int32(t), jc)
        tl, tc = TT.decode_step(cfg, tp, torch.from_numpy(toks[:, t : t + 1]), t, tc)
        close(tl, jl, dtype, f"decode at {t}")
    n = 0
    for path, t, j in paired(tc, jc):
        assert t.dtype == getattr(torch, dtype) and tuple(t.shape) == tuple(j.shape), path
        close(t, j, dtype, path)
        n += 1
    assert n == 4 and tuple(tc[0]["pos0"]["cross_k"].shape) == (cfg.num_layers, B, 32, cfg.num_kv_heads,
                                                                 cfg.head_dim)


def test_cross_cache_matches_the_jax_cache_skeleton():
    """Prefill's caches have ``cache_skel``'s shapes and types in bf16: self
    K/V of max_seq slots, cross K/V of encoder_seq frames."""
    cfg, jcfg = configs(ARCH, "bfloat16")
    params = tcommon.init_params(TT.model_skel(cfg), torch.Generator().manual_seed(0), "cpu")
    _, caches = TT.prefill(cfg, params, tbatch(inputs(cfg, 2, 6, 0)), 16)
    want = JT.cache_skel(jcfg, 2, 16)
    assert len(caches) == len(want)
    for path, t, s in paired(caches, want):
        assert tuple(t.shape) == tuple(s.shape) and str(t.dtype).split(".")[1] == str(s.dtype), path


def test_decode_step_matches_the_prefill_of_one_more_token():
    """f32: decode at position S from the caches of a prefill of S tokens
    gives the logits of a prefill of S + 1 and of ``forward`` there; decode
    at a position past the 8192-row table adds its last row, as JAX's."""
    cfg, jcfg = configs(ARCH)
    jp, tp = both_params(cfg, jcfg, "float32")
    batch = tbatch(inputs(cfg, 2, 13, 9))
    _, caches = TT.prefill(cfg, tp, dict(batch, tokens=batch["tokens"][:, :12]), 16)
    step, _ = TT.decode_step(cfg, tp, batch["tokens"][:, 12:], 12, caches)
    longer, _ = TT.prefill(cfg, tp, batch, 16)
    close(step, longer, "float32", "decode vs prefill")
    full, _ = TT.forward(cfg, tp, batch)
    close(step, full[:, 12], "float32", "decode vs forward")
    # a linear cache of 9001 slots, so that the write at 9000 fits
    pre = inputs(cfg, 2, 4, 9)
    tok = pre["tokens"][:, :1]
    _, jc = JT.prefill(jcfg, jp, jbatch(pre), 9001)
    _, tc = TT.prefill(cfg, tp, tbatch(pre), 9001)
    jl, _ = JT.decode_step(jcfg, jp, jnp.asarray(tok), jnp.int32(9000), jc)
    tl, _ = TT.decode_step(cfg, tp, torch.from_numpy(tok), 9000, tc)
    close(tl, jl, "float32", "decode past the table")


def test_train_loss_and_every_gradient_match_jax():
    """f32: the loss of ``data.pipeline``'s batch (its frames included) at
    2e-5 and the gradient of every leaf, the encoder's included, within 2e-5
    of its leaf's largest magnitude."""
    cfg, jcfg = configs(ARCH)
    jp, tp = both_params(cfg, jcfg, "float32")
    batch = jpipeline.host_batch(jcfg, ShapeSpec("t", 16, 2, "train"), 0, seed=1)
    assert batch["encoder_frames"].shape == (2, cfg.encoder_seq, cfg.d_model)
    jloss, jgrads = rounded_as_written(jax.value_and_grad(lambda p: JT.train_loss(jcfg, p, batch)), jp)
    flat = [t.detach().clone().requires_grad_() for t in leaves(tp)]
    tparams = unflatten_like(tp, flat)
    tloss = TT.train_loss(cfg, tparams, tbatch(batch))
    tgrads = unflatten_like(tp, list(torch.autograd.grad(tloss, flat)))
    np.testing.assert_allclose(float(tloss.detach()), float(jloss), rtol=2e-5, atol=2e-5)
    n = 0
    for path, g, w in paired(tgrads, jgrads):
        w = np32(w)
        assert np.abs(w).max() > 0, path
        np.testing.assert_allclose(np32(g), w, rtol=2e-5, atol=2e-5 * np.abs(w).max(), err_msg=path)
        n += 1
    assert n == len(jax.tree_util.tree_leaves(jgrads))


# ---------------------------------------------------------------------------
# serving: the engine and the CLI
# ---------------------------------------------------------------------------


def test_engine_greedy_tokens_equal_jax():
    """The engine takes the frames with the prompts (f32 numpy) and gives the
    JAX engine's greedy tokens; other frames give other tokens."""
    cfg, jcfg = configs(ARCH)
    jp, tp = both_params(cfg, jcfg, "float32")
    batch = inputs(cfg, 3, 9, 10)
    jeng = jengine.Engine(jcfg, None, jp, jengine.ServeOptions(max_seq=16, batch_size=3))
    teng = tengine.Engine(cfg, tp, tengine.ServeOptions(max_seq=16, batch_size=3))
    want = jeng.generate(jbatch(batch), 7)
    got = teng.generate(batch, 7)
    assert got.dtype == np.int32 and got.shape == (3, 7)
    np.testing.assert_array_equal(got, want)
    other = teng.generate(dict(batch, encoder_frames=batch["encoder_frames"][::-1].copy()), 7)
    assert not np.array_equal(other, got)


def test_serve_main_draws_the_jax_launchers_frames(monkeypatch, capsys):
    """``launch.serve --arch whisper-medium --reduced --device cpu``: the
    engine gets the prompts and frames the JAX launcher draws
    (``RandomState(0)``: randint, then randn, src/repro/launch/serve.py),
    frames in f32; two runs give the same tokens."""
    cfg, _ = configs(ARCH)
    B, P = 2, 12
    seen = []
    generate = tengine.Engine.generate

    def spy(self, batch, num_steps):
        seen.append(batch)
        return generate(self, batch, num_steps)

    monkeypatch.setattr(tengine.Engine, "generate", spy)
    argv = ["--arch", ARCH, "--reduced", "--device", "cpu", "--batch", str(B), "--prompt-len", str(P),
            "--new-tokens", "6", "--max-seq", "24"]
    a, b = tserve.main(argv), tserve.main(argv)
    assert a.shape == (B, 6) and np.array_equal(a, b)
    assert f"{ARCH}-smoke on cpu" in capsys.readouterr().out
    rng = np.random.RandomState(0)
    toks = jnp.asarray(rng.randint(0, cfg.vocab_size, (B, P)), jnp.int32)
    frames = jnp.asarray(rng.randn(B, cfg.encoder_seq, cfg.d_model), jnp.float32)
    assert set(seen[0]) == {"tokens", "encoder_frames"} and seen[0]["encoder_frames"].dtype == np.float32
    np.testing.assert_array_equal(seen[0]["tokens"], np.asarray(toks))
    np.testing.assert_array_equal(seen[0]["encoder_frames"], np.asarray(frames))


# ---------------------------------------------------------------------------
# chip_smoke.py's cache check and launch counts, rehearsed on the CPU
# ---------------------------------------------------------------------------


def _cross_fault(fault, monkeypatch):
    """Plants a fault in the cross caches that prefill hands decode: rows 0
    and 1 swapped, or K/V projected from the encoder's output before its
    final norm (every layer)."""
    prefill = TT.prefill

    def faulty(cfg, params, batch, cache_seq):
        logits, caches = prefill(cfg, params, batch, cache_seq)
        if fault == "rows swapped":
            for c in caches[0].values():
                for name in ("cross_k", "cross_v"):
                    c[name].copy_(c[name][:, [1, 0, *range(2, c[name].shape[1])]])
            return logits, caches
        dt = getattr(torch, cfg.dtype)
        frames = batch["encoder_frames"]
        E = frames.shape[1]
        h = frames.to(dt) + tcommon.sinusoidal_positions(E, cfg.d_model).to(dt)
        h, _ = TT.stage_fwd(cfg, TT.ENCODER_PATTERN, params["encoder"]["stage"], h, torch.arange(E), causal=False)
        cross = params["stages"][0]["pos0"]["cross"]
        c = caches[0]["pos0"]
        for layer in range(cfg.num_layers):
            for name, w in (("cross_k", cross["wk"]), ("cross_v", cross["wv"])):
                c[name][layer] = tcommon.dense(h, w[layer]).reshape(c[name][layer].shape)
        return logits, caches

    monkeypatch.setattr(TT, "prefill", faulty)


@pytest.mark.parametrize("fault", [None, "rows swapped", "before the final norm"])
def test_chip_smoke_cache_check_fails_a_cross_cache_fault(fault, monkeypatch):
    """``chip_smoke.check_cache`` on the reduced whisper in bf16 with the
    frames given to every prefill: 4 prompts of 12 tokens, decode at 12.  It
    passes the port as it is and fails cross caches with two rows swapped
    or taken before the encoder's final norm."""
    cfg, jcfg = configs(ARCH, "bfloat16")
    params = convert.params_from_jax(perturbed_jax_params(jcfg, "bfloat16"), cfg, device="cpu")
    eng = tengine.Engine(cfg, params, tengine.ServeOptions(max_seq=16, batch_size=4))
    batch = {k: torch.from_numpy(v) for k, v in tserve.random_batch(cfg, 4, 12, 0).items()}
    toks = batch.pop("tokens").long()
    if fault is None:
        rel, _, parted = CS.check_cache(torch, TT, eng, toks, "test", batch)
        assert rel <= CS.CACHE_REL_L2_TOL and not parted
    else:
        _cross_fault(fault, monkeypatch)
        with pytest.raises(AssertionError, match="decode disagrees with prefill"):
            CS.check_cache(torch, TT, eng, toks, "test", batch)
