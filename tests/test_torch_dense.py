"""The port's dense-attention family against the JAX package's, on the CPU:
gemma3-27b (5:1 local:global windows, a two-stage stack, qk-norm, the gelu
FFN), starcoder2-3b (LayerNorm, the gelu FFN), stablelm-3b (LayerNorm, MHA)
and qwen2-vl-72b (M-RoPE), each in its reduced config (d=64, 4 heads, head
dim 16, window 8, at most 2 blocks), and the modules they add: LayerNorm,
tanh GELU, the two-weight gelu FFN, the experts' gelu branches and M-RoPE.

Weights are drawn once by the JAX package, their norm weights (LayerNorm's
scales and biases too) replaced by non-zero numbers from a numpy seed, and
carried to the port by ``convert.params_from_jax``; inputs are drawn with
numpy.  Tolerances: f32 at 2e-5 (both sides do the same f32 arithmetic, in
other orders), bf16 at 2e-2 (tests/test_kernels.py:16-17), the absolute part
taken at the largest magnitude of what is compared.  M-RoPE is held with
three distinct position streams (a text run, then an image block of
temporal / height / width grid ids, then text): with equal streams a wrong
band-to-stream map would not show.
"""

import dataclasses

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from repro import configs as jconfigs
from repro.data import pipeline as jpipeline
from repro.models import common as jcommon
from repro.models import moe as jmoe
from repro.models import transformer as JT
from repro.serving import engine as jengine
from repro_torch import configs as tconfigs
from repro_torch import convert
from repro_torch.configs.base import ShapeSpec
from repro_torch.kernels import ops as tops
from repro_torch.launch import serve as tserve
from repro_torch.models import common as tcommon
from repro_torch.models import moe as tmoe
from repro_torch.models import transformer as TT
from repro_torch.serving import engine as tengine
from repro_torch.tree import leaves, unflatten_like
from test_torch_moe import jax_router_logits, paired, routed_alike, router_margin
from test_torch_train import rounded_as_written


ARCHS = ["gemma3-27b", "starcoder2-3b", "stablelm-3b", "qwen2-vl-72b"]
NORMS = ("ln1", "ln2", "final_norm", "q_norm", "k_norm")
TOL = dict(rtol=2e-5, atol=2e-5)
BF16 = dict(dtype="bfloat16", param_dtype="bfloat16")
BF16_FRAC = 2e-2
DTYPES = ["float32", "bfloat16"]


def np32(x):
    return x.detach().float().numpy() if isinstance(x, torch.Tensor) else np.asarray(x, np.float32)


def close(got, want, dtype: str, what: str = ""):
    """f32: rtol = atol = 2e-5; bf16: rtol 2e-2 and atol 2e-2 of the largest |want|."""
    g, w = np32(got), np32(want)
    assert g.shape == w.shape, (what, g.shape, w.shape)
    if dtype == "float32":
        np.testing.assert_allclose(g, w, **TOL, err_msg=what)
    else:
        np.testing.assert_allclose(g, w, rtol=BF16_FRAC, atol=BF16_FRAC * float(np.abs(w).max()), err_msg=what)


def configs(arch, dtype="float32", **changes):
    cfg = dataclasses.replace(tconfigs.reduced_config(tconfigs.get_config(arch)), **changes)
    jcfg = dataclasses.replace(jconfigs.reduced_config(jconfigs.get_config(arch)), **changes)
    if dtype == "bfloat16":
        cfg, jcfg = dataclasses.replace(cfg, **BF16), dataclasses.replace(jcfg, **BF16)
    return cfg, jcfg


def perturbed_jax_params(jcfg, dtype, seed=0):
    """JAX-initialised weights as numpy in ``dtype`` (bf16 as ml_dtypes), with
    random non-zero norm weights and biases."""
    tree = jcommon.init_params(JT.model_skel(jcfg), jax.random.PRNGKey(seed), dtype_override=dtype)
    rng = np.random.RandomState(seed)

    def fix(path, a):
        a = np.array(a)
        if any(getattr(k, "key", None) in NORMS for k in path):
            a = (rng.randn(*a.shape) * 0.3).astype(a.dtype)
        return a

    return jax.tree_util.tree_map_with_path(fix, tree)


def both_params(cfg, jcfg, dtype, seed=0):
    np_params = perturbed_jax_params(jcfg, getattr(jnp, dtype), seed)
    return jax.tree_util.tree_map(jnp.asarray, np_params), convert.params_from_jax(np_params, cfg, device="cpu")


def layer0(tree, *keys):
    node = tree["stages"][0]["pos0"]
    for k in keys:
        node = node[k]
    return _first(node)


def _first(node):
    return {k: _first(v) for k, v in node.items()} if isinstance(node, dict) else node[0]


def hidden(shape, seed, dtype="float32"):
    """The same inputs for both packages (rounded to bf16 first in bf16)."""
    j = jnp.asarray(np.random.RandomState(seed).randn(*shape).astype(np.float32), getattr(jnp, dtype))
    return j, torch.from_numpy(np.array(np32(j))).to(getattr(torch, dtype))


def prompts(cfg, B, S, seed):
    return np.random.RandomState(seed).randint(0, cfg.vocab_size, (B, S)).astype(np.int32)


def mrope_positions(B: int, S: int, grid=(2, 1, 2)) -> np.ndarray:
    """Qwen2-VL's (3, B, S) position streams for a text run, an image block of
    ``grid`` (temporal, height, width) and text after it: text tokens carry
    one id in all three streams, an image token its grid ids offset by the
    text before it, and the text after resumes past the largest id.  Row b's
    text run is b tokens (row 0 opens with the image), so the rows differ."""
    out = np.zeros((3, B, S), np.int32)
    t, h, w = grid
    ids = np.stack(np.meshgrid(np.arange(t), np.arange(h), np.arange(w), indexing="ij")).reshape(3, -1)
    for b in range(B):
        n = b
        assert n + ids.shape[1] <= S
        out[:, b, :n] = np.arange(n)
        out[:, b, n : n + ids.shape[1]] = n + ids
        rest = S - n - ids.shape[1]
        out[:, b, n + ids.shape[1]:] = n + ids.max() + 1 + np.arange(rest)
    assert not ((out[0] == out[1]).all() or (out[1] == out[2]).all() or (out[0] == out[2]).all())
    return out


def batch_for(cfg, toks: np.ndarray) -> dict:
    """Tokens, and for M-RoPE distinct position streams: numpy, for either package."""
    batch = {"tokens": toks}
    if cfg.rope == "mrope":
        batch["positions_3d"] = mrope_positions(*toks.shape)
    return batch


@pytest.fixture(autouse=True)
def _no_launches():
    tops.reset_launch_counts()
    yield
    assert not any(tops.launch_counts().values()), "a CPU test launched a kernel"


# ---------------------------------------------------------------------------
# LayerNorm, GELU, the gelu FFN
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("shape", [(2, 5, 64), (7, 3072), (3, 2560)])
def test_layernorm_matches_jax(shape, dtype):
    """f32 statistics, eps 1e-5, scale and bias in f32, one rounding; the
    inputs have a mean of 3, which a variance taken without centring would
    blur in f32."""
    rng = np.random.RandomState(1)
    jx, tx = hidden(shape, 2, dtype)
    jx, tx = jx + 3, tx + 3
    w = (1 + rng.randn(shape[-1]) * 0.3).astype(np.float32)
    b = (rng.randn(shape[-1]) * 0.3).astype(np.float32)
    jw, jb = jnp.asarray(w, getattr(jnp, dtype)), jnp.asarray(b, getattr(jnp, dtype))
    tw, tb = (torch.from_numpy(np.array(np32(a))).to(tx.dtype) for a in (jw, jb))
    want = jcommon.layernorm(jx, jw, jb)
    got = tcommon.layernorm(tx, tw, tb)
    assert got.dtype == tx.dtype
    close(got, want, dtype, "layernorm")


@pytest.mark.parametrize("dtype", DTYPES)
def test_gelu_is_the_tanh_approximation(dtype):
    jx, tx = hidden((4, 257), 3, dtype)
    jx, tx = jx * 3, tx * 3
    want = jcommon.gelu(jx.astype(jnp.float32))
    got = tcommon.gelu(tx.float())
    close(got, want, "float32", "gelu")
    exact = torch.nn.functional.gelu(tx.float())
    assert not np.allclose(np32(exact), np32(want), rtol=0, atol=1e-4)  # the erf form differs


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("arch", ["starcoder2-3b", "gemma3-27b"])
def test_gelu_ffn_matches_jax(arch, dtype):
    """The two-weight FFN: dense to x's type, f32 gelu, a second rounding,
    then the output projection."""
    cfg, jcfg = configs(arch, dtype)
    jp, tp = both_params(cfg, jcfg, dtype)
    assert set(layer0(tp, "ffn")) == {"wi", "wo"}
    jx, tx = hidden((2, 6, cfg.d_model), 11, dtype)
    want = jmoe.ffn_fwd(jcfg, layer0(jp, "ffn"), jx)
    got = tmoe.ffn_fwd(cfg, layer0(tp, "ffn"), tx)
    assert got.dtype == tx.dtype
    close(got, want, dtype, "ffn")


def test_gelu_ffn_rounds_h_before_the_output_projection():
    """bf16: h = gelu(dense(x, wi)) is rounded to bf16 before ``dense(h, wo)``
    (the JAX package's order); an f32 h gives another output."""
    cfg, jcfg = configs("starcoder2-3b", "bfloat16")
    _, tp = both_params(cfg, jcfg, "bfloat16")
    p = layer0(tp, "ffn")
    _, x = hidden((2, 6, cfg.d_model), 12, "bfloat16")
    h = tcommon.gelu(tcommon.dense(x, p["wi"]).float())
    want = tcommon.dense(h.bfloat16(), p["wo"])
    got = tmoe.ffn_fwd(cfg, p, x)
    assert torch.equal(got, want)
    assert not torch.equal(got, (h @ p["wo"].float()).bfloat16())


# ---------------------------------------------------------------------------
# the experts' gelu branches (no config reaches them; the JAX package has them)
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("mode", ["dense", "dropping"])
def test_moe_gelu_branches_match_jax(mode, dtype):
    """reduced mixtral with ``act="gelu"``: gelu runs on the experts' f32
    products and rounds once.  The dropping dispatch runs at capacity factor
    0.5, so tokens drop.  bf16: tokens that route differently (within the
    routing rule) and, in the dropping dispatch, every token of an expert
    whose queue they change, are not compared (tests/test_torch_moe.py's
    rule)."""
    cfg, jcfg = configs("mixtral-8x22b", dtype, act="gelu")
    jp, tp = both_params(cfg, jcfg, dtype)
    jm, tm = layer0(jp, "moe"), layer0(tp, "moe")
    assert set(tm["experts"]) == {"wi", "wo"}
    jx, tx = hidden((2, 16, cfg.d_model), 4, dtype)
    if mode == "dense":
        jout, jaux = jmoe.moe_fwd(jcfg, jm, jx)
        tout, taux = tmoe.moe_fwd(cfg, tm, tx)
    else:
        jout, jaux = jmoe.moe_fwd_dropping(jcfg, jm, jx, 0.5)
        tout, taux = tmoe.moe_fwd_dropping(cfg, tm, tx, 0.5)
    assert tout.dtype == tx.dtype and tout.shape == tx.shape
    if dtype == "float32":
        close(tout, jout, dtype, mode)
        np.testing.assert_allclose(float(taux), float(jaux), **TOL)
        return
    jw, _ = jmoe._route(jcfg, jm, jx)
    tw, _ = tmoe._route(cfg, tm, tx)
    keep = routed_alike(jw, tw, router_margin(jax_router_logits(jcfg, jm, jx), cfg.top_k))
    if mode == "dropping":
        E = cfg.num_experts
        js, ts = np32(jw).reshape(-1, E) > 0, np32(tw).reshape(-1, E) > 0
        keep &= ~(js & (js != ts).any(0)[None, :]).any(-1)
    assert keep.mean() >= 0.5, keep
    d = cfg.d_model
    close(np32(tout).reshape(-1, d)[keep], np32(jout).reshape(-1, d)[keep], dtype, mode)


def test_expert_gelu_runs_on_the_f32_product():
    """bf16 operands: an expert's h is gelu of the f32 product, rounded once;
    the plain FFN's order (the product rounded first) gives another h."""
    cfg, jcfg = configs("mixtral-8x22b", "bfloat16", act="gelu")
    _, tp = both_params(cfg, jcfg, "bfloat16")
    ex = layer0(tp, "moe")["experts"]
    _, x = hidden((16, cfg.d_model), 9, "bfloat16")
    got = tmoe._expert_h(ex, 1, x, "gelu")
    want = tcommon.gelu(x.float() @ ex["wi"][1].float()).bfloat16()
    assert torch.equal(got, want)
    assert not torch.equal(got, tcommon.gelu((x @ ex["wi"][1]).float()).bfloat16())


# ---------------------------------------------------------------------------
# M-RoPE
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("sections,D", [((2, 3, 3), 16), ((16, 24, 24), 128)])
def test_apply_mrope_with_distinct_streams(sections, D, dtype):
    """Three distinct streams (``mrope_positions``), qwen2-vl's sections at
    full and reduced head dim.  The result must depend on each stream where
    its bands are: with every stream set to the temporal one, or with the
    sections in another order, it moves."""
    B, S = 2, 24
    jx, tx = hidden((B, S, 3, D), 5, dtype)
    pos = mrope_positions(B, S)
    want = jcommon.apply_mrope(jx, jnp.asarray(pos), 1e6, sections)
    got = tcommon.apply_mrope(tx, torch.from_numpy(pos), 1e6, sections)
    assert got.dtype == tx.dtype
    close(got, want, dtype, "mrope")
    flat = tcommon.apply_mrope(tx, torch.from_numpy(np.repeat(pos[:1], 3, 0)), 1e6, sections)
    other = tcommon.apply_mrope(tx, torch.from_numpy(pos), 1e6, sections[::-1])
    for wrong in (flat, other):
        assert not np.allclose(np32(wrong), np32(want), rtol=BF16_FRAC, atol=BF16_FRAC)


def test_apply_mrope_of_equal_streams_is_rope():
    """Text only: three equal streams rotate as plain RoPE."""
    _, x = hidden((2, 9, 3, 16), 6)
    pos = torch.arange(9)[None].expand(2, 9)
    got = tcommon.apply_mrope(x, pos[None].expand(3, 2, 9), 1e4, (2, 3, 3))
    torch.testing.assert_close(got, tcommon.apply_rope(x, pos, 1e4), rtol=0, atol=1e-6)
    with pytest.raises(ValueError, match="sections"):
        tcommon.apply_mrope(x, pos[None].expand(3, 2, 9), 1e4, (2, 3, 4))


# ---------------------------------------------------------------------------
# parameters: LayerNorm's bias, the gelu FFN's tree
# ---------------------------------------------------------------------------


def test_init_params_draws_layernorm_ones_and_zeros():
    cfg = tconfigs.reduced_config(tconfigs.get_config("starcoder2-3b"))
    p = tcommon.init_params(TT.model_skel(cfg), torch.Generator().manual_seed(0), "cpu")
    ln = p["stages"][0]["pos0"]["ln1"]
    assert torch.all(ln["w"] == 1) and torch.all(ln["b"] == 0) and ln["w"].shape == (2, cfg.d_model)
    assert torch.all(p["final_norm"]["w"] == 1) and torch.all(p["final_norm"]["b"] == 0)


def test_convert_carries_layernorm_biases_and_the_gelu_ffn():
    cfg, jcfg = configs("starcoder2-3b")
    tree = perturbed_jax_params(jcfg, jnp.float32)
    p = convert.params_from_jax(tree, cfg, device="cpu")
    for path in (("ln1", "b"), ("ln2", "b"), ("ffn", "wi"), ("ffn", "wo")):
        a, b = p["stages"][0]["pos0"], tree["stages"][0]["pos0"]
        for k in path:
            a, b = a[k], b[k]
        np.testing.assert_array_equal(a.numpy(), b)
    np.testing.assert_array_equal(p["final_norm"]["b"].numpy(), tree["final_norm"]["b"])
    bad = jax.tree_util.tree_map(lambda a: a, tree)
    del bad["stages"][0]["pos0"]["ln1"]["b"]
    with pytest.raises(ValueError, match="keys"):
        convert.params_from_jax(bad, cfg, device="cpu")
    bad = jax.tree_util.tree_map(lambda a: a, tree)
    bad["stages"][0]["pos0"]["ffn"]["wg"] = bad["stages"][0]["pos0"]["ffn"]["wi"]
    with pytest.raises(ValueError, match="keys"):
        convert.params_from_jax(bad, cfg, device="cpu")


# ---------------------------------------------------------------------------
# the whole models against the JAX package
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module", params=[(a, d) for d in DTYPES for a in ARCHS], ids=lambda p: f"{p[0]}-{p[1]}")
def model(request):
    arch, dtype = request.param
    cfg, jcfg = configs(arch, dtype)
    jp, tp = both_params(cfg, jcfg, dtype)
    return dtype, cfg, jcfg, jp, tp


def test_forward_logits_match_jax(model):
    dtype, cfg, jcfg, jp, tp = model
    batch = batch_for(cfg, prompts(cfg, 2, 16, seed=3))
    jl, _ = JT.forward(jcfg, jp, {k: jnp.asarray(v) for k, v in batch.items()})
    tl, taux = TT.forward(cfg, tp, {k: torch.from_numpy(v) for k, v in batch.items()})
    assert tl.dtype == torch.float32 and tl.shape == (2, 16, cfg.padded_vocab) and float(taux) == 0
    close(tl, jl, dtype, "forward logits")


@pytest.mark.parametrize("S", [12, 5])
def test_prefill_and_decode_match_jax(model, S):
    """cache_seq 16: gemma3's local layers keep rings of 8 (a prompt of 12 takes
    the roll path, one of 5 fills from slot 0, and decode wraps), its global
    layers linear caches of 16; qwen2-vl's prompt carries distinct position
    streams, and decode rotates every stream by the token's position, as the
    JAX package does.  Logits at every step and the caches at the end."""
    dtype, cfg, jcfg, jp, tp = model
    B, C = 2, 16
    toks = prompts(cfg, B, C, seed=S)
    batch = batch_for(cfg, toks[:, :S])
    jl, jc = JT.prefill(jcfg, jp, {k: jnp.asarray(v) for k, v in batch.items()}, cache_seq=C)
    tl, tc = TT.prefill(cfg, tp, {k: torch.from_numpy(v) for k, v in batch.items()}, cache_seq=C)
    assert tl.dtype == torch.float32 and tl.shape == (B, cfg.padded_vocab)
    close(tl, jl, dtype, "prefill")
    for t in range(S, C):
        jl, jc = JT.decode_step(jcfg, jp, jnp.asarray(toks[:, t : t + 1]), jnp.int32(t), jc)
        tl, tc = TT.decode_step(cfg, tp, torch.from_numpy(toks[:, t : t + 1]), t, tc)
        close(tl, jl, dtype, f"decode step at {t}")
    for i, (ts, js) in enumerate(zip(tc, jc)):
        assert set(ts) == set(js)
        for pos in ts:
            for name in ("k", "v"):
                assert ts[pos][name].shape == js[pos][name].shape, (i, pos)
                close(ts[pos][name], js[pos][name], dtype, f"stage {i} {pos} {name}")


def test_gemma3_caches_take_each_positions_own_length():
    """One stage holds rings of the window (pos0-4) beside a linear cache
    (pos5); the tail stage holds rings only."""
    cfg = tconfigs.reduced_config(tconfigs.get_config("gemma3-27b"))
    params = tcommon.init_params(TT.model_skel(cfg), torch.Generator().manual_seed(0), "cpu", "float32")
    _, caches = TT.prefill(cfg, params, {"tokens": torch.from_numpy(prompts(cfg, 2, 12, 0))}, 16)
    lens = [{pos: c["k"].shape[2] for pos, c in stage.items()} for stage in caches]
    assert lens == [{"pos0": 8, "pos1": 8, "pos2": 8, "pos3": 8, "pos4": 8, "pos5": 16}, {"pos0": 8, "pos1": 8}]
    assert [c["pos0"]["k"].shape[0] for c in caches] == [2, 1]


def test_mrope_positions_reach_the_model():
    """qwen2-vl's logits with distinct position streams differ from those with
    the streams broadcast from the token positions, in both packages alike."""
    cfg, jcfg = configs("qwen2-vl-72b")
    jp, tp = both_params(cfg, jcfg, "float32")
    toks = prompts(cfg, 2, 16, seed=4)
    flat, _ = TT.forward(cfg, tp, {"tokens": torch.from_numpy(toks)})
    jflat, _ = JT.forward(jcfg, jp, {"tokens": jnp.asarray(toks)})
    close(flat, jflat, "float32", "broadcast streams")
    streams, _ = TT.forward(cfg, tp, {k: torch.from_numpy(v) for k, v in batch_for(cfg, toks).items()})
    assert not np.allclose(np32(streams), np32(flat), rtol=BF16_FRAC, atol=BF16_FRAC)


@pytest.mark.parametrize("arch", ARCHS)
def test_prefill_decode_matches_forward(arch):
    """tests/test_arch_smoke.py's cache check on the port, f32: decode from the
    prefill of 12 tokens reproduces the full forward's logits at every later
    position, across gemma3's ring wrap.  Position streams equal, since
    decode rotates by the token's position."""
    cfg, jcfg = configs(arch)
    _, tp = both_params(cfg, jcfg, "float32")
    dtype = "float32"
    toks = torch.from_numpy(prompts(cfg, 2, 16, seed=0))
    full, _ = TT.forward(cfg, tp, {"tokens": toks})
    logits, caches = TT.prefill(cfg, tp, {"tokens": toks[:, :12]}, cache_seq=16)
    close(logits, full[:, 11], dtype, "prefill")
    for t in range(12, 16):
        logits, caches = TT.decode_step(cfg, tp, toks[:, t : t + 1], t, caches)
        close(logits, full[:, t], dtype, f"step {t}")


# ---------------------------------------------------------------------------
# training: the loss and every gradient
# ---------------------------------------------------------------------------


def test_train_loss_and_every_gradient_match_jax(model):
    """The loss (f32 at 2e-5, bf16 at 2e-2 relative) and the gradient of every
    leaf (LayerNorm biases included), each within 2e-5 (f32) or 2e-2 (bf16)
    of its leaf's largest magnitude; qwen2-vl's batch carries distinct
    position streams."""
    dtype, cfg, jcfg, jp, tp = model
    batch = jpipeline.host_batch(jcfg, ShapeSpec("t", 16, 2, "train"), 0, seed=1)
    if cfg.rope == "mrope":
        batch["positions_3d"] = mrope_positions(2, 16)
    jloss, jgrads = rounded_as_written(jax.value_and_grad(lambda p, b: JT.train_loss(jcfg, p, b)), jp,
                                       {k: jnp.asarray(v) for k, v in batch.items()})
    flat = [t.detach().clone().requires_grad_() for t in leaves(tp)]
    tparams = unflatten_like(tp, flat)
    tloss = TT.train_loss(cfg, tparams, {k: torch.from_numpy(v) for k, v in batch.items()})
    tgrads = unflatten_like(tp, list(torch.autograd.grad(tloss, flat)))
    assert tloss.dtype == torch.float32
    frac = 2e-5 if dtype == "float32" else BF16_FRAC
    np.testing.assert_allclose(float(tloss.detach()), float(jloss), rtol=frac)
    n = 0
    for path, g, w in paired(tgrads, jgrads):
        w = np32(w)
        assert g.dtype == getattr(torch, dtype) and np.abs(w).max() > 0, path
        np.testing.assert_allclose(np32(g), w, rtol=frac, atol=frac * np.abs(w).max(), err_msg=path)
        n += 1
    assert n == len(jax.tree_util.tree_leaves(jgrads))


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


def test_engine_passes_the_position_streams_to_prefill():
    """qwen2-vl in f32, B = 2, S = 16, three distinct position streams (i, 3i
    mod 7 and S-1-i in every row): the port's engine gives the JAX engine's
    greedy tokens, row by row.  The streams change the JAX engine's tokens,
    so an engine that prefilled the tokens alone would fail here."""
    cfg, jcfg = configs("qwen2-vl-72b")
    jp, tp = both_params(cfg, jcfg, "float32")
    B, S = 2, 16
    toks = prompts(cfg, B, S, seed=0)
    i = np.arange(S)
    streams = np.broadcast_to(np.stack([i, 3 * i % 7, S - 1 - i])[:, None], (3, B, S)).astype(np.int32)
    jeng = jengine.Engine(jcfg, None, jp, jengine.ServeOptions(max_seq=24, batch_size=B))
    teng = tengine.Engine(cfg, tp, tengine.ServeOptions(max_seq=24, batch_size=B))
    want = jeng.generate({"tokens": jnp.asarray(toks), "positions_3d": jnp.asarray(streams)}, 6)
    flat = jeng.generate({"tokens": jnp.asarray(toks)}, 6)
    assert not np.array_equal(want, flat)
    got = teng.generate({"tokens": toks, "positions_3d": streams}, 6)
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("arch", ARCHS)
def test_serve_main_runs_the_dense_archs_on_cpu(arch, capsys):
    argv = ["--arch", arch, "--reduced", "--device", "cpu", "--batch", "2", "--prompt-len", "12",
            "--new-tokens", "6", "--max-seq", "24", "--seed", "3"]
    a, b = tserve.main(argv), tserve.main(argv)
    assert a.shape == (2, 6) and np.array_equal(a, b)
    assert f"{arch}-smoke on cpu" in capsys.readouterr().out
