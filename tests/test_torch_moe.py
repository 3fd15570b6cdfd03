"""The port's MoE family against the JAX package's, on the CPU: mixtral-8x22b
(8 experts top-2, sliding window 4096, ring caches) and llama4-scout-17b-a16e
(16 experts top-1 and a shared expert), each in its reduced config (4
experts, top-k <= 2, window 8, 2 layers, d=64).

Weights are drawn once by the JAX package, their norm weights replaced by
non-zero numbers from a numpy seed (zeros would hide the ``1 + w``), and
carried to the port by ``convert.params_from_jax``; inputs are drawn with
numpy.  Tolerances: f32 at 2e-5 (rtol and atol; both sides do the same f32
arithmetic, in other orders), bf16 at 2e-2 (tests/test_kernels.py:16-17),
the absolute part taken at the largest magnitude of what is compared.

Routing rule in bf16: the router's logits are rounded to bf16 before the
f32 softmax, so the two packages may round one of them one ulp apart and
choose another expert where the choice is close.  A token may route
differently only where JAX's margin, the gap between its k-th and (k+1)-th
router logits, lies within 2e-2 of its largest router-logit magnitude.  Such
a token (and in a whole model, its row; in the dropping dispatch, every
token of an expert whose queue it changes) is not compared, and most tokens
(rows) must be compared.  In f32 every token must route alike.
"""

import dataclasses
import importlib.util
from pathlib import Path

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from jax.sharding import AxisType

from repro import configs as jconfigs
from repro.data import pipeline as jpipeline
from repro.models import attention as jattn
from repro.models import common as jcommon
from repro.models import moe as jmoe
from repro.models import transformer as JT
from repro.serving import engine as jengine
from repro.train import step as JS
from repro_torch import configs as tconfigs
from repro_torch import convert
from repro_torch.configs.base import ShapeSpec
from repro_torch.data import pipeline as tpipeline
from repro_torch.kernels import flash_attention as tfa
from repro_torch.kernels import ops as tops
from repro_torch.launch import serve as tserve
from repro_torch.models import attention as tattn
from repro_torch.models import common as tcommon
from repro_torch.models import moe as tmoe
from repro_torch.models import transformer as TT
from repro_torch.serving import engine as tengine
from repro_torch.train import step as TS
from repro_torch.tree import leaves, unflatten_like
from test_torch_models import ENCODER_OVER


def _chip_smoke():
    spec = importlib.util.spec_from_file_location("chip_smoke", Path(__file__).resolve().parents[1] / "chip_smoke.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


CS = _chip_smoke()  # its routing rule, cache check and launch counts are held here too

ARCHS = ["mixtral-8x22b", "llama4-scout-17b-a16e"]
NORMS = ("ln1", "ln2", "final_norm", "q_norm", "k_norm")
TOL = dict(rtol=2e-5, atol=2e-5)
BF16 = dict(dtype="bfloat16", param_dtype="bfloat16")
BF16_FRAC = 2e-2
MARGIN_FRAC = CS.ROUTE_MARGIN  # the routing rule's margin, of the token's largest router-logit magnitude


def np32(x):
    return x.detach().float().numpy() if isinstance(x, torch.Tensor) else np.asarray(x, np.float32)


def near_largest(got, want, frac: float = BF16_FRAC, what: str = ""):
    """|got - want| <= frac * max |want|, elementwise."""
    g, w = np32(got), np32(want)
    assert g.shape == w.shape, (what, g.shape, w.shape)
    err, scale = np.abs(g - w).max(), np.abs(w).max()
    assert err <= frac * scale, f"{what}: max err {err:.3e} > {frac} x {scale:.3e}"


def configs(arch, dtype="float32"):
    cfg = tconfigs.reduced_config(tconfigs.get_config(arch))
    jcfg = jconfigs.reduced_config(jconfigs.get_config(arch))
    if dtype == "bfloat16":
        cfg, jcfg = dataclasses.replace(cfg, **BF16), dataclasses.replace(jcfg, **BF16)
    return cfg, jcfg


def perturbed_jax_params(jcfg, dtype, seed=0):
    """JAX-initialised weights as numpy in ``dtype`` (bf16 as ml_dtypes), with
    random non-zero norm weights."""
    tree = jcommon.init_params(JT.model_skel(jcfg), jax.random.PRNGKey(seed), dtype_override=dtype)
    rng = np.random.RandomState(seed)

    def fix(path, a):
        a = np.array(a)
        if any(getattr(k, "key", None) in NORMS for k in path):
            a = (rng.randn(*a.shape) * 0.3).astype(a.dtype)
        return a

    return jax.tree_util.tree_map_with_path(fix, tree)


@pytest.fixture(scope="module", params=[(a, d) for d in ("float32", "bfloat16") for a in ARCHS],
                ids=lambda p: f"{p[0]}-{p[1]}")
def model(request):
    arch, dtype = request.param
    cfg, jcfg = configs(arch, dtype)
    np_params = perturbed_jax_params(jcfg, getattr(jnp, dtype))
    jparams = jax.tree_util.tree_map(jnp.asarray, np_params)
    tparams = convert.params_from_jax(np_params, cfg, device="cpu")
    return dtype, cfg, jcfg, jparams, tparams


@pytest.fixture(scope="module", params=ARCHS)
def model32(request):
    cfg, jcfg = configs(request.param)
    np_params = perturbed_jax_params(jcfg, jnp.float32)
    return cfg, jcfg, jax.tree_util.tree_map(jnp.asarray, np_params), convert.params_from_jax(np_params, cfg, "cpu")


@pytest.fixture
def moe_mode():
    """Sets both packages' MOE_MODE; back to "dense" afterwards."""
    def set_mode(mode):
        jmoe.set_moe_mode(mode)
        tmoe.set_moe_mode(mode)

    yield set_mode
    set_mode("dense")


@pytest.fixture(autouse=True)
def _no_launches():
    tops.reset_launch_counts()
    yield
    assert not any(tops.launch_counts().values()), "a CPU test launched a kernel"


def layer0(tree, *keys):
    """Layer 0 of the first stage's position 0, in either package's tree."""
    node = tree["stages"][0]["pos0"]
    for k in keys:
        node = node[k]
    return _first(node)


def _first(node):
    return {k: _first(v) for k, v in node.items()} if isinstance(node, dict) else node[0]


def hidden(cfg, B, S, seed, dtype="float32"):
    """The same hidden states for both packages (rounded to bf16 first in bf16)."""
    x = np.random.RandomState(seed).randn(B, S, cfg.d_model).astype(np.float32)
    j = jnp.asarray(x, getattr(jnp, dtype))
    return j, torch.from_numpy(np.array(np32(j))).to(getattr(torch, dtype))


def prompts(cfg, B, S, seed):
    return np.random.RandomState(seed).randint(0, cfg.vocab_size, (B, S)).astype(np.int32)


# ---------------------------------------------------------------------------
# the routing rule
# ---------------------------------------------------------------------------


def router_margin(logits: np.ndarray, k: int) -> np.ndarray:
    """Per token: the gap between the k-th and (k+1)-th router logits over the
    token's largest router-logit magnitude."""
    return CS.route_margin(torch.tensor(logits).reshape(-1, logits.shape[-1]), k).numpy()


def routed_alike(jw, tw, margin) -> np.ndarray:
    """Per token, whether both packages chose the same experts; asserts that
    every token that routes differently lies within the margin rule."""
    E = np.asarray(jw).shape[-1]
    js, ts = np32(jw).reshape(-1, E) > 0, np32(tw).reshape(-1, E) > 0
    alike = (js == ts).all(-1)
    assert (margin[~alike] <= MARGIN_FRAC).all(), (
        f"tokens {np.flatnonzero(~alike)} route differently with margins {margin[~alike]}")
    return alike


def jax_router_logits(jcfg, jp_moe, jx):
    return np.asarray(jcommon.dense(jx, jp_moe["router"]).astype(jnp.float32))


# ---------------------------------------------------------------------------
# configs and parameter trees
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("reduced", [False, True])
@pytest.mark.parametrize("arch", ARCHS)
def test_config_copy_equals_jax(arch, reduced):
    t, j = tconfigs.get_config(arch), jconfigs.get_config(arch)
    if reduced:
        t, j = tconfigs.reduced_config(t), jconfigs.reduced_config(j)
    assert dataclasses.asdict(t) == dataclasses.asdict(j)
    assert t.param_count() == j.param_count()


@pytest.mark.parametrize("arch,layers,billions", [("mixtral-8x22b", 8, 20.44), ("llama4-scout-17b-a16e", 2, 6.47)])
def test_the_smoke_runs_cut_depth_sizes(arch, layers, billions):
    """chip_smoke.py's serve_moe phase cuts depth with dataclasses.replace;
    its parameter counts (the skeleton's leaves, summed)."""
    cfg = dataclasses.replace(tconfigs.get_config(arch), num_layers=layers)
    n = sum(int(np.prod(p.shape)) for p in leaves(TT.model_skel(cfg)))
    assert round(n / 1e9, 2) == billions


@pytest.mark.parametrize("arch", ARCHS)
def test_skeleton_matches_jax(arch):
    """Same leaf names, shapes, logical axes and init rule: the expert axis,
    the router (scale 0.1) and llama4's shared expert."""
    cfg, jcfg = configs(arch)
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
    assert ("shared" in TT.model_skel(cfg)["stages"][0]["pos0"]["moe"]) == cfg.shared_expert


def test_convert_checks_the_expert_trees():
    cfg, jcfg = configs("llama4-scout-17b-a16e")
    tree = perturbed_jax_params(jcfg, jnp.float32)
    p = convert.params_from_jax(tree, cfg, device="cpu")
    moe = p["stages"][0]["pos0"]["moe"]
    assert moe["experts"]["wg"].shape == (2, 4, 64, 128) and moe["router"].shape == (2, 64, 4)
    np.testing.assert_array_equal(moe["shared"]["wo"].numpy(), tree["stages"][0]["pos0"]["moe"]["shared"]["wo"])
    bad = jax.tree_util.tree_map(lambda a: a, tree)
    del bad["stages"][0]["pos0"]["moe"]["shared"]
    with pytest.raises(ValueError, match="keys"):
        convert.params_from_jax(bad, cfg, device="cpu")
    bad = jax.tree_util.tree_map(lambda a: a, tree)
    bad["stages"][0]["pos0"]["moe"]["experts"]["wi"] = np.zeros((2, 3, 64, 128), np.float32)
    with pytest.raises(ValueError, match="shape"):
        convert.params_from_jax(bad, cfg, device="cpu")


def test_moe_mode_is_checked():
    with pytest.raises(ValueError, match="sparse"):
        tmoe.set_moe_mode("sparse")
    assert tmoe.MOE_MODE == ["dense"]


# ---------------------------------------------------------------------------
# the router
# ---------------------------------------------------------------------------


def test_route_matches_jax(model):
    dtype, cfg, jcfg, jp, tp = model
    jx, tx = hidden(cfg, 2, 16, 3, dtype)
    jw, jaux = jmoe._route(jcfg, layer0(jp, "moe"), jx)
    tw, taux = tmoe._route(cfg, layer0(tp, "moe"), tx)
    assert tw.dtype == taux.dtype == torch.float32 and tw.shape == (2, 16, cfg.num_experts)
    assert ((np32(tw) > 0).sum(-1) == cfg.top_k).all()
    if dtype == "float32":
        np.testing.assert_allclose(np32(tw), np32(jw), **TOL)
        np.testing.assert_allclose(float(taux), float(jaux), **TOL)
    else:
        margin = router_margin(jax_router_logits(jcfg, layer0(jp, "moe"), jx), cfg.top_k)
        alike = routed_alike(jw, tw, margin)
        assert alike.mean() >= 0.9, alike
        near_largest(np32(tw).reshape(-1, cfg.num_experts)[alike], np32(jw).reshape(-1, cfg.num_experts)[alike])
        np.testing.assert_allclose(float(taux), float(jaux), rtol=BF16_FRAC)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("arch", ARCHS)
def test_route_breaks_exact_ties_as_jax_top_k(arch, dtype):
    """Experts 1, 2 and 3 get the same router column (and in the first half
    of the tokens every expert does), so their probabilities tie exactly:
    among equal values jax.lax.top_k takes the lower expert first, and so
    must the port.  Both packages' logits are checked to tie."""
    cfg, jcfg = configs(arch, dtype)
    rng = np.random.RandomState(5)
    router = rng.randn(cfg.d_model, cfg.num_experts).astype(np.float32) * 0.3
    router[:, 2] = router[:, 3] = router[:, 1]
    x = rng.randn(2, 16, cfg.d_model).astype(np.float32)
    x[0] = 0.0  # a row of zero inputs: every logit 0, every expert ties
    jr, tr = jnp.asarray(router, getattr(jnp, dtype)), torch.from_numpy(router).to(getattr(torch, dtype))
    jx, tx = jnp.asarray(x, getattr(jnp, dtype)), torch.from_numpy(x).to(getattr(torch, dtype))
    logits = jax_router_logits(jcfg, {"router": jr}, jx)
    assert (logits[..., 1] == logits[..., 2]).all() and (logits[..., 2] == logits[..., 3]).all()
    tlogits = np32(tcommon.dense(tx, tr).float())
    assert (tlogits[..., 1] == tlogits[..., 2]).all() and (tlogits[..., 2] == tlogits[..., 3]).all()
    jw, jaux = jmoe._route(jcfg, {"router": jr}, jx)
    tw, taux = tmoe._route(cfg, {"router": tr}, tx)
    np.testing.assert_array_equal(np32(tw) > 0, np32(jw) > 0)
    want = [0] if cfg.top_k == 1 else [0, 1]
    assert (np.flatnonzero(np32(tw)[0, 0] > 0) == want).all()
    # where expert 0 leads, the tie at the k-th place goes to expert 1 (k = 2)
    lead0 = (logits[1, :, 0] > logits[1, :, 1])
    assert lead0.any() and (~lead0).any()
    if cfg.top_k == 2:
        assert (np32(tw)[1][lead0][:, [0, 1]] > 0).all() and not (np32(tw)[1][lead0][:, [2, 3]] > 0).any()
    np.testing.assert_allclose(np32(tw), np32(jw), **TOL)
    np.testing.assert_allclose(float(taux), float(jaux), **TOL)


# ---------------------------------------------------------------------------
# the two dispatches
# ---------------------------------------------------------------------------


def test_moe_fwd_matches_jax(model):
    dtype, cfg, jcfg, jp, tp = model
    jx, tx = hidden(cfg, 2, 8, 4, dtype)
    jout, jaux = jmoe.moe_fwd(jcfg, layer0(jp, "moe"), jx)
    tout, taux = tmoe.moe_fwd(cfg, layer0(tp, "moe"), tx)
    assert tout.dtype == getattr(torch, dtype) and tout.shape == jx.shape
    if dtype == "float32":
        np.testing.assert_allclose(np32(tout), np32(jout), **TOL)
        np.testing.assert_allclose(float(taux), float(jaux), **TOL)
        return
    jw, _ = jmoe._route(jcfg, layer0(jp, "moe"), jx)
    tw, _ = tmoe._route(cfg, layer0(tp, "moe"), tx)
    alike = routed_alike(jw, tw, router_margin(jax_router_logits(jcfg, layer0(jp, "moe"), jx), cfg.top_k))
    assert alike.mean() >= 0.9, alike
    d = cfg.d_model
    near_largest(np32(tout).reshape(-1, d)[alike], np32(jout).reshape(-1, d)[alike])


def skewed_hidden(cfg, jp_moe, B, S, seed, dtype="float32"):
    """Hidden states that favour expert 0 (a push along its router column):
    its queue outgrows a capacity factor of 1.25."""
    r0 = np32(jp_moe["router"])[:, 0]
    x = np.random.RandomState(seed).randn(B, S, cfg.d_model).astype(np.float32)
    x += 6.0 * r0 / np.linalg.norm(r0)
    j = jnp.asarray(x, getattr(jnp, dtype))
    return j, torch.from_numpy(np.array(np32(j))).to(getattr(torch, dtype))


def dropped(weights, cfg, capacity_factor):
    """Tokens over capacity, by the reference's rule: chosen experts whose
    queue position is at or past the capacity."""
    w = np32(weights).reshape(-1, cfg.num_experts)
    cap = int(capacity_factor * w.shape[0] * cfg.top_k / cfg.num_experts) or 1
    pos = np.cumsum(w > 0, axis=0) - 1
    return ((w > 0) & (pos >= cap)).sum()


@pytest.mark.parametrize("capacity_factor", [1.25, 0.5])
def test_moe_fwd_dropping_matches_jax_and_drops(model, capacity_factor):
    dtype, cfg, jcfg, jp, tp = model
    jx, tx = skewed_hidden(cfg, layer0(jp, "moe"), 2, 16, 6, dtype)
    jout, jaux = jmoe.moe_fwd_dropping(jcfg, layer0(jp, "moe"), jx, capacity_factor)
    tout, taux = tmoe.moe_fwd_dropping(cfg, layer0(tp, "moe"), tx, capacity_factor)
    jw, _ = jmoe._route(jcfg, layer0(jp, "moe"), jx)
    assert dropped(jw, cfg, capacity_factor) > 0
    assert tout.dtype == getattr(torch, dtype) and tout.shape == jx.shape
    if dtype == "float32":
        np.testing.assert_allclose(np32(tout), np32(jout), **TOL)
        np.testing.assert_allclose(float(taux), float(jaux), **TOL)
        return
    # a token routed differently changes the queues of the experts it
    # joins or leaves: no token of those experts is compared
    tw, _ = tmoe._route(cfg, layer0(tp, "moe"), tx)
    E = cfg.num_experts
    alike = routed_alike(jw, tw, router_margin(jax_router_logits(jcfg, layer0(jp, "moe"), jx), cfg.top_k))
    js, ts = np32(jw).reshape(-1, E) > 0, np32(tw).reshape(-1, E) > 0
    changed = (js != ts).any(0)
    keep = alike & ~(js & changed[None, :]).any(-1)
    assert keep.mean() >= 0.5, keep
    d = cfg.d_model
    near_largest(np32(tout).reshape(-1, d)[keep], np32(jout).reshape(-1, d)[keep])


def test_dropping_with_room_for_every_token_equals_dense(model32):
    """At capacity_factor = E / k no token drops, and the dropping dispatch
    computes the dense one's function (in another order): in both packages."""
    cfg, jcfg, jp, tp = model32
    jx, tx = skewed_hidden(cfg, layer0(jp, "moe"), 2, 16, 7)
    cf = cfg.num_experts / cfg.top_k
    jw, _ = jmoe._route(jcfg, layer0(jp, "moe"), jx)
    assert dropped(jw, cfg, cf) == 0 and dropped(jw, cfg, 1.25) > 0
    tdrop, _ = tmoe.moe_fwd_dropping(cfg, layer0(tp, "moe"), tx, cf)
    tdense, _ = tmoe.moe_fwd(cfg, layer0(tp, "moe"), tx)
    jdrop, _ = jmoe.moe_fwd_dropping(jcfg, layer0(jp, "moe"), jx, cf)
    np.testing.assert_allclose(np32(tdrop), np32(tdense), **TOL)
    np.testing.assert_allclose(np32(tdrop), np32(jdrop), **TOL)


def test_moe_products_are_f32_before_the_rounding():
    """bf16 operands with an f32 product: h = silu(g) * h is rounded to bf16
    once, after the f32 products (as the JAX einsums' preferred f32 result);
    with the products rounded to bf16 first, the output moves by more than
    the f32 one does."""
    cfg, jcfg = configs("mixtral-8x22b", "bfloat16")
    np_params = perturbed_jax_params(jcfg, jnp.bfloat16)
    tp = convert.params_from_jax(np_params, cfg, device="cpu")
    moe = layer0(tp, "moe")
    _, tx = hidden(cfg, 2, 8, 9, "bfloat16")
    xt = tx.reshape(-1, cfg.d_model)
    got = tmoe._expert_h(moe["experts"], 1, xt, cfg.act)
    g = xt.float() @ moe["experts"]["wg"][1].float()
    h = xt.float() @ moe["experts"]["wi"][1].float()
    want = (torch.nn.functional.silu(g) * h).bfloat16()
    assert got.dtype == torch.bfloat16
    torch.testing.assert_close(got, want, rtol=0, atol=0)
    rounded = (torch.nn.functional.silu((xt @ moe["experts"]["wg"][1]).float())
               * (xt @ moe["experts"]["wi"][1]).float()).bfloat16()
    assert not torch.equal(rounded, want)


# ---------------------------------------------------------------------------
# sliding-window attention and the ring cache
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("S", [16, 13])
def test_windowed_attention_fwd(S, dtype):
    """mixtral's windowed prefill attention (window 8 over 13 and 16 tokens)."""
    cfg, jcfg = configs("mixtral-8x22b", dtype)
    np_params = perturbed_jax_params(jcfg, getattr(jnp, dtype))
    jp, tp = jax.tree_util.tree_map(jnp.asarray, np_params), convert.params_from_jax(np_params, cfg, "cpu")
    assert cfg.pattern[0].attention == "window" and cfg.pattern[0].window == 8
    jx, tx = hidden(cfg, 2, S, 8, dtype)
    want = jattn.attention_fwd(jcfg, layer0(jp, "attn"), jx, jcfg.pattern[0], jnp.arange(S, dtype=jnp.int32))
    got = tattn.attention_fwd(cfg, layer0(tp, "attn"), tx, cfg.pattern[0], torch.arange(S))
    assert got.dtype == getattr(torch, dtype) and got.shape == want.shape
    if dtype == "float32":
        np.testing.assert_allclose(np32(got), np32(want), **TOL)
    else:
        np.testing.assert_allclose(np32(got), np32(want), rtol=BF16_FRAC, atol=BF16_FRAC)
    # the window is seen: full causal attention gives another answer
    full = tattn.attention_fwd(cfg, layer0(tp, "attn"), tx, dataclasses.replace(cfg.pattern[0], attention="full"),
                               torch.arange(S))
    assert not np.allclose(np32(full), np32(want), rtol=BF16_FRAC, atol=BF16_FRAC)


@pytest.mark.parametrize("C,t", [(8, 3), (8, 8), (8, 13), (8, 21), (6, 5)], ids=lambda v: str(v))
def test_attention_decode_ring(C, t):
    """A cache of C == window slots is a ring (slot t % C, positions
    t - ((t - j) % C)); one of fewer slots is linear.  Output and the
    updated cache against the JAX package's, in f32, past the window too."""
    cfg, jcfg = configs("mixtral-8x22b")
    np_params = perturbed_jax_params(jcfg, jnp.float32)
    jp, tp = jax.tree_util.tree_map(jnp.asarray, np_params), convert.params_from_jax(np_params, cfg, "cpu")
    B, K, D = 2, cfg.num_kv_heads, cfg.head_dim
    rng = np.random.RandomState(10 + t)
    x = rng.randn(B, 1, cfg.d_model).astype(np.float32)
    kc = rng.randn(B, C, K, D).astype(np.float32)
    vc = rng.randn(B, C, K, D).astype(np.float32)
    jout, (jkc, jvc) = jattn.attention_decode(
        jcfg, layer0(jp, "attn"), jnp.asarray(x), jcfg.pattern[0], (jnp.asarray(kc), jnp.asarray(vc)), jnp.int32(t))
    tk, tv = torch.from_numpy(kc.copy()), torch.from_numpy(vc.copy())
    tout, (tkc, tvc) = tattn.attention_decode(cfg, layer0(tp, "attn"), torch.from_numpy(x), cfg.pattern[0], (tk, tv), t)
    assert tkc is tk and tvc is tv
    np.testing.assert_allclose(np32(tout), np32(jout), **TOL)
    np.testing.assert_allclose(np32(tkc), np32(jkc), **TOL)
    np.testing.assert_allclose(np32(tvc), np32(jvc), **TOL)
    changed = np.flatnonzero((np32(tkc) != kc).any(axis=(0, 2, 3)))
    assert list(changed) == [t % C if C == cfg.pattern[0].window else t]


@pytest.mark.parametrize("S,C,rolled", [(12, 8, True), (8, 8, False), (5, 8, False)])
def test_prefill_fills_the_ring(S, C, rolled):
    """cache_len_for keeps min(cache_seq, window) slots; a prompt longer than
    the ring leaves its last C positions at slots p % C (the roll path), a
    shorter one fills from slot 0."""
    cfg, jcfg = configs("mixtral-8x22b")
    np_params = perturbed_jax_params(jcfg, jnp.float32)
    jp, tp = jax.tree_util.tree_map(jnp.asarray, np_params), convert.params_from_jax(np_params, cfg, "cpu")
    spec = cfg.pattern[0]
    assert TT.cache_len_for(cfg, spec, 16) == JT.cache_len_for(jcfg, jcfg.pattern[0], 16) == C
    assert TT.cache_len_for(cfg, spec, 6) == 6
    toks = prompts(cfg, 2, S, 1)
    _, jc = JT.prefill(jcfg, jp, {"tokens": jnp.asarray(toks)}, cache_seq=16)
    _, tc = TT.prefill(cfg, tp, {"tokens": torch.from_numpy(toks)}, cache_seq=16)
    for name in ("k", "v"):
        assert tc[0]["pos0"][name].shape == (2, 2, C, cfg.num_kv_heads, cfg.head_dim)
        np.testing.assert_allclose(np32(tc[0]["pos0"][name]), np32(jc[0]["pos0"][name]), **TOL)
    # slot S % C holds position S - C on the roll path
    x = TT._embed(cfg, tp, torch.from_numpy(toks))
    h = tcommon.apply_norm(cfg, layer0(tp, "ln1"), x)
    k, _ = tattn.attention_prefill_kv(cfg, layer0(tp, "attn"), h, torch.arange(S))
    slot, pos = (S % C, S - C) if rolled else (0, 0)
    np.testing.assert_allclose(np32(tc[0]["pos0"]["k"][0][:, slot]), np32(k[:, pos]), **TOL)


# ---------------------------------------------------------------------------
# the whole model against the JAX package, both dispatch modes
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("mode", ["dense", "dropping"])
@pytest.mark.parametrize("S", [12, 5])
def test_prefill_and_decode_logits_match_jax(model32, moe_mode, mode, S):
    """f32, cache_seq 16 over window 8: mixtral's prompt of 12 takes the
    roll path, the one of 5 fills the ring from slot 0, and decode wraps the
    ring either way; llama4's cache is linear."""
    cfg, jcfg, jp, tp = model32
    moe_mode(mode)
    B, C = 2, 16
    toks = prompts(cfg, B, C, seed=S)
    jl, jc = JT.prefill(jcfg, jp, {"tokens": jnp.asarray(toks[:, :S])}, cache_seq=C)
    tl, tc = TT.prefill(cfg, tp, {"tokens": torch.from_numpy(toks[:, :S])}, cache_seq=C)
    assert tl.dtype == torch.float32 and tl.shape == (B, cfg.padded_vocab)
    np.testing.assert_allclose(np32(tl), np32(jl), **TOL)
    for t in range(S, C):
        jl, jc = JT.decode_step(jcfg, jp, jnp.asarray(toks[:, t : t + 1]), jnp.int32(t), jc)
        tl, tc = TT.decode_step(cfg, tp, torch.from_numpy(toks[:, t : t + 1]), t, tc)
        np.testing.assert_allclose(np32(tl), np32(jl), **TOL, err_msg=f"decode step at {t}")
    for name in ("k", "v"):
        np.testing.assert_allclose(np32(tc[0]["pos0"][name]), np32(jc[0]["pos0"][name]), **TOL)


@pytest.mark.parametrize("mode", ["dense", "dropping"])
def test_forward_logits_and_aux_match_jax(model32, moe_mode, mode):
    cfg, jcfg, jp, tp = model32
    moe_mode(mode)
    toks = prompts(cfg, 2, 16, seed=3)
    jl, jaux = JT.forward(jcfg, jp, {"tokens": jnp.asarray(toks)})
    tl, taux = TT.forward(cfg, tp, {"tokens": torch.from_numpy(toks)})
    assert tl.shape == (2, 16, cfg.padded_vocab) and taux.dtype == torch.float32
    np.testing.assert_allclose(np32(tl), np32(jl), **TOL)
    np.testing.assert_allclose(float(taux), float(jaux), **TOL)
    assert float(taux) > 0


def test_prefill_decode_matches_forward(model32):
    """tests/test_arch_smoke.py's cache check on the port: decode from the
    prefill of 12 tokens reproduces the full forward's logits at every later
    position, across the ring's wrap (dense dispatch: every token computes
    alike in both; f32, 2e-5)."""
    cfg, _, _, tp = model32
    toks = torch.from_numpy(prompts(cfg, 2, 16, seed=0))
    full, _ = TT.forward(cfg, tp, {"tokens": toks})
    logits, caches = TT.prefill(cfg, tp, {"tokens": toks[:, :12]}, cache_seq=16)
    np.testing.assert_allclose(np32(logits), np32(full[:, 11]), **TOL)
    for t in range(12, 16):
        logits, caches = TT.decode_step(cfg, tp, toks[:, t : t + 1], t, caches)
        np.testing.assert_allclose(np32(logits), np32(full[:, t]), **TOL, err_msg=f"step {t}")


def test_engine_greedy_tokens_equal_jax(model32):
    cfg, jcfg, jp, tp = model32
    toks = prompts(cfg, 3, 9, seed=4)
    jeng = jengine.Engine(jcfg, None, jp, jengine.ServeOptions(max_seq=16, batch_size=3))
    teng = tengine.Engine(cfg, tp, tengine.ServeOptions(max_seq=16, batch_size=3))
    want = jeng.generate({"tokens": jnp.asarray(toks)}, 7)
    got = teng.generate({"tokens": toks}, 7)
    assert got.dtype == np.int32 and got.shape == (3, 7)
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("arch", ARCHS)
def test_serve_main_runs_the_moe_archs_on_cpu(arch, capsys):
    argv = ["--arch", arch, "--reduced", "--device", "cpu", "--batch", "2", "--prompt-len", "12",
            "--new-tokens", "6", "--max-seq", "24", "--seed", "3"]
    a, b = tserve.main(argv), tserve.main(argv)
    assert a.shape == (2, 6) and np.array_equal(a, b)
    assert f"{arch}-smoke on cpu" in capsys.readouterr().out


# ---------------------------------------------------------------------------
# the whole model in bf16, with the routing rule
# ---------------------------------------------------------------------------


class RoutingLog:
    """Records each MoE layer's routing in both packages, in call order:
    the JAX side through ``jax.debug.callback`` (its layers run in a scan)."""

    def __init__(self, monkeypatch, cfg, jcfg):
        self.j, self.t = [], []
        jroute, troute = jmoe._route, tmoe._route

        def j_logged(c, p, x):
            w, aux = jroute(c, p, x)
            logits = jcommon.dense(x, p["router"]).astype(jnp.float32)
            jax.debug.callback(lambda w_, l_: self.j.append((np.asarray(w_), np.asarray(l_))), w, logits,
                               ordered=True)
            return w, aux

        def t_logged(c, p, x):
            w, aux = troute(c, p, x)
            self.t.append(np32(w))
            return w, aux

        monkeypatch.setattr(jmoe, "_route", j_logged)
        monkeypatch.setattr(tmoe, "_route", t_logged)
        self.k, self.E = cfg.top_k, cfg.num_experts

    def rows_alike(self, B) -> np.ndarray:
        """Per batch row: whether every token of it routed alike in every call so far."""
        jax.effects_barrier()
        assert len(self.j) == len(self.t) > 0
        ok = np.ones(B, bool)
        for (jw, jl), tw in zip(self.j, self.t):
            alike = routed_alike(jw, tw, router_margin(jl, self.k))
            ok &= alike.reshape(B, -1).all(-1)
        self.j.clear()
        self.t.clear()
        return ok


def bf16_logit_tol(want):
    """2e-2, the absolute part at the logits' largest magnitude (as
    tests/test_torch_serve.py's bf16 tests)."""
    return dict(rtol=BF16_FRAC, atol=BF16_FRAC * float(np.abs(np32(want)).max()))


@pytest.mark.parametrize("arch", ARCHS)
def test_prefill_and_decode_match_jax_bf16(arch, monkeypatch):
    """bf16 weights and activations, cache_seq 16 over window 8, a prompt of
    12 (the roll path) and 4 decode steps (past the ring's wrap).  Rows in
    which any token of any layer routed differently (allowed only within the
    margin rule) are not compared from then on; at least half the rows must
    be compared at every step."""
    cfg, jcfg = configs(arch, "bfloat16")
    np_params = perturbed_jax_params(jcfg, jnp.bfloat16)
    jp, tp = jax.tree_util.tree_map(jnp.asarray, np_params), convert.params_from_jax(np_params, cfg, "cpu")
    log = RoutingLog(monkeypatch, cfg, jcfg)
    B, S, C = 4, 12, 16
    toks = prompts(cfg, B, C, seed=2)
    jl, jc = JT.prefill(jcfg, jp, {"tokens": jnp.asarray(toks[:, :S])}, cache_seq=C)
    tl, tc = TT.prefill(cfg, tp, {"tokens": torch.from_numpy(toks[:, :S])}, cache_seq=C)
    rows = log.rows_alike(B)
    assert tc[0]["pos0"]["k"].dtype == torch.bfloat16
    for t in range(S, C + 1):
        assert rows.sum() >= B // 2, f"too few rows compared at {t}: {rows}"
        np.testing.assert_allclose(np32(tl)[rows], np32(jl)[rows], **bf16_logit_tol(jl), err_msg=f"position {t}")
        if t == C:
            break
        jl, jc = JT.decode_step(jcfg, jp, jnp.asarray(toks[:, t : t + 1]), jnp.int32(t), jc)
        tl, tc = TT.decode_step(cfg, tp, torch.from_numpy(toks[:, t : t + 1]), t, tc)
        rows &= log.rows_alike(B)


# ---------------------------------------------------------------------------
# training: the loss with its aux term, every gradient, the train step
# ---------------------------------------------------------------------------


def paired(ttree, jtree, path=""):
    if isinstance(ttree, dict):
        assert set(ttree) == set(jtree), path
        for k in ttree:
            yield from paired(ttree[k], jtree[k], f"{path}/{k}")
    elif isinstance(ttree, (list, tuple)):
        for i, (a, b) in enumerate(zip(ttree, jtree)):
            yield from paired(a, b, f"{path}[{i}]")
    else:
        yield path, ttree, jtree


@pytest.mark.parametrize("mode", ["dense", "dropping"])
def test_train_loss_and_every_gradient_match_jax(model32, moe_mode, mode):
    """The loss with router_aux_weight * aux / num_layers, and the gradient of
    every leaf (router and experts included), f32: the loss at 2e-5, each
    gradient within 2e-5 of its leaf's largest magnitude."""
    cfg, jcfg, jp, tp = model32
    moe_mode(mode)
    batch = jpipeline.host_batch(jcfg, ShapeSpec("t", 16, 2, "train"), 0, seed=1)
    jloss, jgrads = jax.value_and_grad(lambda p: JT.train_loss(jcfg, p, batch))(jp)
    flat = [t.detach().clone().requires_grad_() for t in leaves(tp)]
    tparams = unflatten_like(tp, flat)
    tloss = TT.train_loss(cfg, tparams, {k: torch.from_numpy(v) for k, v in batch.items()})
    tgrads = unflatten_like(tp, list(torch.autograd.grad(tloss, flat)))
    np.testing.assert_allclose(float(tloss.detach()), float(jloss), **TOL)
    # the aux term is in the loss: without it the loss moves by more than the tolerance
    _, aux = TT.forward(cfg, tparams, {"tokens": torch.from_numpy(batch["tokens"])})
    assert cfg.router_aux_weight * float(aux.detach()) / cfg.num_layers > 1e-3
    n = 0
    for path, g, w in paired(tgrads, jgrads):
        w = np32(w)
        assert np.abs(w).max() > 0, path
        np.testing.assert_allclose(np32(g), w, rtol=2e-5, atol=2e-5 * np.abs(w).max(), err_msg=path)
        n += 1
    assert n == len(jax.tree_util.tree_leaves(jgrads))


STEP_SHAPE = ShapeSpec("t", 16, 4, "train")
STEP_ADAMW = dict(lr=3e-3, warmup_steps=2)


def test_train_step_matches_jax_on_reduced_mixtral():
    """Two steps of ``make_train_step`` (2 microbatches, full remat, the aux
    loss in the gradients) against the JAX package's on a (1, 1) mesh with
    Auto axes, from one state and on the same batches: loss, grad_norm and lr
    at 1e-5 relative; each leaf's update within 1e-3 (relative L2) of JAX's
    and every element within lr (tests/test_torch_train.py's rule)."""
    cfg, jcfg = configs("mixtral-8x22b")
    state = jax.tree_util.tree_map(np.asarray, JS.init_state(jcfg, jax.random.PRNGKey(0)))
    state["params"] = perturbed_jax_params(jcfg, jnp.float32)
    mesh = jax.make_mesh((1, 1), ("data", "model"), axis_types=(AxisType.Auto, AxisType.Auto))
    jopts = JS.TrainOptions(num_microbatches=2, remat="full",
                            adamw=dataclasses.replace(JS.TrainOptions().adamw, **STEP_ADAMW))
    topts = TS.TrainOptions(num_microbatches=2, remat="full",
                            adamw=dataclasses.replace(TS.TrainOptions().adamw, **STEP_ADAMW))
    jstate = jax.tree_util.tree_map(jnp.asarray, state)
    tstate = convert.state_from_jax(state, cfg, device="cpu")
    tstep = TS.make_train_step(cfg, topts)
    with jax.set_mesh(mesh):
        jstep = jax.jit(JS.make_train_step(jcfg, mesh, STEP_SHAPE, jopts))
        for i in range(2):
            jbatch = {k: jnp.asarray(v) for k, v in jpipeline.host_batch(jcfg, STEP_SHAPE, i).items()}
            jstate, jm = jstep(jstate, jbatch)
            tstate, tm = tstep(tstate, tpipeline.device_batch(cfg, STEP_SHAPE, i, torch.device("cpu")))
            for key in ("loss", "grad_norm", "lr"):
                np.testing.assert_allclose(float(tm[key]), float(jm[key]), rtol=1e-5, err_msg=f"step {i + 1} {key}")
    lr = STEP_ADAMW["lr"]
    for (path, t, j), (_, _, p0) in zip(paired(tstate["params"], jstate["params"]),
                                        paired(tstate["params"], state["params"])):
        t, j, p0 = np32(t), np.asarray(j), np.asarray(p0)
        du, dj = t - p0, j - p0
        assert np.abs(dj).max() > lr, path
        assert np.linalg.norm(du - dj) <= 1e-3 * np.linalg.norm(dj), path
        np.testing.assert_allclose(t, j, rtol=0, atol=lr, err_msg=path)


# ---------------------------------------------------------------------------
# chip_smoke.py's launch counts, rehearsed on the CPU
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("arch", ["qwen3-14b"] + ARCHS + ["gemma3-27b", "starcoder2-3b", "stablelm-3b",
                                                           "qwen2-vl-72b", "rwkv6-1.6b", "jamba-v0.1-52b",
                                                           "whisper-medium"]
                         + [f"qwen3-14b+encoder-{what}" for what in sorted(ENCODER_OVER)])
def test_chip_smoke_expects_the_calls_the_serve_path_makes(arch, monkeypatch):
    """The card counts one launch per call of ``ops.rmsnorm`` and per call of
    ``ops.flash_attention`` on the route ``flash_attention.route`` names: on
    the CPU the engine's calls, counted, must be what
    ``chip_smoke.expected_launches`` asks of the card, for a prompt that takes
    the ring roll of the windowed archs.  The reduced config in bf16 at the
    arch's own head dim (and M-RoPE sections), so the routes are the card's:
    the tensor cores for whisper's 64, stablelm's 80 and for 128, none on the
    CUDA cores.  Flash once per attention layer (every layer but jamba's
    Mamba layers and rwkv6's RWKV blocks), and with an encoder once per
    encoder layer and per cross-attention (every attention or Mamba layer,
    no RWKV block); RMSNorm: none for LayerNorm models, ln1 and ln2 of every
    layer kind, with qk-norm the norms of q and k too.  ``qwen3-14b+encoder-*``
    is reduced qwen3 with an encoder over its attention, Mamba or RWKV layers
    (``test_torch_models.ENCODER_OVER``)."""
    base, _, encoder = arch.partition("+encoder-")
    full = tconfigs.get_config(base)
    cfg = dataclasses.replace(tconfigs.reduced_config(full), head_dim=full.head_dim,
                              mrope_sections=full.mrope_sections, **ENCODER_OVER.get(encoder, {}), **BF16)
    params = tcommon.init_params(TT.model_skel(cfg), torch.Generator().manual_seed(0), "cpu")
    calls = {"rmsnorm": 0, "flash_attention_tc": 0, "flash_attention_cores": 0}
    rms, flash = tops.rmsnorm, tops.flash_attention

    def counted_rms(*a, **k):
        calls["rmsnorm"] += 1
        return rms(*a, **k)

    def counted_flash(q, *a, **k):
        calls[f"flash_attention_{tfa.route(q.dtype, q.shape[-1])}"] += 1
        return flash(q, *a, **k)

    monkeypatch.setattr(tops, "rmsnorm", counted_rms)
    monkeypatch.setattr(tops, "flash_attention", counted_flash)
    steps = 5
    tengine.Engine(cfg, params, tengine.ServeOptions(max_seq=16, batch_size=2)).generate(
        tserve.random_batch(cfg, 2, 12, 0), steps)
    want = CS.expected_launches(cfg, steps - 1)
    assert calls == {k: want[k] for k in calls}
    assert want["chunk_reduce"] == want["dequant_add"] == 0
    assert (want["rmsnorm"] == 0) == (cfg.norm == "layernorm")
    L, E = cfg.num_layers, cfg.encoder_layers
    attn_layers = CS.layer_kinds(cfg).count("attn")
    assert attn_layers == {"rwkv6-1.6b": 0, "jamba-v0.1-52b": 2, "qwen3-14b+encoder-mamba": 0,
                           "qwen3-14b+encoder-rwkv": 0}.get(arch, L)
    flash_calls = {"whisper-medium": 3 * L, "qwen3-14b+encoder-attn": 3 * L, "qwen3-14b+encoder-mamba": E + L,
                   "qwen3-14b+encoder-rwkv": E}.get(arch, attn_layers)
    assert want["flash_attention_tc"] == flash_calls and want["flash_attention_cores"] == 0


def _ring_fault(fault, monkeypatch):
    """Plants a ring slot off by one: in prefill's roll (the ring left rolled
    one slot further) or in decode's write (the new token one slot on; all
    C slots lie in the window at t >= C, so decode reads the same)."""
    if fault == "prefill roll":
        prefill = TT.prefill

        def rolled(cfg, params, batch, cache_seq):
            logits, caches = prefill(cfg, params, batch, cache_seq)
            for stage in caches:
                for c in stage.values():
                    if c["k"].shape[1] < cache_seq:
                        c["k"].copy_(torch.roll(c["k"], 1, dims=1))
                        c["v"].copy_(torch.roll(c["v"], 1, dims=1))
            return logits, caches

        monkeypatch.setattr(TT, "prefill", rolled)
    elif fault == "decode slot":
        decode = tattn.attention_decode

        def one_on(cfg, p, x, spec, cache, t):
            k, v = cache
            for c in cache:
                c.copy_(torch.roll(c, -1, dims=1))
            out, _ = decode(cfg, p, x, spec, cache, t)
            for c in cache:
                c.copy_(torch.roll(c, 1, dims=1))
            return out, (k, v)

        monkeypatch.setattr(tattn, "attention_decode", one_on)


@pytest.mark.parametrize("seed", [0, 1, 2])
@pytest.mark.parametrize("fault", [None, "prefill roll", "decode slot"])
def test_chip_smoke_cache_check_fails_a_ring_slot_fault(fault, seed, monkeypatch):
    """``chip_smoke.check_cache``, routing rule included, on the reduced
    mixtral in bf16: 4 prompts of 12 tokens into rings of 8, decode at 12.
    It passes the port as it is and fails a ring slot off by one."""
    cfg = dataclasses.replace(tconfigs.reduced_config(tconfigs.get_config("mixtral-8x22b")), **BF16)
    params = tcommon.init_params(TT.model_skel(cfg), torch.Generator().manual_seed(seed), "cpu", "bfloat16")
    eng = tengine.Engine(cfg, params, tengine.ServeOptions(max_seq=16, batch_size=4))
    toks = torch.from_numpy(prompts(cfg, 4, 12, seed).astype(np.int64))
    _ring_fault(fault, monkeypatch)
    if fault is None:
        rel, _, _ = CS.check_cache(torch, TT, eng, toks, "test")
        assert rel <= CS.CACHE_REL_L2_TOL
    else:
        with pytest.raises(AssertionError):
            CS.check_cache(torch, TT, eng, toks, "test")
