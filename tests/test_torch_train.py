"""The port's train slice against the JAX package's, on the CPU: the flash
and RMSNorm gradients, the log-sum-exp, AdamW, the data pipeline, the
model's loss and gradients, the train step with microbatches and every
remat mode, the pod sync on gloo ranks, and the launcher.

Inputs are drawn once with numpy (or, for weights, by the JAX package) and
handed to both packages.  Tolerances, as stated at each test: f32 gradients
at the JAX kernel test's 2e-4 / 1e-5 (tests/test_kernels.py:67) or at 1e-4
relative; bf16 at 2e-2 of the largest magnitude.
"""

import dataclasses
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from jax.sharding import AxisType

import torch_rank_cases as cases
from repro import configs as jconfigs
from repro.data import pipeline as jpipeline
from repro.kernels import ops as jops
from repro.models import attention as jattn
from repro.models import common as jcommon
from repro.models import transformer as JT
from repro.optim import adamw as jadamw
from repro.train import step as JS
from repro_torch import configs as tconfigs
from repro_torch import convert
from repro_torch.configs.base import ShapeSpec
from repro_torch.core import group as TG
from repro_torch.data import pipeline as tpipeline
from repro_torch.kernels import ops as tops
from repro_torch.kernels import ref as tref
from repro_torch.launch import train as ttrain
from repro_torch.models import transformer as TT
from repro_torch.optim import adamw as tadamw
from repro_torch.train import step as TS
from repro_torch.tree import leaves, tree_map, unflatten_like

ROOT = Path(__file__).resolve().parents[1]
NORMS = ("ln1", "ln2", "final_norm", "q_norm", "k_norm")
BF16 = dict(dtype="bfloat16", param_dtype="bfloat16")


def np32(x):
    return x.detach().float().numpy() if isinstance(x, torch.Tensor) else np.asarray(x, np.float32)


def both(a: np.ndarray, dtype: str):
    """The same numbers as a JAX array and a torch tensor of ``dtype``."""
    j = jnp.asarray(a, getattr(jnp, dtype))
    return j, torch.from_numpy(np.array(j, np.float32)).to(getattr(torch, dtype))


def near_largest(got, want, frac: float, what: str = ""):
    """|got - want| <= frac * max |want|, elementwise."""
    g, w = np32(got), np32(want)
    assert g.shape == w.shape, (what, g.shape, w.shape)
    scale = np.abs(w).max()
    err = np.abs(g - w).max()
    assert err <= frac * scale, f"{what}: max err {err:.3e} > {frac} x {scale:.3e}"


def paired(ttree, jtree, path=""):
    """(path, port leaf, JAX leaf) over two trees of the same names."""
    if isinstance(ttree, dict):
        assert set(ttree) == set(jtree), path
        for k in ttree:
            yield from paired(ttree[k], jtree[k], f"{path}/{k}")
    elif isinstance(ttree, (list, tuple)):
        for i, (a, b) in enumerate(zip(ttree, jtree)):
            yield from paired(a, b, f"{path}[{i}]")
    else:
        yield path, ttree, jtree


@pytest.fixture(autouse=True)
def _no_launches():
    tops.reset_launch_counts()
    yield
    assert not any(tops.launch_counts().values()), "a CPU test launched a kernel"


# ---------------------------------------------------------------------------
# flash attention: gradients and log-sum-exp
# ---------------------------------------------------------------------------


def test_flash_grad_matches_the_jax_kernel_grad():
    """tests/test_kernels.py::test_flash_attention_grad_matches_ref's setup,
    against ``jax.grad`` through ``repro.kernels.ops.flash_attention`` (the
    Pallas forward in interpret mode, its backward), at its 2e-4 / 1e-5."""
    rng = np.random.RandomState(1)
    B, H, Kh, S, D = 1, 2, 1, 128, 32
    q = rng.randn(B, H, S, D).astype(np.float32) / np.sqrt(D)
    k = rng.randn(B, Kh, S, D).astype(np.float32) / np.sqrt(D)
    v = rng.randn(B, Kh, S, D).astype(np.float32)

    def f_jax(q, k, v):
        return jnp.sum(jnp.tanh(jops.flash_attention(q, k, v, True, 0, 0)))

    want = jax.grad(f_jax, argnums=(0, 1, 2))(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v))
    ts = [torch.from_numpy(a).requires_grad_() for a in (q, k, v)]
    torch.tanh(tops.flash_attention(*ts, True, 0, 0)).sum().backward()
    for t, w in zip(ts, want):
        np.testing.assert_allclose(np32(t.grad), np.asarray(w), rtol=2e-4, atol=1e-5)


# (B, H, Kh, S, D, causal, window): GQA with G = H / Kh = 5, and the block
# counts of _block_sizes: 1 x 1, 3 x 3 (S = 3072: q and kv blocks of 1024),
# 1 x 2 (S = 2048) with a window, so that whole block pairs are masked.
FLASH_GRAD_CASES = [
    (1, 5, 1, 128, 16, True, 0),
    (2, 10, 2, 128, 16, False, 0),
    (1, 5, 1, 3072, 16, True, 0),
    (1, 5, 1, 2048, 16, True, 300),
]


def flash_grad_inputs(B, H, Kh, S, D, dtype, seed):
    """q of std 2 and k of std 1, so that the scaled scores have a std of 2
    and the softmax is far from uniform; v and dout of std 1."""
    rng = np.random.RandomState(seed)
    return [both(a, dtype) for a in (rng.randn(B, H, S, D) * 2, rng.randn(B, Kh, S, D),
                                     rng.randn(B, Kh, S, D), rng.randn(B, H, S, D))]


@pytest.mark.parametrize("case,dtype", [(c, "float32") for c in FLASH_GRAD_CASES]
                         + [(c, "bfloat16") for c in FLASH_GRAD_CASES if c[3] <= 2048])
def test_flash_grad_matches_jax_flash_ref(case, dtype):
    """``ops.flash_attention``'s backward (``ref.flash_attention_bwd`` from
    the forward's lse) against ``jax.vjp`` of ``repro.models.attention.
    flash_ref`` on the same q, k, v and dout.  f32 at 2e-4 / 1e-5; bf16 at
    2e-2 of each gradient's largest magnitude."""
    B, H, Kh, S, D, causal, window = case
    (jq, tq), (jk, tk), (jv, tv), (jdo, tdo) = flash_grad_inputs(B, H, Kh, S, D, dtype, 3)
    G = H // Kh
    pos = jnp.arange(S, dtype=jnp.int32)
    _, vjp = jax.vjp(lambda q, k, v: jattn.flash_ref(q, k, v, pos, pos, causal, window),
                     jq.reshape(B, Kh, G, S, D), jk, jv)
    want = vjp(jdo.reshape(B, Kh, G, S, D))
    ts = [t.requires_grad_() for t in (tq, tk, tv)]
    out = tops.flash_attention(*ts, causal, window, 0)
    got = torch.autograd.grad(out, ts, tdo)
    for name, g, w in zip("qkv", got, want):
        w = np.asarray(w, np.float32).reshape(g.shape)
        assert g.dtype == getattr(torch, dtype)
        if dtype == "float32":
            np.testing.assert_allclose(np32(g), w, rtol=2e-4, atol=1e-5, err_msg=f"d{name}")
        else:
            near_largest(g, w, 2e-2, f"d{name}")


@pytest.mark.parametrize("case", FLASH_GRAD_CASES)
def test_lse_matches_jax_flash_fwd(case):
    """``ref.flash_attention_ref(..., return_lse=True)``, the contract of both
    kernels' lse, against ``_flash_fwd_impl``'s ``m + log(l)``, f32, 2e-5."""
    B, H, Kh, S, D, causal, window = case
    (jq, tq), (jk, tk), (jv, tv), _ = flash_grad_inputs(B, H, Kh, S, D, "float32", 4)
    pos = jnp.arange(S, dtype=jnp.int32)
    out_j, lse_j = jattn._flash_fwd_impl(jq.reshape(B, Kh, H // Kh, S, D), jk, jv, pos, pos, causal, window)
    out_t, lse_t = tref.flash_attention_ref(tq, tk, tv, causal, window, 0, return_lse=True)
    assert lse_t.dtype == torch.float32 and lse_t.shape == (B, H, S)
    np.testing.assert_allclose(np32(lse_t), np.asarray(lse_j).reshape(B, H, S), rtol=2e-5, atol=2e-5)
    np.testing.assert_allclose(np32(out_t), np.asarray(out_j).reshape(B, H, S, D), rtol=2e-5, atol=2e-5)


def test_lse_of_a_row_with_no_key_is_inf_and_its_gradient_zero():
    """A row that sees no key: output 0, lse +inf, so the backward's
    p = exp(s - lse) is 0 and the row adds nothing to any gradient."""
    rng = np.random.RandomState(5)
    q, k, v = (torch.from_numpy(rng.randn(1, 2, 16, 32).astype(np.float32)) for _ in range(3))
    k, v = k[:, :1].contiguous(), v[:, :1].contiguous()
    out, lse = tref.flash_attention_ref(q, k, v, True, 0, -4, return_lse=True)
    assert torch.isinf(lse[..., :4]).all() and (lse[..., :4] > 0).all() and torch.isfinite(lse[..., 4:]).all()
    assert (out[..., :4, :] == 0).all()
    ts = [t.clone().requires_grad_() for t in (q, k, v)]
    dout = torch.zeros_like(q)
    dout[..., :4, :] = 1.0  # only the rows with no key get a cotangent
    dq, dk, dv = torch.autograd.grad(tops.flash_attention(*ts, True, 0, -4), ts, dout)
    assert torch.isfinite(dq).all() and not dq.any() and not dk.any() and not dv.any()


@pytest.mark.parametrize("Skv", [0, 7])
def test_lse_with_no_keys_at_all(Skv):
    """Every row sees no key (no keys, or all after the queries): zeros and +inf."""
    q = torch.randn(1, 2, 5, 16)
    k = torch.randn(1, 1, Skv, 16)
    out, lse = tref.flash_attention_ref(q, k, k, True, 0, -Skv - 1, return_lse=True)
    assert lse.shape == (1, 2, 5) and torch.isinf(lse).all() and (lse > 0).all() and not out.any()


def test_flash_writes_no_lse_without_gradients(monkeypatch):
    """The serve path (no gradient) takes the forward alone, without lse."""
    asked = []
    plain = tref.flash_attention_ref

    def spy(*a, return_lse=False, **k):
        asked.append(return_lse)
        return plain(*a, return_lse=return_lse, **k)

    monkeypatch.setattr(tref, "flash_attention_ref", spy)
    q = torch.randn(1, 2, 8, 16)
    tops.flash_attention(q, q, q)
    with torch.no_grad():
        tops.flash_attention(q.requires_grad_(), q, q)
    tops.flash_attention(q, q, q)
    assert asked == [False, False, True]


# ---------------------------------------------------------------------------
# RMSNorm gradients
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("shape", [(4, 64), (3, 7, 256), (2, 5, 1, 4, 16)])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_rmsnorm_grad_matches_jax(shape, dtype):
    """``ops.rmsnorm``'s backward (``ref.rmsnorm_bwd``) against ``jax.vjp`` of
    ``repro.models.common.rmsnorm`` with a non-zero weight: f32 at 1e-5
    relative (1e-6 absolute), bf16 at 2e-2 of the largest magnitude."""
    rng = np.random.RandomState(6)
    (jx, tx), (jw, tw), (jdy, tdy) = (both(a, dtype) for a in (
        rng.randn(*shape) * 3, rng.randn(shape[-1]) * 0.3, rng.randn(*shape)))
    _, vjp = jax.vjp(jcommon.rmsnorm, jx, jw)
    want = vjp(jdy)
    ts = [tx.requires_grad_(), tw.requires_grad_()]
    got = torch.autograd.grad(tops.rmsnorm(*ts), ts, tdy)
    for name, g, w in zip(("dx", "dw"), got, want):
        assert g.dtype == ts[0 if name == "dx" else 1].dtype
        if dtype == "float32":
            np.testing.assert_allclose(np32(g), np32(w), rtol=1e-5, atol=1e-6, err_msg=name)
        else:
            near_largest(g, w, 2e-2, name)


# ---------------------------------------------------------------------------
# AdamW
# ---------------------------------------------------------------------------


def test_schedule_matches_jax():
    cfg = tadamw.AdamWConfig(lr=1e-3, warmup_steps=10, total_steps=100, min_lr_frac=0.1)
    jcfg = jadamw.AdamWConfig(lr=1e-3, warmup_steps=10, total_steps=100, min_lr_frac=0.1)
    steps = np.array([0, 1, 5, 9, 10, 11, 37, 99, 100, 150], np.int32)
    got = [float(tadamw.schedule(cfg, torch.tensor(s))) for s in steps]
    want = [float(jadamw.schedule(jcfg, jnp.int32(s))) for s in steps]
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=0)


@pytest.mark.parametrize("clip", [1.0, 1e-3], ids=["unclipped", "clipped"])
def test_adamw_update_matches_jax_step_for_step(clip):
    """Five steps on a tree of f32 and bf16 leaves with fresh gradients each
    step: parameters, moments, count, grad_norm and lr.  f32 at 1e-6 relative
    (the two sum the global norm in other orders); a bf16 parameter within
    one bf16 ulp."""
    rng = np.random.RandomState(7)
    shapes = {"a": (5, 3), "b": {"c": (7,), "d": (2, 2, 4)}}
    kw = dict(lr=1e-2, warmup_steps=2, total_steps=20, clip_norm=clip)
    cfg, jcfg = tadamw.AdamWConfig(**kw), jadamw.AdamWConfig(**kw)
    p_np = jax.tree_util.tree_map(lambda s: rng.randn(*s).astype(np.float32), shapes,
                                  is_leaf=lambda s: isinstance(s, tuple))
    jp = {"a": jnp.asarray(p_np["a"]), "b": {"c": jnp.asarray(p_np["b"]["c"], jnp.bfloat16),
                                              "d": jnp.asarray(p_np["b"]["d"])}}
    tp = {"a": torch.from_numpy(p_np["a"]), "b": {"c": torch.from_numpy(np32(jp["b"]["c"])).bfloat16(),
                                                   "d": torch.from_numpy(p_np["b"]["d"])}}
    jopt, topt = jadamw.init_opt_state(jp), tadamw.init_opt_state(tp)
    for _ in range(5):
        g_np = jax.tree_util.tree_map(lambda a: rng.randn(*a.shape).astype(np.float32), p_np)
        jp, jopt, jm = jadamw.adamw_update(jax.tree_util.tree_map(jnp.asarray, g_np), jopt, jp, jcfg)
        tp, topt, tm = tadamw.adamw_update(jax.tree_util.tree_map(torch.from_numpy, g_np), topt, tp, cfg)
        assert int(topt["count"]) == int(jopt["count"])
        for key in ("grad_norm", "lr"):
            np.testing.assert_allclose(float(tm[key]), float(jm[key]), rtol=1e-6)
        for tree_t, tree_j in ((tp, jp), (topt["m"], jopt["m"]), (topt["v"], jopt["v"])):
            for path, t, j in paired(tree_t, tree_j):
                if t.dtype == torch.bfloat16:
                    np.testing.assert_allclose(np32(t), np32(j), rtol=2 ** -7, atol=0, err_msg=path)
                else:
                    np.testing.assert_allclose(np32(t), np32(j), rtol=1e-6, atol=1e-7, err_msg=path)


def test_adamw_decreases_quadratic():
    """tests/test_hlo_cost_and_optim.py::test_adamw_decreases_quadratic."""
    cfg = tadamw.AdamWConfig(lr=0.1, warmup_steps=1, total_steps=100, weight_decay=0.0)
    params = {"w": torch.tensor([5.0, -3.0])}
    opt = tadamw.init_opt_state(params)
    loss = lambda p: torch.sum(p["w"] ** 2)
    l0 = float(loss(params))
    for _ in range(50):
        w = params["w"].detach().requires_grad_()
        (g,) = torch.autograd.grad(loss({"w": w}), [w])
        params, opt, metrics = tadamw.adamw_update({"w": g}, opt, params, cfg)
    assert float(loss(params)) < 0.05 * l0
    assert float(metrics["grad_norm"]) >= 0


def test_adamw_clip_and_schedule():
    """tests/test_hlo_cost_and_optim.py::test_adamw_clip_and_schedule."""
    cfg = tadamw.AdamWConfig(lr=1.0, clip_norm=1e-3, warmup_steps=10, total_steps=100)
    s0 = tadamw.schedule(cfg, torch.tensor(0, dtype=torch.int32))
    s9 = tadamw.schedule(cfg, torch.tensor(9, dtype=torch.int32))
    assert float(s0) < float(s9) <= 1.0
    params = {"w": torch.ones(3)}
    opt = tadamw.init_opt_state(params)
    new_params, _, _ = tadamw.adamw_update({"w": torch.full((3,), 1e6)}, opt, params, cfg)
    assert torch.isfinite(new_params["w"]).all()


# ---------------------------------------------------------------------------
# the data pipeline
# ---------------------------------------------------------------------------

QWEN_SMALL = (tconfigs.reduced_config(tconfigs.get_config("qwen3-14b")),
              jconfigs.reduced_config(jconfigs.get_config("qwen3-14b")))


@pytest.mark.parametrize("structured", [False, True])
@pytest.mark.parametrize("seed", [0, 17])
def test_host_batch_is_the_jax_packages_bit_for_bit(structured, seed):
    cfg, jcfg = QWEN_SMALL
    shape = ShapeSpec("t", 33, 5, "train")
    for step in (0, 1, 2, 1000):
        got = tpipeline.host_batch(cfg, shape, step, seed, structured)
        want = jpipeline.host_batch(jcfg, shape, step, seed, structured)
        assert set(got) == set(want) == {"tokens", "labels"}
        for k in got:
            assert got[k].dtype == want[k].dtype == np.int32
            np.testing.assert_array_equal(got[k], want[k])


def test_device_batch_and_prefetcher_deliver_the_steps_in_order():
    cfg, _ = QWEN_SMALL
    shape = ShapeSpec("t", 9, 2, "train")
    dev = torch.device("cpu")
    with tpipeline.Prefetcher(cfg, shape, dev, start_step=3, seed=2, depth=2) as feed:
        got = [next(feed) for _ in range(4)]
    assert not feed._thread.is_alive()
    assert [s for s, _ in got] == [3, 4, 5, 6]
    for step, batch in got:
        want = tpipeline.host_batch(cfg, shape, step, 2)
        for k in want:
            assert batch[k].device == dev and batch[k].dtype == torch.int32
            np.testing.assert_array_equal(batch[k].numpy(), want[k])


def test_prefetcher_raises_what_its_thread_raised():
    cfg = dataclasses.replace(QWEN_SMALL[0], vocab_size=0)  # numpy cannot draw from [0, 0)
    with tpipeline.Prefetcher(cfg, ShapeSpec("t", 4, 2, "train"), torch.device("cpu")) as feed:
        with pytest.raises(ValueError):
            next(feed)


# ---------------------------------------------------------------------------
# the model's loss and gradients
# ---------------------------------------------------------------------------


def perturbed_jax_params(jcfg, dtype, seed=0):
    """JAX-initialised weights as numpy in ``dtype``, with random non-zero
    norm weights (zeros would hide the ``1 + w``)."""
    tree = jcommon.init_params(JT.model_skel(jcfg), jax.random.PRNGKey(seed), dtype_override=dtype)
    rng = np.random.RandomState(seed)

    def fix(path, a):
        a = np.array(a)
        if any(getattr(k, "key", None) in NORMS for k in path):
            a = (rng.randn(*a.shape) * 0.3).astype(a.dtype)
        return a

    return jax.tree_util.tree_map_with_path(fix, tree)


def rounded_as_written(fn, *args):
    """``jax.jit(fn)(*args)`` compiled with XLA's excess precision off.  By
    default XLA on the CPU may drop a bf16 rounding between two f32 ops (it
    removes the f32 -> bf16 -> f32 pair), so the reference would keep f32
    where its program, and the port, round to bf16."""
    return jax.jit(fn).lower(*args).compile({"xla_allow_excess_precision": False})(*args)


@pytest.fixture(scope="module", params=["float32", "bfloat16"])
def loss_case(request):
    """reduced qwen3-14b in f32 or bf16 with the same weights and batch in
    both packages: both packages' loss and gradients, and the JAX package's
    f32 gradients of the same weights (for bf16, upcast)."""
    cfg, jcfg = QWEN_SMALL
    batch = jpipeline.host_batch(jcfg, ShapeSpec("t", 24, 3, "train"), 0, seed=1)
    grad32 = jax.value_and_grad(lambda p, jcfg32=jcfg: JT.train_loss(jcfg32, p, batch))
    if request.param == "bfloat16":
        cfg, jcfg = dataclasses.replace(cfg, **BF16), dataclasses.replace(jcfg, **BF16)
    np_params = perturbed_jax_params(jcfg, getattr(jnp, request.param))
    jloss, jgrads = rounded_as_written(jax.value_and_grad(lambda p: JT.train_loss(jcfg, p, batch)),
                                       jax.tree_util.tree_map(jnp.asarray, np_params))
    _, jgrads32 = grad32(jax.tree_util.tree_map(lambda a: jnp.asarray(a, jnp.float32), np_params))
    tparams = convert.params_from_jax(np_params, cfg, device="cpu")
    ps = tree_map(lambda t: t.requires_grad_(), tparams)
    tloss = TT.train_loss(cfg, ps, {k: torch.from_numpy(v) for k, v in batch.items()})
    tgrads = torch.autograd.grad(tloss, list(leaves(ps)))
    return request.param, tloss.detach(), jloss, unflatten_like(tparams, list(tgrads)), jgrads, jgrads32


def test_train_loss_matches_jax(loss_case):
    dtype, tloss, jloss = loss_case[:3]
    assert tloss.dtype == torch.float32
    np.testing.assert_allclose(float(tloss), float(jloss), rtol=1e-5 if dtype == "float32" else 2e-3)
    assert abs(float(tloss) - np.log(QWEN_SMALL[0].vocab_size)) < 1.5


def rel_l2(a, b) -> float:
    return float(np.linalg.norm(np32(a) - np32(b)) / np.linalg.norm(np32(b)))


def test_every_gradient_matches_jax(loss_case):
    """Each leaf's gradient keeps its parameter's type.  f32: within 1e-4 of
    the leaf's largest magnitude, elementwise (measured: 2e-6).

    bf16: within 2e-2 of the largest magnitude of the JAX bf16 gradient,
    elementwise (measured here: 1.1e-2, the embedding; with XLA's default
    excess precision the reference drops roundings the program asks for and
    q_norm's lies 2.2e-2 away).  Each package's bf16 gradients lie 1-2.5%
    (relative L2) from the f32 gradients of the same weights, so the port's
    must also lie no further from them than 1.5x the JAX package's do."""
    dtype, _, _, tgrads, jgrads, jgrads32 = loss_case
    n = 0
    for (path, g, w), (_, _, w32) in zip(paired(tgrads, jgrads), paired(tgrads, jgrads32)):
        assert g.dtype == getattr(torch, dtype), path
        assert np.abs(np32(w)).max() > 0, path
        if dtype == "float32":
            np.testing.assert_allclose(np32(g), np32(w), rtol=1e-4, atol=1e-4 * np.abs(np32(w)).max(), err_msg=path)
        else:
            assert rel_l2(g, w32) <= 1.5 * rel_l2(w, w32), (path, rel_l2(g, w32), rel_l2(w, w32))
            near_largest(g, w, 2e-2, path)
        n += 1
    assert n == len(jax.tree_util.tree_leaves(jgrads)) == 14


# ---------------------------------------------------------------------------
# the train step
# ---------------------------------------------------------------------------

STEP_SHAPE = ShapeSpec("t", 16, 4, "train")
STEP_ADAMW = dict(lr=3e-3, warmup_steps=2)


def jax_state(jcfg):
    """The JAX package's initial state (``init_state`` from PRNGKey(0)) as numpy,
    with random non-zero norm weights."""
    state = JS.init_state(jcfg, jax.random.PRNGKey(0))
    state = jax.tree_util.tree_map(np.asarray, state)
    state["params"] = perturbed_jax_params(jcfg, jnp.float32)
    return state


def jax_steps(jcfg, n, remat, state_np, steps=3):
    """Per-step metrics and final params of the JAX train step on a (1, 1)
    mesh.  The mesh's axes are Auto: under jax's default Explicit axes the
    reference's embedding gather does not trace (the failure of
    tests/test_hlo_cost_and_optim.py::test_train_step_loss_decreases_tiny_model)."""
    mesh = jax.make_mesh((1, 1), ("data", "model"), axis_types=(AxisType.Auto, AxisType.Auto))
    opts = JS.TrainOptions(num_microbatches=n, remat=remat,
                           adamw=dataclasses.replace(JS.TrainOptions().adamw, **STEP_ADAMW))
    state = jax.tree_util.tree_map(jnp.asarray, state_np)
    metrics = []
    with jax.set_mesh(mesh):
        step = jax.jit(JS.make_train_step(jcfg, mesh, STEP_SHAPE, opts))
        for i in range(steps):
            batch = {k: jnp.asarray(v) for k, v in jpipeline.host_batch(jcfg, STEP_SHAPE, i).items()}
            state, m = step(state, batch)
            metrics.append({k: float(v) for k, v in m.items()})
    return metrics, state


def port_steps(cfg, n, remat, state_np, steps=3):
    opts = TS.TrainOptions(num_microbatches=n, remat=remat,
                           adamw=dataclasses.replace(TS.TrainOptions().adamw, **STEP_ADAMW))
    state = convert.state_from_jax(state_np, cfg, device="cpu")
    step = TS.make_train_step(cfg, opts)
    metrics = []
    for i in range(steps):
        batch = tpipeline.device_batch(cfg, STEP_SHAPE, i, torch.device("cpu"))
        state, m = step(state, batch)
        metrics.append({k: float(v) for k, v in m.items()})
    return metrics, state


@pytest.fixture(scope="module")
def initial_state():
    return jax_state(QWEN_SMALL[1])


@pytest.mark.parametrize("remat", ["none", "full", "dots"])
@pytest.mark.parametrize("n", [1, 2], ids=["micro1", "micro2"])
def test_train_step_matches_jax(initial_state, n, remat):
    """Three steps of ``make_train_step`` against the JAX package's, from one
    state and on the same batches: loss, grad_norm and lr at 1e-5 relative.
    The parameters: each leaf's update (new - initial) within 1e-3 of the
    JAX update in relative L2, and every element within lr.  AdamW moves a
    weight by up to lr per step whatever its gradient's size: an element
    whose gradient is at the f32 noise of the sums (one of 16384 here had
    8e-8 of the largest) moves by a noisy fraction of lr that differs between
    the packages (3e-4 after three steps); a wrong sign would move a weight
    by 2 lr per step, and a wrong scale shows in grad_norm and the losses."""
    cfg, jcfg = QWEN_SMALL
    want_m, want_state = jax_steps(jcfg, n, remat, initial_state)
    got_m, got_state = port_steps(cfg, n, remat, initial_state)
    for i, (g, w) in enumerate(zip(got_m, want_m)):
        for key in ("loss", "grad_norm", "lr"):
            np.testing.assert_allclose(g[key], w[key], rtol=1e-5, err_msg=f"step {i + 1} {key}")
    assert int(got_state["step"]) == int(want_state["step"]) == 3
    assert int(got_state["opt"]["count"]) == 3
    lr = STEP_ADAMW["lr"]
    for (path, t, j), (_, _, p0) in zip(paired(got_state["params"], want_state["params"]),
                                        paired(got_state["params"], initial_state["params"])):
        t, j, p0 = np32(t), np.asarray(j), np.asarray(p0)
        du, dj = t - p0, j - p0
        assert np.abs(dj).max() > lr, path  # every leaf moved
        assert np.linalg.norm(du - dj) <= 1e-3 * np.linalg.norm(dj), path
        np.testing.assert_allclose(t, j, rtol=0, atol=lr, err_msg=path)


def test_remat_modes_give_the_same_gradients_bit_for_bit(initial_state):
    """Rematerialising a block recomputes the same operations: none, full
    and dots give identical losses, norms and parameters."""
    cfg, _ = QWEN_SMALL
    runs = [port_steps(cfg, 2, remat, initial_state, steps=2) for remat in TS.REMAT_MODES]
    for m, state in runs[1:]:
        assert m == runs[0][0]
        for a, b in zip(leaves(state["params"]), leaves(runs[0][1]["params"])):
            assert torch.equal(a, b)


def test_split_micro_refuses_a_batch_it_cannot_split():
    with pytest.raises(ValueError, match="does not split"):
        TS._split_micro({"tokens": torch.zeros(3, 4)}, 2)
    parts = TS._split_micro({"tokens": torch.arange(8).reshape(4, 2)}, 2)
    assert [p["tokens"].tolist() for p in parts] == [[[0, 1], [2, 3]], [[4, 5], [6, 7]]]


def test_unknown_remat_raises():
    with pytest.raises(ValueError, match="remat"):
        TS.make_train_step(QWEN_SMALL[0], TS.TrainOptions(remat="offload"))


def test_abstract_state_matches_jax():
    """The shapes and types of the JAX package's ``init_state``, in f32 and
    bf16, which the port's restore checks a checkpoint against.  The JAX
    package's own ``abstract_state`` has the same names and shapes, and the
    same types but for the parameters, which it gives their skeleton's
    bfloat16 whatever ``param_dtype`` says."""
    for dtype in ("float32", "bfloat16"):
        cfg, jcfg = (dataclasses.replace(c, dtype=dtype, param_dtype=dtype) for c in QWEN_SMALL)
        got = TS.abstract_state(cfg)
        want = jax.eval_shape(lambda: JS.init_state(jcfg, jax.random.PRNGKey(0)))
        n = 0
        for (path, t, j), (_, _, a) in zip(paired(got, want), paired(got, JS.abstract_state(jcfg))):
            assert t.device.type == "meta", path
            assert tuple(t.shape) == tuple(j.shape) == tuple(a.shape), path
            assert str(t.dtype).split(".")[-1] == str(j.dtype), path
            skeleton_type = path.startswith("/params") and dtype == "float32"
            assert (str(a.dtype) == "bfloat16") if skeleton_type else (a.dtype == j.dtype), path
            n += 1
        assert n == 2 + 3 * 14


def test_init_state_and_state_from_jax_lay_the_state_out_alike(initial_state):
    cfg, _ = QWEN_SMALL
    a = TS.init_state(cfg, seed=3, device="cpu")
    b = convert.state_from_jax(initial_state, cfg, device="cpu")
    for (path, x, y) in paired(a, b):
        assert x.shape == y.shape and x.dtype == y.dtype, path
    assert not any(t.any() for t in leaves(a["opt"])) and int(a["step"]) == 0
    assert all(t.dtype == torch.float32 for t in leaves(a["opt"]["m"]))


# ---------------------------------------------------------------------------
# the pod sync on gloo ranks
# ---------------------------------------------------------------------------

POD_RANKS = 2
POD_OPTIONS = TS.TrainOptions(num_microbatches=2, remat="full", pod_sync="hoplite_chain",
                              adamw=dataclasses.replace(TS.TrainOptions().adamw, **STEP_ADAMW))


@pytest.fixture(scope="module")
def pod_run(initial_state):
    """Two steps on 2 CPU rank processes, each with its half of the batch and
    the Hoplite chain between them; and the same two steps in this process on
    the joined batches, with no pod."""
    cfg, _ = QWEN_SMALL
    batches = [tpipeline.host_batch(cfg, STEP_SHAPE, i) for i in range(2)]
    ranks = TG.run_ranks(cases.train_pod_steps, POD_RANKS, "cpu", initial_state, batches, POD_OPTIONS,
                         timeout=300)
    state = convert.state_from_jax(initial_state, cfg, device="cpu")
    step = TS.make_train_step(cfg, POD_OPTIONS)
    metrics = []
    for b in batches:
        state, m = step(state, {k: torch.from_numpy(v) for k, v in b.items()})
        metrics.append({k: float(v) for k, v in m.items()})
    return ranks, (metrics, state)


def test_pod_ranks_end_bit_identical(pod_run):
    ranks, _ = pod_run
    assert ranks[0]["metrics"] == ranks[1]["metrics"]
    for a, b in zip(leaves(ranks[0]["state"]), leaves(ranks[1]["state"])):
        assert torch.equal(a, b)


def test_pod_step_matches_one_process_on_the_joined_batch(pod_run):
    """The mean of the two halves' gradients and losses is the joined
    batch's, up to f32 rounding: 1e-5 relative on the metrics, 1e-4 of each
    parameter's largest magnitude."""
    ranks, (metrics, state) = pod_run
    for got, want in zip(ranks[0]["metrics"], metrics):
        for key in ("loss", "grad_norm", "lr"):
            np.testing.assert_allclose(got[key], want[key], rtol=1e-5, err_msg=key)
    for path, t, w in paired(ranks[0]["state"]["params"], state["params"]):
        np.testing.assert_allclose(np32(t), np32(w), rtol=0, atol=1e-4 * float(w.abs().max()), err_msg=path)


def test_pod_sync_needs_a_hoplite_method_with_several_pods(monkeypatch):
    monkeypatch.setattr(TS.dist, "get_world_size", lambda group=None: 2)
    with pytest.raises(ValueError, match="no partitioner"):
        TS.make_train_step(QWEN_SMALL[0], TS.TrainOptions(pod_sync="gspmd"), pod=object())


# ---------------------------------------------------------------------------
# the launcher
# ---------------------------------------------------------------------------


def test_train_main_on_cpu_logs_the_jax_drivers_line(capsys):
    argv = ["--arch", "qwen3-14b", "--reduced", "--device", "cpu", "--steps", "4", "--log-every", "2",
            "--seq-len", "16", "--global-batch", "4", "--microbatches", "2"]
    state = ttrain.main(argv)
    out = capsys.readouterr().out
    assert "on cpu" in out and "step 2: loss=" in out and "step 4: loss=" in out and "done: 4 steps" in out
    assert "gnorm=" in out and "lr=" in out and "tok/s=" in out
    assert int(state["step"]) == 4


def test_run_records_every_step_and_is_reproducible():
    cfg, _ = QWEN_SMALL
    shape = ShapeSpec("t", 8, 2, "train")
    logs = []
    a = ttrain.run(cfg, shape, TS.TrainOptions(), "cpu", steps=3, seed=1, log_every=1, log=logs.append)[1]
    b = ttrain.run(cfg, shape, TS.TrainOptions(), "cpu", steps=3, seed=1, log_every=5, log=logs.append)[1]
    assert [r["step"] for r in a] == [1, 2, 3] and len(logs) == 3 + 1 + 1
    assert [r["loss"] for r in a] == [r["loss"] for r in b]
    assert all(np.isfinite(r["loss"]) and r["ms"] > 0 and not any(r["launches"].values()) for r in a)


def test_train_main_without_device_raises(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        ttrain.main(["--arch", "qwen3-14b", "--reduced", "--steps", "1"])


def test_train_main_ckpt_dir_is_not_ported(tmp_path, capsys):
    """Named when ``--ckpt-dir`` raised: it now saves and restarts as the JAX
    driver does (tests/test_torch_checkpoint.py holds the numbers)."""
    argv = ["--arch", "qwen3-14b", "--reduced", "--device", "cpu", "--log-every", "1", "--seq-len", "16",
            "--global-batch", "2", "--ckpt-dir", str(tmp_path), "--ckpt-every", "1"]
    ttrain.main(argv + ["--steps", "2"])
    out = capsys.readouterr().out
    assert "[restart]" not in out and "[ckpt] final checkpoint at step 2" in out
    assert sorted(os.listdir(tmp_path)) == ["step_00000001", "step_00000002"]
    state = ttrain.main(argv + ["--steps", "3"])
    out = capsys.readouterr().out
    assert "[restart] resumed from checkpoint step 2" in out and "step 3: loss=" in out
    assert "step 2: loss=" not in out and "[ckpt] final checkpoint at step 3" in out
    assert int(state["step"]) == 3


@pytest.mark.parametrize("method", sorted(TS.POD_SYNC_METHODS))
def test_train_main_pod_sync_is_not_ported(method):
    with pytest.raises(NotImplementedError, match="one pod"):
        ttrain.main(["--arch", "qwen3-14b", "--reduced", "--device", "cpu", "--pod-sync", method])


def test_train_module_runs_in_a_subprocess():
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    r = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.train", "--arch", "qwen3-14b", "--reduced", "--device", "cpu",
         "--steps", "2", "--log-every", "1", "--seq-len", "16", "--global-batch", "2"],
        capture_output=True, text=True, env=env, cwd=ROOT, timeout=300,
    )
    assert r.returncode == 0, r.stderr
    assert "step 2: loss=" in r.stdout
