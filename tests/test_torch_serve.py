"""The port's serve path as a whole against the JAX package's, on the CPU,
and the port's rules: no JAX imports, the card by default, no fallback.

reduced qwen3-14b in f32 (2 layers, d=64, 4 heads, 1 kv head, head_dim 16),
JAX-initialised weights with non-zero norm weights carried across by
``convert.params_from_jax``.  Logits are held to rtol = atol = 1e-4: each
side sums the same f32 products in its own order through 2 layers, which
moves logits of size ~1 by about 1e-6; 1e-4 leaves room for that, and for
nothing a wrong mask, position or weight would produce.
"""

import ast
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

from repro import configs as jconfigs
from repro.models import common as jcommon
from repro.models import transformer as JT
from repro.serving import engine as jengine
from repro_torch import configs as tconfigs
from repro_torch import convert
from repro_torch.device import resolve_device
from repro_torch.kernels import ops as tops
from repro_torch.launch import serve as tserve
from repro_torch.models import transformer as TT
from repro_torch.serving import engine as tengine

ROOT = Path(__file__).resolve().parents[1]
TOL = dict(rtol=1e-4, atol=1e-4)
NORMS = ("ln1", "ln2", "final_norm", "q_norm", "k_norm")


def perturbed_jax_params(cfg, seed=0):
    """JAX-initialised f32 weights as numpy, with random non-zero norm weights."""
    tree = jcommon.init_params(JT.model_skel(cfg), jax.random.PRNGKey(seed), dtype_override=jnp.float32)
    rng = np.random.RandomState(seed)

    def fix(path, a):
        a = np.array(a)
        if any(getattr(k, "key", None) in NORMS for k in path):
            a = (rng.randn(*a.shape) * 0.3).astype(a.dtype)
        return a

    return jax.tree_util.tree_map_with_path(fix, tree)


@pytest.fixture(scope="module")
def model():
    cfg = tconfigs.reduced_config(tconfigs.get_config("qwen3-14b"))
    jcfg = jconfigs.reduced_config(jconfigs.get_config("qwen3-14b"))
    np_params = perturbed_jax_params(jcfg)
    assert np.abs(np_params["final_norm"]["w"]).min() > 0
    jparams = jax.tree_util.tree_map(jnp.asarray, np_params)
    tparams = convert.params_from_jax(np_params, cfg, device="cpu")
    return cfg, jcfg, jparams, tparams


def prompts(cfg, B, S, seed):
    return np.random.RandomState(seed).randint(0, cfg.vocab_size, (B, S)).astype(np.int32)


def np32(x):
    return x.detach().float().numpy() if isinstance(x, torch.Tensor) else np.asarray(x, np.float32)


@pytest.fixture(autouse=True)
def _zero_counts():
    tops.reset_launch_counts()
    yield
    assert tops.launch_counts() == dict.fromkeys(
        ("rmsnorm", "flash_attention_tc", "flash_attention_f32", "chunk_reduce", "dequant_add"), 0)  # CPU: plain versions only


# ---------------------------------------------------------------------------
# the whole slice against the JAX package
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("S", [12, 7])
def test_prefill_and_decode_logits_match_jax(model, S):
    cfg, jcfg, jp, tp = model
    B, steps, C = 2, 8, 24
    toks = prompts(cfg, B, S + steps, seed=S)
    jl, jc = JT.prefill(jcfg, jp, {"tokens": jnp.asarray(toks[:, :S])}, cache_seq=C)
    tl, tc = TT.prefill(cfg, tp, {"tokens": torch.from_numpy(toks[:, :S])}, cache_seq=C)
    assert tl.dtype == torch.float32 and tl.shape == (B, cfg.padded_vocab)
    np.testing.assert_allclose(np32(tl), np32(jl), **TOL)
    np.testing.assert_allclose(np32(tc[0]["pos0"]["k"]), np32(jc[0]["pos0"]["k"]), **TOL)
    for t in range(S, S + steps):
        jl, jc = JT.decode_step(jcfg, jp, jnp.asarray(toks[:, t : t + 1]), jnp.int32(t), jc)
        tl, tc = TT.decode_step(cfg, tp, torch.from_numpy(toks[:, t : t + 1]), t, tc)
        np.testing.assert_allclose(np32(tl), np32(jl), **TOL, err_msg=f"decode step at {t}")
    np.testing.assert_allclose(np32(tc[0]["pos0"]["v"]), np32(jc[0]["pos0"]["v"]), **TOL)


def test_decode_matches_prefill_of_the_longer_prompt(model):
    """The chip smoke's cache check: decode step 1 == prefill(prompt + token)."""
    cfg, _, _, tp = model
    toks = torch.from_numpy(prompts(cfg, 3, 10, seed=2))
    logits, caches = TT.prefill(cfg, tp, {"tokens": toks}, cache_seq=16)
    first = logits[:, : cfg.vocab_size].argmax(-1)[:, None]
    step1, _ = TT.decode_step(cfg, tp, first, 10, caches)
    longer, _ = TT.prefill(cfg, tp, {"tokens": torch.cat([toks, first], dim=1)}, cache_seq=16)
    np.testing.assert_allclose(np32(step1), np32(longer), **TOL)


def test_engine_greedy_tokens_equal_jax(model):
    cfg, jcfg, jp, tp = model
    toks = prompts(cfg, 3, 9, seed=4)
    jeng = jengine.Engine(jcfg, None, jp, jengine.ServeOptions(max_seq=32, batch_size=3))
    teng = tengine.Engine(cfg, tp, tengine.ServeOptions(max_seq=32, batch_size=3))
    want = jeng.generate({"tokens": jnp.asarray(toks)}, 8)
    got = teng.generate({"tokens": toks}, 8)
    assert got.dtype == np.int32 and got.shape == (3, 8)
    np.testing.assert_array_equal(got, want)


def test_batching_loop_equals_jax(model):
    cfg, jcfg, jp, tp = model
    rng = np.random.RandomState(5)
    reqs = [(i, rng.randint(0, cfg.vocab_size, rng.randint(3, 9)).astype(np.int32), int(rng.randint(1, 6)))
            for i in range(5)]
    jloop = jengine.BatchingLoop(jengine.Engine(jcfg, None, jp, jengine.ServeOptions(max_seq=32, batch_size=2)))
    tloop = tengine.BatchingLoop(tengine.Engine(cfg, tp, tengine.ServeOptions(max_seq=32, batch_size=2)))
    for rid, prompt, n in reqs:
        jloop.submit(jengine.Request(rid, prompt, n))
        tloop.submit(tengine.Request(rid, prompt, n))
    jdone, tdone = jloop.run(), tloop.run()
    assert [r.rid for r in tdone] == [r.rid for r in jdone] == list(range(5))
    for a, b in zip(tdone, jdone):
        assert a.done and len(a.output) == a.max_new
        assert [int(x) for x in a.output] == [int(x) for x in b.output]


def test_temperature_sampling_follows_the_engine_generator(model):
    cfg, _, _, tp = model
    opts = tengine.ServeOptions(max_seq=32, batch_size=2, temperature=1.0)
    toks = prompts(cfg, 2, 6, seed=6)
    a = tengine.Engine(cfg, tp, opts).generate({"tokens": toks}, 6)
    b = tengine.Engine(cfg, tp, opts).generate({"tokens": toks}, 6)
    np.testing.assert_array_equal(a, b)
    assert a.min() >= 0 and a.max() < cfg.vocab_size


def test_prompt_longer_than_the_cache_raises(model):
    cfg, _, _, tp = model
    with pytest.raises(ValueError, match="does not fit"):
        TT.prefill(cfg, tp, {"tokens": torch.zeros((1, 9), dtype=torch.long)}, cache_seq=8)


# ---------------------------------------------------------------------------
# the whole slice in bf16, as the card serves it
# ---------------------------------------------------------------------------

BF16 = dict(dtype="bfloat16", param_dtype="bfloat16")


@pytest.fixture(scope="module")
def model_bf16():
    """reduced qwen3-14b with bf16 activations and JAX-initialised bf16
    weights (norm weights non-zero) in both packages."""
    cfg = dataclasses.replace(tconfigs.reduced_config(tconfigs.get_config("qwen3-14b")), **BF16)
    jcfg = dataclasses.replace(jconfigs.reduced_config(jconfigs.get_config("qwen3-14b")), **BF16)
    tree = jcommon.init_params(JT.model_skel(jcfg), jax.random.PRNGKey(0))
    rng = np.random.RandomState(0)

    def fix(path, a):
        a = np.array(a)
        if any(getattr(k, "key", None) in NORMS for k in path):
            a = (rng.randn(*a.shape) * 0.3).astype(a.dtype)
        return a

    np_params = jax.tree_util.tree_map_with_path(fix, tree)
    jparams = jax.tree_util.tree_map(jnp.asarray, np_params)
    tparams = convert.params_from_jax(np_params, cfg, device="cpu")
    assert tparams["embed"].dtype == torch.bfloat16 and jparams["embed"].dtype == jnp.bfloat16
    return cfg, jcfg, jparams, tparams


def bf16_logit_tol(want):
    """The bf16 tolerance (tests/test_kernels.py:16-17), the absolute part
    taken at the logits' scale.  The two packages round bf16 at places that
    differ (the port's plain flash rounds P against the row's max, the JAX
    model's ``flash_ref`` against each block's running max; XLA may keep f32
    where its program rounds): part of the attention outputs differ by one
    bf16 ulp, and the bf16 residual stream carries that into f32 logits of
    size 3-4 by a few hundredths, so a few logits near zero lie outside an
    absolute 2e-2."""
    return dict(rtol=2e-2, atol=2e-2 * float(np.abs(np32(want)).max()))


@pytest.mark.parametrize("S", [12, 7])
def test_prefill_and_two_decode_steps_match_jax_bf16(model_bf16, S):
    cfg, jcfg, jp, tp = model_bf16
    B, C = 2, 24
    toks = prompts(cfg, B, S + 2, seed=S)
    jl, jc = JT.prefill(jcfg, jp, {"tokens": jnp.asarray(toks[:, :S])}, cache_seq=C)
    tl, tc = TT.prefill(cfg, tp, {"tokens": torch.from_numpy(toks[:, :S])}, cache_seq=C)
    assert tl.dtype == torch.float32 and tl.shape == (B, cfg.padded_vocab)
    assert tc[0]["pos0"]["k"].dtype == torch.bfloat16
    np.testing.assert_allclose(np32(tl), np32(jl), **bf16_logit_tol(jl))
    # the first layer's cache lies upstream of every attention output
    for name in ("k", "v"):
        np.testing.assert_allclose(np32(tc[0]["pos0"][name][0]), np32(jc[0]["pos0"][name][0]), rtol=2e-2, atol=2e-2)
    for t in range(S, S + 2):
        jl, jc = JT.decode_step(jcfg, jp, jnp.asarray(toks[:, t : t + 1]), jnp.int32(t), jc)
        tl, tc = TT.decode_step(cfg, tp, torch.from_numpy(toks[:, t : t + 1]), t, tc)
        np.testing.assert_allclose(np32(tl), np32(jl), **bf16_logit_tol(jl), err_msg=f"decode step at {t}")


@pytest.mark.parametrize("seed", [4, 5, 6])
def test_engine_greedy_tokens_equal_jax_where_stable_bf16(model_bf16, seed):
    """Greedy tokens agree at every step whose context the two engines share.
    In each row the steps are compared in order while the tokens so far agree.
    The first differing token is allowed only where the choice is unstable,
    that is where the JAX logits' top-two gap is within twice the logit
    tolerance of the test above.  The two continuations part there, and the
    row ends.  At least half of all steps must have been compared."""
    cfg, jcfg, jp, tp = model_bf16
    B, S, N = 3, 9, 8
    toks = prompts(cfg, B, S, seed=seed)
    jeng = jengine.Engine(jcfg, None, jp, jengine.ServeOptions(max_seq=32, batch_size=B))
    teng = tengine.Engine(cfg, tp, tengine.ServeOptions(max_seq=32, batch_size=B))
    want = np.asarray(jeng.generate({"tokens": jnp.asarray(toks)}, N))
    got = teng.generate({"tokens": toks}, N)
    assert got.shape == want.shape == (B, N)
    seq = np.concatenate([toks, want], axis=1)
    jl, jc = JT.prefill(jcfg, jp, {"tokens": jnp.asarray(toks)}, cache_seq=32)
    gap = np.zeros((B, N))
    limit = np.zeros(N)
    for i in range(N):
        top2 = np.sort(np32(jl)[:, : cfg.vocab_size], axis=-1)[:, -2:]
        gap[:, i], limit[i] = top2[:, 1] - top2[:, 0], 2 * bf16_logit_tol(jl)["atol"]
        jl, jc = JT.decode_step(jcfg, jp, jnp.asarray(seq[:, S + i : S + i + 1]), jnp.int32(S + i), jc)
    agreed = np.zeros(B, int)  # leading steps on which the engines chose alike
    for r in range(B):
        for i in range(N):
            if got[r, i] != want[r, i]:
                assert gap[r, i] <= limit[i], (
                    f"row {r} step {i}: token {got[r, i]} != {want[r, i]} with a top-two gap of "
                    f"{gap[r, i]:.3f} > {limit[i]:.3f}")
                break
            agreed[r] += 1
    assert agreed.sum() >= B * N // 2, f"too few steps compared: {agreed} of {N} per row"


# ---------------------------------------------------------------------------
# rules
# ---------------------------------------------------------------------------


def _port_files():
    return sorted((ROOT / "src" / "repro_torch").rglob("*.py")) + [ROOT / "chip_smoke.py", ROOT / "kernel_turns.py"]


@pytest.mark.parametrize("path", _port_files(), ids=lambda p: str(p.relative_to(ROOT)))
def test_port_imports_neither_jax_nor_repro(path):
    bad = []
    for node in ast.walk(ast.parse(path.read_text(), str(path))):
        if isinstance(node, ast.Import):
            names = [a.name for a in node.names]
        elif isinstance(node, ast.ImportFrom):
            names = [node.module or ""] if node.level == 0 else []
        else:
            continue
        bad += [n for n in names if n.split(".")[0] in ("jax", "jaxlib", "repro")]
    assert not bad, f"{path.name} imports {bad}"


def test_resolve_device_defaults_to_cuda_and_never_falls_back(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        resolve_device()
    with pytest.raises(RuntimeError, match="no CUDA device"):
        resolve_device("cuda")
    assert resolve_device("cpu") == torch.device("cpu")


def test_serve_main_without_device_raises(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tserve.main(["--arch", "qwen3-14b", "--reduced"])


def test_serve_main_on_cpu_is_reproducible(capsys):
    argv = ["--arch", "qwen3-14b", "--reduced", "--device", "cpu", "--batch", "2",
            "--prompt-len", "5", "--new-tokens", "4", "--max-seq", "16", "--seed", "3"]
    a, b = tserve.main(argv), tserve.main(argv)
    assert a.shape == (2, 4) and np.array_equal(a, b)
    assert "on cpu" in capsys.readouterr().out


def test_serve_module_runs_in_a_subprocess():
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    r = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.serve", "--arch", "qwen3-14b", "--reduced", "--device", "cpu"],
        capture_output=True, text=True, env=env, cwd=ROOT, timeout=300,
    )
    assert r.returncode == 0, r.stderr
    assert "generated (4, 16) tokens" in r.stdout
