"""The port's collectives, compression and pod sync against the JAX package's,
on the CPU.

The cases mirror tests/test_collectives_multidev.py.  The port runs them once
on 8 gloo rank processes (``run_ranks(..., "cpu")``, rank r holding row r);
the JAX package runs them once in a subprocess with 8 host devices (the main
process keeps one).  Both are module-scoped fixtures that return every case's
outputs, and the parametrised tests compare them: the chain, 2-D, ring and
pairwise schedules bit for bit in f32, anything through psum at rtol 1e-5
(its sums run in another order).  Every spawn has a timeout and no fixed port.
"""

import contextlib
import io
import json
import math
import subprocess
import sys
import textwrap
import time

import numpy as np
import pytest
import torch
from hypothesis import given, settings, strategies as st

import jax.numpy as jnp

import torch_rank_cases as cases
from repro.core import collectives as JC
from repro.core import planner as JP
from repro.optim import compression as jcomp
from repro_torch.core import collectives as TC
from repro_torch.core import group as TG
from repro_torch.core import planner as TP
from repro_torch.optim import compression as tcomp
from repro_torch.train import step as tstep
from repro_torch.tree import leaves

N = 8
X = np.random.RandomState(0).rand(N, 1536).astype(np.float32)
XX = np.random.RandomState(1).rand(2, 4, 32).astype(np.float32)


def port_config(c) -> TC.CollectiveConfig:
    """A JAX CollectiveConfig's values in the port's type."""
    return TC.CollectiveConfig(link=TP.LinkSpec(c.link.bandwidth, c.link.latency), num_chunks=c.num_chunks,
                               small_bytes=c.small_bytes, step_overhead=c.step_overhead)


REF_ICI = port_config(JC.ICI_CONFIG)
REF_DCN = port_config(JC.DCN_CONFIG)

# ---------------------------------------------------------------------------
# the two runs
# ---------------------------------------------------------------------------

JAX_SCRIPT = """
import json, os, sys
os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=8"
sys.path.insert(0, "src")
import numpy as np
import jax, jax.numpy as jnp
from jax.sharding import PartitionSpec as P
from repro.core import collectives as C
from repro.optim import compression
from repro.train.step import TrainOptions, _pod_sync_fn

x = np.random.RandomState(0).rand(8, 1536).astype(np.float32)
xx = np.random.RandomState(1).rand(2, 4, 32).astype(np.float32)
mesh = jax.make_mesh((8,), ("x",))
mesh2 = jax.make_mesh((2, 4), ("p", "x"))
mesh_pod = jax.make_mesh((8,), ("pod",))
out, steps = {}, {}

def scan_lengths(jaxpr):
    found = []
    for eqn in jaxpr.eqns:
        if eqn.primitive.name == "scan":
            found.append(int(eqn.params["length"]))
        for p in eqn.params.values():
            for sub in (p if isinstance(p, (list, tuple)) else [p]):
                sub = getattr(sub, "jaxpr", sub)  # a closed jaxpr holds one
                if hasattr(sub, "eqns"):
                    found += scan_lengths(sub)
    return found

def run(name, fn, arg, m=mesh, spec=P("x")):
    g = jax.shard_map(fn, mesh=m, in_specs=(spec,), out_specs=spec)
    with jax.set_mesh(m):
        res = jax.jit(g)(arg)
        steps[name] = scan_lengths(jax.make_jaxpr(g)(arg).jaxpr)
    for k, v in (res.items() if isinstance(res, dict) else [("", res)]):
        out[name + ("/" + k if k else "")] = np.asarray(v)

run("chain_allreduce/4", lambda a: C.chain_allreduce(a, "x", num_chunks=4), x)
run("chain_allreduce/16", lambda a: C.chain_allreduce(a, "x", num_chunks=16), x)
run("two_level_allreduce/4", lambda a: C.two_level_allreduce(a, "x", num_chunks=4), x)
run("rs_ag_allreduce", lambda a: C.rs_ag_allreduce(a, "x"), x)
run("hoplite_psum", lambda a: C.hoplite_psum(a, "x"), x)
run("chain_reduce/4", lambda a: C.chain_reduce(a, "x", 4), x)
y = np.zeros((8, 64), np.float32); y[7] = 2.5
run("chain_broadcast/last", lambda a: C.chain_broadcast(a, "x", 4), y)
y0 = np.zeros((8, 64), np.float32); y0[0] = -1.5
run("chain_broadcast/first", lambda a: C.chain_broadcast(a, "x", 4, root="first"), y0)
for root in (0, 3, 7):
    z = np.zeros((8, 16), np.float32); z[root] = root + 1.0
    run(f"binomial_broadcast/{root}", lambda a, r=root: C.binomial_broadcast(a, "x", r), z)
spec2 = P("p", "x")
run("n2/chain_allreduce", lambda a: C.chain_allreduce(a, "p", 8), xx, mesh2, spec2)
run("n2/two_level_allreduce", lambda a: C.two_level_allreduce(a, "p", 4), xx, mesh2, spec2)
run("n2/rs_ag_allreduce", lambda a: C.rs_ag_allreduce(a, "p"), xx, mesh2, spec2)
run("n2/chain_reduce", lambda a: C.chain_reduce(a, "p", 4), xx, mesh2, spec2)
tree = {"a": x, "b": x[:, :17] * 2}
tspec = {"a": P("x"), "b": P("x")}
for method in ("psum", "hoplite", "chain", "chain2d", "rs_ag"):
    run(f"grad_sync/{method}", lambda t, m=method: C.grad_sync(t, "x", method=m), tree, spec=tspec)
pspec = {"a": P("pod"), "b": P("pod")}
for pod_sync in ("hoplite_chain", "hoplite_2d", "psum"):
    for comp in (False, True):
        sync = _pod_sync_fn(TrainOptions(pod_sync=pod_sync, pod_compression=comp))
        run(f"pod_sync/{pod_sync}/{'int8' if comp else 'raw'}", sync, tree, mesh_pod, pspec)
# the same int8 syncs with the compression compiled apart from the sync
run("compressed", lambda t: jax.tree_util.tree_map(compression.compress_decompress, t), tree, mesh_pod, pspec)
ctree = {"a": out["compressed/a"], "b": out["compressed/b"]}
for pod_sync in ("hoplite_chain", "hoplite_2d", "psum"):
    run(f"pod_sync_apart/{pod_sync}/int8", _pod_sync_fn(TrainOptions(pod_sync=pod_sync)), ctree, mesh_pod, pspec)
np.savez(sys.argv[1], **out)
with open(sys.argv[2], "w") as f:
    json.dump(steps, f)
"""


@pytest.fixture(scope="module")
def ref(tmp_path_factory):
    """Every case's outputs from the JAX package on 8 host devices, and the
    lengths of the scans (fori_loops) each schedule traced to."""
    d = tmp_path_factory.mktemp("jax_collectives")
    proc = subprocess.run([sys.executable, "-c", textwrap.dedent(JAX_SCRIPT), str(d / "out.npz"), str(d / "steps")],
                          capture_output=True, text=True, timeout=300, cwd=".")
    assert proc.returncode == 0, f"stdout:\n{proc.stdout}\nstderr:\n{proc.stderr[-3000:]}"
    with np.load(d / "out.npz") as f:
        out = dict(f)
    return out, json.loads((d / "steps").read_text())


@pytest.fixture(scope="module")
def port():
    """Every case's outputs and counts from the port's 8 CPU rank processes."""
    return TG.run_ranks(cases.collective_cases, N, "cpu", X, XX, REF_ICI, timeout=300)


def gathered(port, name):
    """The ranks' outputs of a case as the JAX package lays out its global
    array: rank r's rows at row r, or at [r // 4, r % 4] for the pairs."""
    outs = [p["out"][name] for p in port]
    if name.startswith("n2/"):
        return np.stack([o.numpy() for o in outs]).reshape(2, 4, *outs[0].shape[1:])
    if isinstance(outs[0], dict):
        return {k: np.concatenate([o[k].numpy() for o in outs]) for k in outs[0]}
    return np.concatenate([o.numpy() for o in outs])


EXACT = ["chain_allreduce/4", "chain_allreduce/16", "two_level_allreduce/4", "rs_ag_allreduce",
         "chain_reduce/4", "chain_broadcast/last", "chain_broadcast/first", "binomial_broadcast/0",
         "binomial_broadcast/3", "binomial_broadcast/7", "n2/chain_allreduce", "n2/two_level_allreduce",
         "n2/rs_ag_allreduce", "n2/chain_reduce"]
EXACT_TREES = ["grad_sync/chain", "grad_sync/chain2d", "grad_sync/rs_ag", "pod_sync/hoplite_chain/raw",
               "pod_sync/hoplite_chain/int8", "pod_sync/hoplite_2d/raw", "pod_sync/hoplite_2d/int8"]
PSUM_TREES = ["grad_sync/psum", "grad_sync/hoplite", "pod_sync/psum/raw", "pod_sync/psum/int8"]


@pytest.mark.parametrize("name", EXACT)
def test_schedule_equals_the_jax_package_bit_for_bit(ref, port, name):
    np.testing.assert_array_equal(gathered(port, name), ref[0][name])


def test_hoplite_psum_matches_the_jax_package(ref, port):
    np.testing.assert_allclose(gathered(port, "hoplite_psum"), ref[0]["hoplite_psum"], rtol=1e-5)
    np.testing.assert_allclose(ref[0]["hoplite_psum"], np.broadcast_to(X.sum(0), X.shape), rtol=1e-5)


@pytest.mark.parametrize("name", EXACT_TREES)
def test_tree_sync_equals_the_jax_package_bit_for_bit(ref, port, name):
    """The int8 cases are held to the JAX package's sync of its own compressed
    tree, compiled apart (see the test below for why)."""
    got = gathered(port, name)
    want = name.replace("pod_sync/", "pod_sync_apart/") if name.endswith("/int8") else name
    assert set(got) == {"a", "b"}
    for k in got:
        np.testing.assert_array_equal(got[k], ref[0][f"{want}/{k}"])


@pytest.mark.parametrize("name", ["pod_sync/hoplite_chain/int8", "pod_sync/hoplite_2d/int8"])
def test_int8_pod_sync_is_one_ulp_from_the_fused_jax_program(ref, port, name):
    """Where a leg of the JAX schedule has one chunk (DCN_CONFIG picks C = 1
    for these 6 KB leaves), XLA inlines the one-step loop and contracts the
    dequantize multiply with the first hop's add into one FMA; compiled apart
    from the sync (the bit-for-bit test above) it rounds twice, as the port
    does.  So the fused program may differ by one f32 rounding, no more."""
    got = gathered(port, name)
    for k in got:
        np.testing.assert_allclose(got[k], ref[0][f"{name}/{k}"], rtol=2.4e-7, atol=0)


def test_compressed_tree_equals_the_jax_package(ref):
    """Each rank's compress-decompress of its shard, as _pod_sync_fn does it."""
    for k, v in {"a": X, "b": X[:, :17] * 2}.items():
        got = np.concatenate([tcomp.compress_decompress(torch.from_numpy(v[r:r + 1])).numpy() for r in range(N)])
        np.testing.assert_array_equal(got, ref[0][f"compressed/{k}"])


@pytest.mark.parametrize("name", PSUM_TREES)
def test_psum_tree_sync_matches_the_jax_package(ref, port, name):
    got = gathered(port, name)
    for k in got:
        np.testing.assert_allclose(got[k], ref[0][f"{name}/{k}"], rtol=1e-5)


def test_sums_are_right(port):
    """The reference outputs are what the tests above hold the port to; one
    look at the arithmetic keeps a shared mistake from passing."""
    want = X.sum(0)
    for name in ("chain_allreduce/4", "two_level_allreduce/4", "rs_ag_allreduce"):
        for p in port:
            np.testing.assert_allclose(p["out"][name].numpy()[0], want, rtol=1e-6)
            assert p["calls"][name]["devices"] == ["cpu"] and p["calls"][name]["launches"] == 0


# ---------------------------------------------------------------------------
# step counts and hops
# ---------------------------------------------------------------------------


def _steps(name):
    if name.startswith("chain_allreduce/"):
        return [TC.chain_allreduce_steps(N, int(name.split("/")[1]))]
    if name in ("chain_reduce/4", "chain_broadcast/last", "chain_broadcast/first"):
        return [TC.chain_leg_steps(N, 4)]
    if name == "two_level_allreduce/4":
        return list(TC.two_level_steps(N, 4))
    if name == "n2/two_level_allreduce":
        return list(TC.two_level_steps(2, 4))
    if name == "n2/chain_reduce":
        return [TC.chain_leg_steps(2, 4)]
    raise KeyError(name)


STEP_CASES = ["chain_allreduce/4", "chain_allreduce/16", "chain_reduce/4", "chain_broadcast/last",
              "chain_broadcast/first", "two_level_allreduce/4", "n2/two_level_allreduce", "n2/chain_reduce"]


@pytest.mark.parametrize("name", STEP_CASES)
def test_step_counts_equal_the_reference_loops(ref, port, name):
    """The pure step functions equal the trip counts of the JAX schedule's
    fori_loops, and the port's schedule makes that many exchange steps."""
    want = _steps(name)
    assert ref[1][name] == want
    g = TC.two_level_group_sizes(2 if name.startswith("n2/") else N)[0]
    for r, p in enumerate(port):
        got = p["calls"][name]["exchange"]
        if name.startswith("chain_allreduce/"):
            assert got == 2 * want[0]  # two legs per step
        elif "two_level" in name:
            group_rank = r // 4 if name.startswith("n2/") else r
            root = group_rank % g == g - 1  # the roots run all four legs
            assert got == (sum(want) if root else want[0] + want[3])
        else:
            assert got == want[0]


def _hops(name, r):
    """hop_launches for a case of rank r."""
    leaves = {"a": X[:1], "b": X[:1, :17]}
    if name.startswith("grad_sync/"):
        method, config = name.split("/")[1], REF_ICI
    elif name.startswith("pod_sync/"):
        method = tstep.POD_SYNC_METHODS[name.split("/")[1]]
        config = TC.HOST_STAGED_CONFIG
    else:
        method = {"chain_allreduce": "chain", "two_level_allreduce": "chain2d", "rs_ag_allreduce": "rs_ag"}[
            name.split("/")[0]]
        config = TC.CollectiveConfig(num_chunks=4)
        leaves = {"a": X[:1]}
    return sum(TC.hop_launches(method, N, r, v.nbytes, config) for v in leaves.values())


@pytest.mark.parametrize("name", ["chain_allreduce/4", "two_level_allreduce/4", "rs_ag_allreduce"]
                         + [f"grad_sync/{m}" for m in cases.GRAD_METHODS]
                         + [f"pod_sync/{s}/{c}" for s in cases.POD_SYNCS for c in ("raw", "int8")])
def test_hop_launches_predicts_the_hops(port, name):
    got = [p["calls"][name]["chunk_reduce"] for p in port]
    assert got == [_hops(name, r) for r in range(N)]
    if "psum" in name or name == "grad_sync/hoplite":
        assert sum(got) == 0
    else:
        assert sum(got) > 0
    assert all(p["calls"][name]["launches"] == 0 for p in port)  # CPU tensors: the plain version


def test_chain_ranks_agree_bit_for_bit(port):
    for name in EXACT[:4]:
        first = port[0]["out"][name]
        assert all(torch.equal(p["out"][name], first) for p in port)


# ---------------------------------------------------------------------------
# pure helpers on a grid, with the reference's link values passed in
# ---------------------------------------------------------------------------

SIZES = [1 << k for k in range(10, 31)]  # 1 KB .. 1 GB


@pytest.mark.parametrize("link", ["ici", "dcn"])
@pytest.mark.parametrize("n", range(2, 17))
def test_helpers_equal_the_reference_on_a_grid(n, link):
    jcfg = JC.ICI_CONFIG if link == "ici" else JC.DCN_CONFIG
    tcfg = port_config(jcfg)
    tlink = tcfg.link
    assert TC.two_level_group_sizes(n) == JC.two_level_group_sizes(n)
    for nbytes in SIZES:
        assert TC.autotune_num_chunks(n, nbytes, tlink, jcfg.step_overhead) == \
            JC.autotune_num_chunks(n, nbytes, jcfg.link, jcfg.step_overhead)
        assert tcfg.chunks_for(n, nbytes) == jcfg.chunks_for(n, nbytes)
        assert tcfg.chunks_for_2d(n, nbytes) == jcfg.chunks_for_2d(n, nbytes)
        assert tcfg.choose(n, nbytes) == jcfg.choose(n, nbytes)
        assert TP.use_two_dimensional(n, tlink, nbytes) == JP.use_two_dimensional(n, jcfg.link, nbytes)
    mask = [i % 3 != 0 for i in range(n)]
    assert TC.partial_fold_scale(mask) == JC.partial_fold_scale(mask)


def test_step_functions_follow_the_reference_formulas():
    for n in range(3, 17):
        for c in (1, 4, 16, 256):
            assert TC.chain_allreduce_steps(n, c) == c + 2 * n - 3
            assert TC.chain_leg_steps(n, c) == c + n - 2
            g, m = JC.two_level_group_sizes(n)
            assert TC.two_level_steps(n, c) == (c + g - 2, c + m - 2, c + m - 2, c + g - 2)


def test_port_link_is_its_own():
    """No TPU constant: the port's default link is not the reference's ICI or DCN."""
    for ref_link in (JP.ICI_LINK, JP.DCN_LINK):
        assert (TP.HOST_STAGED_LINK.bandwidth, TP.HOST_STAGED_LINK.latency) != (ref_link.bandwidth, ref_link.latency)
    assert TC.HOST_STAGED_CONFIG.link == TP.HOST_STAGED_LINK
    assert TC.HOST_STAGED_CONFIG.step_overhead == 0.0


# ---------------------------------------------------------------------------
# compression
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("n", [1, 255, 256, 257, 1536, 70_000])
@pytest.mark.parametrize("seed", [0, 1])
def test_quantize_int8_equals_the_jax_package(n, seed):
    rng = np.random.RandomState(seed)
    x = (rng.randn(n) * rng.rand() * 10).astype(np.float32)
    x[: n // 7] = 0.0  # all-zero blocks take the + 1e-12
    jq, js = jcomp.quantize_int8(jnp.asarray(x))
    tq, ts = tcomp.quantize_int8(torch.from_numpy(x))
    assert tq.dtype == torch.int8 and tuple(tq.shape) == jq.shape
    np.testing.assert_array_equal(tq.numpy(), np.asarray(jq))  # bit for bit
    np.testing.assert_array_equal(ts.numpy(), np.asarray(js))
    got = tcomp.compress_decompress(torch.from_numpy(x))
    np.testing.assert_array_equal(got.numpy(), np.asarray(jcomp.compress_decompress(jnp.asarray(x))))


def test_compress_decompress_keeps_bf16():
    x = np.random.RandomState(3).randn(4, 300).astype(np.float32)
    want = jcomp.compress_decompress(jnp.asarray(x, jnp.bfloat16))
    got = tcomp.compress_decompress(torch.from_numpy(x).to(torch.bfloat16))
    assert got.dtype == torch.bfloat16 and got.shape == (4, 300)
    np.testing.assert_array_equal(got.float().numpy(), np.asarray(want, np.float32))


@settings(max_examples=15, deadline=None)
@given(seed=st.integers(0, 2**31 - 1), n=st.integers(10, 4000))
def test_int8_quantization_bounded_error(seed, n):
    """tests/test_properties.py's bound on the port: at most scale/2 per element."""
    rng = np.random.RandomState(seed)
    x = torch.from_numpy((rng.randn(n) * rng.rand()).astype(np.float32))
    y = tcomp.compress_decompress(x)
    _, s = tcomp.quantize_int8(x)
    scales = s.repeat_interleave(256)[:n]
    assert torch.all((y - x).abs() <= scales / 2 + 1e-7)


def test_error_feedback_unbiased_over_time():
    """The EF-SGD telescoping property, as tests/test_properties.py holds it."""
    rng = np.random.RandomState(0)
    grads = [torch.from_numpy(rng.randn(512).astype(np.float32)) for _ in range(30)]
    res = tcomp.init_residuals(grads[0])
    sent_total = torch.zeros(512)
    true_total = torch.zeros(512)
    for g in grads:
        sent, res = tcomp.ef_sync(g, res, sync_fn=lambda x: x)
        sent_total += sent
        true_total += g
    assert (sent_total - true_total).abs().max() <= res.abs().max() + 1e-5


def test_ef_sync_equals_the_jax_package_on_a_tree():
    rng = np.random.RandomState(4)
    g = {"w": rng.randn(3, 100).astype(np.float32), "b": [rng.randn(7).astype(np.float32)]}
    e = {"w": (rng.randn(3, 100) * 0.01).astype(np.float32), "b": [np.zeros(7, np.float32)]}
    jsent, jres = jcomp.ef_sync({k: (jnp.asarray(v) if k == "w" else [jnp.asarray(v[0])]) for k, v in g.items()},
                                {k: (jnp.asarray(v) if k == "w" else [jnp.asarray(v[0])]) for k, v in e.items()},
                                sync_fn=lambda t: t)
    tg = {"w": torch.from_numpy(g["w"]), "b": [torch.from_numpy(g["b"][0])]}
    te = {"w": torch.from_numpy(e["w"]), "b": [torch.from_numpy(e["b"][0])]}
    tsent, tres = tcomp.ef_sync(tg, te, sync_fn=lambda t: t)
    np.testing.assert_array_equal(tsent["w"].numpy(), np.asarray(jsent["w"]))
    np.testing.assert_array_equal(tsent["b"][0].numpy(), np.asarray(jsent["b"][0]))
    np.testing.assert_array_equal(tres["w"].numpy(), np.asarray(jres["w"]))
    assert tcomp.init_residuals(tg)["b"][0].dtype == torch.float32


# ---------------------------------------------------------------------------
# rules of the rank processes
# ---------------------------------------------------------------------------


def test_run_ranks_without_device_or_cuda_raises(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        TG.run_ranks(cases.card_cases, 2, None, X[:2], timeout=60)


def test_run_ranks_raises_when_a_rank_fails():
    with pytest.raises(RuntimeError, match="rank 1 of 2 failed"):
        TG.run_ranks(cases.fail_on_rank_1, 2, "cpu", timeout=120)


def test_run_ranks_raises_at_its_timeout():
    t0 = time.monotonic()
    with pytest.raises(TimeoutError, match="within"):
        TG.run_ranks(cases.hang, 2, "cpu", timeout=3)
    assert time.monotonic() - t0 < 60


def test_pod_sync_rejects_gspmd():
    with pytest.raises(ValueError, match="gspmd"):
        tstep._pod_sync_fn(tstep.TrainOptions(pod_sync="gspmd"))


# ---------------------------------------------------------------------------
# the entry point of the slice
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def sync_run():
    """launch.sync on 4 CPU ranks over a reduced block's f32 tree, with a
    chunk sweep: (its summary, what it printed)."""
    from repro_torch.launch import sync

    printed = io.StringIO()
    with contextlib.redirect_stdout(printed):
        summary = sync.main(["--arch", "qwen3-14b", "--reduced", "--device", "cpu", "--ranks", "4",
                             "--sweep", "0.5,1,2", "--repeats", "2"])
    return summary, printed.getvalue()


def test_sync_entry_point_on_cpu(sync_run):
    """launch.sync drives every method; each rank checks itself against the
    seeded mean and raises."""
    from repro_torch.launch import sync

    summary, printed = sync_run
    assert set(summary["methods"]) == set(sync.METHODS)
    for name, m in summary["methods"].items():
        assert m["chunk_reduce"] == [0, 0, 0, 0]  # CPU tensors take the plain version
        assert m["max_abs_err"] < 1e-5
        assert m["ranks_agree"] or name == "psum"
    assert summary["link"]["latency_s"] > 0 and summary["link"]["bandwidth_Bps"] > 0
    assert "4 ranks on cpu" in printed


def test_sync_chunk_sweep_on_cpu(sync_run):
    """Each factor scales every leaf's autotuned chunk count within its
    clamps; each rank held the swept result to the autotuned chain's."""
    from repro_torch.configs import get_config, reduced_config
    from repro_torch.launch import sync
    from repro_torch.models import transformer as T

    summary, printed = sync_run
    cfg = reduced_config(get_config("qwen3-14b"))
    sizes = [math.prod(p.shape) * 4 for p in leaves(T.layer_skel(cfg, cfg.pattern[0]))]
    auto = [TC.HOST_STAGED_CONFIG.chunks_for(4, b) for b in sizes]
    assert summary["sweep"][1.0]["chunks"] == auto == sync.swept_chunks(sizes, 4, 1.0)
    for f in (0.5, 2.0):
        want = [max(1, min(round(f * c), TC.MAX_NUM_CHUNKS, b // TC.MIN_CHUNK_BYTES)) for c, b in zip(auto, sizes)]
        assert summary["sweep"][f]["chunks"] == want
        assert len(summary["sweep"][f]["rounds_s"]) == 2 and summary["sweep"][f]["wall_s"] > 0
    ring = summary["link"]["ring"]
    assert ring["latency_s"] > 0 and ring["large_step_s"] > ring["latency_s"]
    assert "at 2.0 x the autotuned chunks" in printed


def test_sync_entry_point_defaults_to_the_card(monkeypatch):
    from repro_torch.launch import sync

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        sync.main(["--arch", "qwen3-14b", "--reduced"])
