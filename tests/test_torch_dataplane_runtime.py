"""The port's task runtime and parameter-server example against the JAX ones.

``repro_torch.runtime.Runtime(..., device="cpu")`` runs the scenarios of
``tests/test_runtime_and_ft.py`` and ``tests/test_elastic_reduce.py``
beside ``repro.runtime.Runtime``: the same results and, call for call, the
same placements.  The parameter server (``repro_torch.examples.
async_parameter_server``) at its defaults is held to
``examples/async_parameter_server.py``: with both runtimes' ``wait``
taking finishers in submission order (the one change that makes either
run deterministic), the parameters after every round agree within 2e-5
and so do the losses.  Four recoveries the JAX runtime lacks are held
here too: a reduce re-executes a source lost with its node, a Get whose
own node was killed and restarted under it fetches again, a task whose
own node is dead when it Puts or Gets runs again on a live node, and a
Put whose picked node died before it landed picks another.
"""

import importlib.util
import threading
import time
from pathlib import Path

import numpy as np
import pytest
import torch

from repro.core import api as JA
from repro.runtime import runtime as JR
from repro_torch.core import api as TA
from repro_torch.core.local import DeadNode, LocalCluster
from repro_torch.examples import async_parameter_server as ps
from repro_torch.runtime import runtime as TR

ROOT = Path(__file__).resolve().parents[1]
ELEMS = 32_768  # 256 KB of float64: past the inline threshold


def t2n(x):
    return x.cpu().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def runtime(side, **kw):
    if side == "torch":
        return TR.Runtime(device="cpu", **kw)
    return JR.Runtime(**kw)


def both(fn):
    return fn("jax", JR, JA), fn("torch", TR, TA)


# ---------------------------------------------------------------------------
# tests/test_runtime_and_ft.py's scenarios on both runtimes
# ---------------------------------------------------------------------------


def test_remote_get_and_ref_args_match_jax():
    def run(side, R, A):
        rt = runtime(side, num_nodes=3)
        r = rt.remote(lambda a, b: a + b, np.arange(4.0), np.ones(4))
        a = rt.put(np.arange(1000.0))
        b = rt.remote(lambda x: x * 2, a, node=1)
        c = rt.remote(lambda x: x.sum(), b, node=2)
        return t2n(rt.get(r)), float(t2n(rt.get(c))), [x.node for x in (r, a, b, c)]

    (jr, jc, jn), (tr, tc, tn) = both(run)
    np.testing.assert_array_equal(tr, jr)
    assert tc == jc == np.arange(1000.0).sum() * 2
    assert tn == jn


def test_results_are_tensors_on_the_clusters_device():
    rt = TR.Runtime(num_nodes=2, device="cpu")
    r = rt.remote(lambda: np.arange(3, dtype=np.int32))
    out = rt.get(r)
    assert isinstance(out, torch.Tensor) and out.dtype == torch.int32 and out.device.type == "cpu"
    seen = {}
    rt.get(rt.remote(lambda x: seen.setdefault("arg", x), rt.put(np.ones(5))))
    assert isinstance(seen["arg"], torch.Tensor) and seen["arg"].device.type == "cpu"


def test_wait_first_k_matches_jax():
    def run(side, R, A):
        rt = runtime(side, num_nodes=2, executors_per_node=8)

        def slow(t):
            time.sleep(float(t))
            return np.float64(t)

        refs = [rt.remote(slow, 0.4), rt.remote(slow, 0.01), rt.remote(slow, 0.02)]
        done, rest = rt.wait(refs, num_returns=2, timeout=10)
        got = [t2n(rt.get(d)) for d in done]
        assert all(g.shape == () for g in got)
        return sorted(float(g) for g in got), len(rest)

    j, t = both(run)
    assert t == j == ([0.01, 0.02], 1)


def test_dynamic_reduce_and_task_error_match_jax():
    def run(side, R, A):
        rt = runtime(side, num_nodes=4)
        refs = [rt.put(np.full(500, float(i))) for i in range(7)]
        out = t2n(rt.get(rt.reduce(refs, A.SUM)))

        def boom():
            raise RuntimeError("boom")

        with pytest.raises(R.TaskError):
            rt.get(rt.remote(boom))
        with pytest.raises(R.TaskError):  # a source error fails the reduce through its callback
            rt.get(rt.reduce([rt.put(np.ones(ELEMS)), rt.remote(boom)], A.SUM, timeout=30.0), timeout=30.0)
        return out

    j, t = both(run)
    np.testing.assert_array_equal(t, j)
    np.testing.assert_array_equal(t, np.full(500, float(sum(range(7)))))


def test_lineage_reconstruction_after_node_loss_matches_jax():
    def run(side, R, A):
        rt = runtime(side, num_nodes=3)
        r = rt.remote(lambda: np.arange(50_000, dtype=np.float64), node=1)
        rt.get(r, node=1)
        rt.cluster.fail_node(1)
        return t2n(rt.get(r, node=0)), rt.tasks_reexecuted

    (jo, jn), (to, tn) = both(run)
    np.testing.assert_array_equal(to, jo)
    assert tn == jn == 1


def test_placements_match_jax_call_for_call():
    """Round-robin placement over live, non-draining members, through
    puts, tasks, reduces, a kill with restart, a join and a drain."""

    def run(side, R, A):
        rt = runtime(side, num_nodes=4, seed=3)
        nodes = []
        refs = [rt.put(np.full(10, float(i))) for i in range(5)]
        refs += [rt.remote(lambda x: x + 1, r) for r in refs[:3]]
        refs.append(rt.reduce(refs[:4], A.SUM))
        rt.get(refs[-1])
        rt.cluster.fail_node(2)
        refs += [rt.remote(lambda: np.ones(3)) for _ in range(5)]
        rt.cluster.restart_node(2)
        j = rt.add_node()
        refs += [rt.put(np.ones(3)) for _ in range(6)]
        rt.drain_node(j, deadline=5.0)
        refs += [rt.remote(lambda: np.ones(3)) for _ in range(6)]
        refs.append(rt.reduce(refs[-3:], A.SUM))
        for r in refs:
            rt.get(r, timeout=30.0)
            nodes.append(rt.placement_of(r))
        return nodes

    j, t = both(run)
    assert t == j and len(set(t)) >= 4


# ---------------------------------------------------------------------------
# recoveries beyond the JAX runtime
# ---------------------------------------------------------------------------


def test_reduce_re_executes_a_source_lost_with_its_node():
    vals = [np.full(ELEMS, float(i + 1)) for i in range(3)]

    def run(side, R, A):
        rt = runtime(side, num_nodes=4)
        refs = [rt.remote(lambda v=v: v, node=i + 1) for i, v in enumerate(vals)]
        rt.wait(refs, num_returns=3, timeout=30.0)
        rt.cluster.fail_node(2)  # refs[1]'s only copy
        rt.cluster.restart_node(2)
        out = rt.reduce(refs, A.SUM, node=0, timeout=30.0)
        try:
            return t2n(rt.get(out, timeout=30.0)), rt.tasks_reexecuted
        except R.TaskError as e:
            return e, rt.tasks_reexecuted

    (j, jn), (t, tn) = both(run)
    assert isinstance(j, JR.TaskError) and jn == 0  # the JAX runtime fails this reduce
    np.testing.assert_array_equal(t, sum(vals))
    assert tn == 1


def test_get_fetches_again_when_its_node_restarted_under_it(monkeypatch):
    rt = TR.Runtime(num_nodes=3, device="cpu")
    ref = rt.put(np.arange(ELEMS, dtype=np.float64), node=0)
    calls = []
    orig = LocalCluster.get

    def flaky(self, node, object_id, timeout=None):
        calls.append(node)
        if len(calls) == 1:
            raise DeadNode(node)  # killed and restarted under the fetch: alive again now
        return orig(self, node, object_id, timeout=timeout)

    monkeypatch.setattr(LocalCluster, "get", flaky)
    np.testing.assert_array_equal(t2n(rt.get(ref, node=1)), np.arange(ELEMS, dtype=np.float64))
    assert calls == [1, 1] and rt.tasks_reexecuted == 0
    rt.cluster.fail_node(1)
    with pytest.raises(DeadNode):  # still dead: no retry
        rt.get(ref, node=1)


@pytest.mark.parametrize("where", ["put", "get"])
def test_task_runs_again_when_its_node_died_under_it(where):
    """A task on node 1 whose node is killed (and not yet restarted) before
    it Puts its result, or before it Gets its argument: the JAX runtime
    fails it with ``DeadNode``, the port runs it again on a live node."""
    want = np.arange(ELEMS, dtype=np.float64)

    def run(side, R, A):
        rt = runtime(side, num_nodes=3)
        if where == "put":
            go = threading.Event()

            def task():
                go.wait(10.0)
                return want

            ref = rt.remote(task, node=1)
            rt.cluster.fail_node(1)
            go.set()
        else:
            arg = rt.put(want, node=0)
            rt.cluster.fail_node(1)
            ref = rt.remote(lambda v: v, arg, node=1)
        try:
            return t2n(rt.get(ref, node=0, timeout=30.0)), rt.tasks_reexecuted, ref.node
        except R.TaskError as e:
            return e, rt.tasks_reexecuted, ref.node

    (j, jn, _), (t, tn, tnode) = both(run)
    assert isinstance(j, JR.TaskError) and str(j) == "1" and jn == 0
    np.testing.assert_array_equal(t, want)
    assert tn == 1 and tnode in (0, 2)


def test_put_picks_again_when_its_node_died_before_the_put(monkeypatch):
    """The node ``put`` picked is killed before the Put reaches it: the JAX
    runtime raises ``DeadNode``, the port puts on another live node.  A
    node the caller named is not replaced."""
    want = np.arange(ELEMS, dtype=np.float64)

    def run(side, R, A):
        rt = runtime(side, num_nodes=3)
        orig = type(rt.cluster).put
        killed = []

        def put(self, node, object_id, value):
            if not killed:
                killed.append(node)
                self.fail_node(node)  # lands between the pick and the Put
            return orig(self, node, object_id, value)

        monkeypatch.setattr(type(rt.cluster), "put", put)
        try:
            ref = rt.put(want)
        except Exception as e:  # noqa: BLE001
            return e, killed, None
        finally:
            monkeypatch.setattr(type(rt.cluster), "put", orig)
        return t2n(rt.get(ref, node=ref.node)), killed, ref.node

    (j, jk, _), (t, tk, tnode) = both(run)
    assert type(j).__name__ == "DeadNode" and str(j) == str(jk[0])
    np.testing.assert_array_equal(t, want)
    assert tnode is not None and tnode != tk[0]
    rt = TR.Runtime(num_nodes=3, device="cpu")
    rt.cluster.fail_node(1)
    with pytest.raises(DeadNode):
        rt.put(want, node=1)


def test_streaming_reduce_splices_a_joiner():
    rt = TR.Runtime(cluster=LocalCluster(3, chunk_size=4096, pace=0.002, device="cpu"))
    vals = [np.full(ELEMS, float(i + 1)) for i in range(4)]

    def grad(i):
        time.sleep(0.3 * i)
        return vals[i]

    refs = [rt.remote(grad, i, node=i) for i in range(3)]
    out = rt.reduce(refs, TA.SUM, node=0, timeout=60.0)
    time.sleep(0.15)
    joiner = rt.add_node()
    gref = rt.put(vals[3], node=joiner)
    assert rt.splice_contribution(out.id, gref) is True
    np.testing.assert_array_equal(t2n(rt.get(out, node=0, timeout=60.0)), sum(vals))
    assert rt.cluster.stats["splices_join"] == 1 and rt.cluster.stats["resplices"] == 0


# ---------------------------------------------------------------------------
# the parameter server against examples/async_parameter_server.py
# ---------------------------------------------------------------------------


def _in_order_wait(self, refs, num_returns=1, timeout=60.0):
    """``wait`` taking the first ``num_returns`` refs in submission order."""
    refs = list(refs)
    for r in refs[:num_returns]:
        r.ready.wait(timeout)
    return refs[:num_returns], refs[num_returns:]


def _jax_example():
    spec = importlib.util.spec_from_file_location("jax_async_parameter_server",
                                                  ROOT / "examples" / "async_parameter_server.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def test_parameter_server_defaults_match_the_jax_example(monkeypatch, capsys):
    monkeypatch.setattr(JR.Runtime, "wait", _in_order_wait)
    monkeypatch.setattr(TR.Runtime, "wait", _in_order_wait)
    puts, placements = {"jax": [], "torch": []}, {"jax": [], "torch": []}
    for side, R in (("jax", JR), ("torch", TR)):
        orig_put, orig_remote = R.Runtime.put, R.Runtime.remote

        def put(self, value, node=None, _side=side, _orig=orig_put):
            ref = _orig(self, value, node)
            puts[_side].append(t2n(value).copy())
            placements[_side].append(ref.node)
            return ref

        def remote(self, fn, *args, node=None, _side=side, _orig=orig_remote, **kw):
            ref = _orig(self, fn, *args, node=node, **kw)
            placements[_side].append(ref.node)
            return ref

        monkeypatch.setattr(R.Runtime, "put", put)
        monkeypatch.setattr(R.Runtime, "remote", remote)

    jmod = _jax_example()
    jmod.main()
    out = ps.run(device="cpu", log=lambda s: None)
    capsys.readouterr()

    assert placements["torch"] == placements["jax"]
    assert len(puts["torch"]) == len(puts["jax"]) == ps.ROUNDS + 1
    for t, j in zip(puts["torch"], puts["jax"]):
        np.testing.assert_allclose(t, j, rtol=2e-5, atol=2e-5)
    shards = [jmod.make_data(s) for s in range(jmod.NUM_WORKERS)]
    want = [float(np.mean([np.mean((X @ w - y) ** 2) for X, y in shards])) for w in puts["jax"]]
    np.testing.assert_allclose(out["losses"], want, rtol=2e-5)
    assert out["losses"][-1] < 0.7 * out["losses"][0]
    assert (ps.DIM, ps.NUM_NODES, ps.NUM_WORKERS, ps.ROUNDS, ps.LR) == (
        jmod.DIM, jmod.NUM_NODES, jmod.NUM_WORKERS, jmod.ROUNDS, jmod.LR)


def test_parameter_server_shards_are_the_jax_examples():
    jmod = _jax_example()
    for s, (X, y) in enumerate(ps.make_shards(3, ps.DIM, ps.SAMPLES, torch.device("cpu"))):
        jX, jy = jmod.make_data(s)
        np.testing.assert_array_equal(X.numpy(), jX)
        np.testing.assert_array_equal(y.numpy(), jy)


def test_parameter_server_past_the_inline_size_re_executes_and_converges():
    """Objects of 160 KB: the kill loses the newest parameters' only copy,
    the next round's tasks re-execute its Put, and the loss still falls."""
    out = ps.run(nodes=8, workers=8, dim=40_000, samples=16, device="cpu", log=lambda s: None)
    assert out["tasks_reexecuted"] >= 1
    assert out["losses"][-1] < 0.7 * out["losses"][0]
    assert out["lr"] == pytest.approx(ps.LR * 16 / 40_000)
    assert out["runtime"].cluster.stats["fold_ops"] > 0
    out["runtime"].cluster.shutdown()


def test_parameter_server_draws_on_the_device_from_the_same_seeds():
    a = ps.make_shards(2, 64, 8, torch.device("cpu"), data="device")
    b = ps.make_shards(2, 64, 8, torch.device("cpu"), data="device")
    for (xa, ya), (xb, yb) in zip(a, b):
        assert torch.equal(xa, xb) and torch.equal(ya, yb) and xa.shape == (8, 64)
    assert not torch.equal(a[0][0], a[1][0])
    with pytest.raises(ValueError):
        ps.make_shards(1, 4, 4, torch.device("cpu"), data="disk")
    assert ps.learning_rate(200, 1000) == ps.LR
