"""Hoplite-Serve in the port (``repro_torch.serve``) on the CPU, against the
JAX package's ``repro.serve``.

``tests/test_serve_ensemble.py``'s scenarios (all but the simulator's, which
``tests/test_torch_simulation.py`` holds) run on ``Runtime(...,
device="cpu")`` with the JAX tests' f64 payloads and with f32 ones, whose
replies fold through ``chunk_reduce``'s plain version; the autoscaler and
router scenarios of ``tests/test_elastic_membership.py`` run on the port's
classes.  Parity with the JAX package: the aggregated values of both
``EnsembleGroup``s on the same weights and payloads (f32 at 2e-5), both
``QueueAutoscaler``s' actions through one signal script, and both routers'
arrival schedules for seeds 0-2 with their clocks faked.  Tests wait on
cluster state, not on timers.
"""

import threading
import time
from types import SimpleNamespace

import numpy as np
import pytest
import torch

from repro.runtime import Runtime as JRuntime
from repro.serve import autoscaler as JAS
from repro.serve import ensemble as JE
from repro.serve import metrics as JM
from repro.serve import router as JRT
from repro_torch.core.api import SUM
from repro_torch.runtime import Runtime
from repro_torch.serve import (
    AutoscalerConfig,
    EnsembleConfig,
    EnsembleGroup,
    OpenLoopRouter,
    QueueAutoscaler,
    Rejected,
    RouterConfig,
    ServeMetrics,
)
from repro_torch.serve import autoscaler as TAS
from repro_torch.serve import metrics as TM
from repro_torch.serve import router as TRT

DTYPES = [np.float64, np.float32]


def t2n(x):
    return x.cpu().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def _model(w, x):
    return x * float(w.reshape(-1)[0])


def _make(num_nodes=8, quorum=5, **cfg_kwargs):
    rt = Runtime(num_nodes=num_nodes, executors_per_node=4, device="cpu")
    metrics = ServeMetrics()
    ens = EnsembleGroup(
        rt, model_fn=_model,
        config=EnsembleConfig(num_replicas=num_nodes, quorum=quorum, request_timeout_s=30.0, **cfg_kwargs),
        metrics=metrics,
    )
    return rt, ens, metrics


def wait_for(cond, timeout=30.0):
    """Wait until ``cond()`` holds: cluster state, polled, never a fixed sleep."""
    deadline = time.time() + timeout
    while not cond():
        assert time.time() < deadline, "the cluster never reached the state waited for"
        time.sleep(0.005)


def assert_values(value, want, dtype):
    assert isinstance(value, torch.Tensor) and value.device.type == "cpu"
    assert value.dtype == torch.from_numpy(np.zeros(0, dtype)).dtype
    np.testing.assert_allclose(t2n(value), want, rtol=1e-9 if dtype == np.float64 else 2e-6)


def folds_counted(rt, ens, before_folds):
    """SUM's folds since ``SUM.reset_counts()``: those of the cluster's
    chains and of the lineage fallback, each one ``chunk_reduce`` for f32."""
    return rt.cluster.stats["fold_ops"] - before_folds + ens.lineage_folds


# ---------------------------------------------------------------------------
# tests/test_serve_ensemble.py (a), (b)
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("dtype", DTYPES)
def test_open_loop_stream_k_of_n(dtype):
    rt, ens, metrics = _make()
    ens.deploy(np.full(32 * 1024, 2.0, dtype))  # past the inline size: broadcast tree
    router = OpenLoopRouter(ens, RouterConfig(rate_rps=40.0, max_outstanding=64), metrics)
    payloads = [np.full(128, float(i), dtype) for i in range(30)]
    SUM.reset_counts()
    folds0 = rt.cluster.stats["fold_ops"]
    router.run_open_loop(payloads, drain_timeout=90.0)

    snap = metrics.snapshot()
    assert snap["offered"] == 30
    assert snap["completed"] == snap["admitted"] == 30, (snap, router.errors)
    assert snap["failed"] == 0
    assert len(router.results) == 30
    for idx, value in router.results:
        assert_values(value, np.full(128, float(idx)) * 2.0, dtype)
    assert len(snap["per_replica"]) == 8
    assert sum(metrics.bytes_moved(rt.cluster.bytes_sent_per_node)) > 0
    folds = folds_counted(rt, ens, folds0)
    assert folds >= 4 * 30
    route = "chunk_reduce" if dtype == np.float32 else "add"
    assert SUM.counts == {route: folds}


@pytest.mark.parametrize("dtype", DTYPES)
def test_replica_kill_mid_stream_loses_nothing(dtype):
    rt, ens, metrics = _make()
    ens.deploy(np.full(32 * 1024, 3.0, dtype))
    router = OpenLoopRouter(ens, RouterConfig(rate_rps=40.0, max_outstanding=64), metrics)
    payloads = [np.full(128, 1.0, dtype) for _ in range(30)]
    killed = []

    def on_arrival(idx):
        if idx == 10:
            ens.kill_replica(7)
            killed.append(time.perf_counter())

    router.run_open_loop(payloads, on_arrival=on_arrival, drain_timeout=90.0)
    snap = metrics.snapshot()
    assert killed, "kill hook did not fire"
    assert snap["completed"] == snap["admitted"] == 30, (snap, router.errors)
    assert snap["failed"] == 0
    for _idx, value in router.results:
        assert_values(value, np.full(128, 3.0), dtype)
    assert len(ens.alive_replicas()) == 7
    assert metrics.latency.percentile(99) < 5.0
    assert ens.replicas[7].alive is False


# ---------------------------------------------------------------------------
# deployment: versioning + hot swap mid-traffic
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("dtype", DTYPES)
def test_weight_hot_swap_mid_traffic(dtype):
    rt, ens, _metrics = _make()
    v1 = ens.deploy(np.full(16 * 1024, 2.0, dtype))
    assert_values(ens.handle_request(np.ones(64, dtype)), np.full(64, 2.0), dtype)

    stop = threading.Event()
    errors, seen = [], set()

    def traffic():
        while not stop.is_set():
            try:
                val = t2n(ens.handle_request(np.ones(64, dtype)))
            except BaseException as e:  # noqa: BLE001
                errors.append(e)
                return
            # Either version is acceptable mid-swap, never a mix.
            if np.allclose(val, 2.0):
                seen.add(1)
            elif np.allclose(val, 4.0):
                seen.add(2)
            else:
                errors.append(AssertionError(str(val[:4])))
                return

    t = threading.Thread(target=traffic, daemon=True)
    t.start()
    wait_for(lambda: seen or errors)  # traffic is flowing before the swap
    v2 = ens.deploy(np.full(16 * 1024, 4.0, dtype))  # hot swap under load
    stop.set()
    t.join(timeout=30.0)
    assert not errors, errors
    assert v2 == v1 + 1
    assert_values(ens.handle_request(np.ones(64, dtype)), np.full(64, 4.0), dtype)
    ens.deploy(np.full(16 * 1024, 8.0, dtype))
    assert v1 not in ens.deployment.versions()


# ---------------------------------------------------------------------------
# admission control + runtime hooks
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("dtype", DTYPES)
def test_admission_rejects_below_quorum(dtype):
    rt, ens, _m = _make(quorum=5, replica_queue_depth=1)
    ens.deploy(np.full(1024, 2.0, dtype))
    for r in ens.replicas[:4]:
        assert r.queue.try_acquire()
    with pytest.raises(Rejected):
        ens.handle_request(np.ones(8, dtype))
    for r in ens.replicas[:4]:
        r.queue.release()
    assert_values(ens.handle_request(np.ones(8, dtype)), np.full(8, 2.0), dtype)


@pytest.mark.parametrize("dtype", DTYPES)
def test_runtime_placement_and_failure_hooks(dtype):
    rt = Runtime(num_nodes=4, device="cpu")
    ref = rt.remote(lambda: np.ones(8, dtype), node=2)
    assert t2n(rt.get(ref)).dtype == dtype
    assert rt.placement_of(ref) == 2

    seen = []
    rt.add_failure_listener(lambda node, orphaned: seen.append((node, orphaned)))
    rt.fail_node(2)
    assert seen and seen[0][0] == 2

    done = []
    ref2 = rt.remote(lambda: np.asarray(5.0, dtype), node=0)
    ref2.add_done_callback(lambda r: done.append(r.id))
    rt.get(ref2)
    assert done == [ref2.id]
    late = []
    ref2.add_done_callback(lambda r: late.append(r.id))
    assert late == [ref2.id]


@pytest.mark.parametrize("dtype", DTYPES)
def test_publish_storm_does_not_delete_captured_version(dtype):
    rt, ens, _m = _make()
    ens.deploy(np.full(1024, 2.0, dtype))
    version, wref = ens.deployment.acquire()
    ens.deploy(np.full(1024, 4.0, dtype))
    ens.deploy(np.full(1024, 8.0, dtype))
    assert version not in ens.deployment.versions()
    np.testing.assert_allclose(t2n(rt.get(wref)), np.full(1024, 2.0))
    ens.deployment.release(version)
    with pytest.raises(Exception):
        rt.get(wref, timeout=0.5)


def _totals(rt):
    return (sum(len(s.objects) for s in rt.cluster.stores), len(rt._refs), len(rt._lineage))


@pytest.mark.parametrize("dtype", DTYPES)
def test_requests_do_not_leak_objects(dtype):
    """Store and ref-table occupancy is flat in the number of requests (the
    replies here are 64 KB and more, so the chains stream and fold)."""
    rt, ens, _m = _make()
    ens.deploy(np.full(16 * 1024, 2.0, dtype))
    for _ in range(3):
        ens.handle_request(np.ones(16 * 1024, dtype))
    # straggler cleanup callbacks fire at task completion
    wait_for(lambda: all(r.queue.inflight == 0 for r in ens.replicas))
    baseline = _totals(rt)
    for _ in range(15):
        ens.handle_request(np.ones(16 * 1024, dtype))
    wait_for(lambda: all(a <= b for a, b in zip(_totals(rt), baseline)))


# ---------------------------------------------------------------------------
# the port's own: values on the device, the lineage fallback's folds
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("dtype", [np.float32, np.float16])
def test_the_lineage_fallback_folds_through_sum(monkeypatch, dtype):
    """A reduce that fails sends ``_aggregate`` down the lineage path: it
    fetches each of the k replies and folds them with ``cfg.reduce_op``, k-1
    folds, each counted (``chunk_reduce`` for f32 and f16)."""
    from repro_torch.runtime import TaskError

    rt, ens, _m = _make(quorum=5)
    ens.deploy(np.full(1024, 2.0, np.float32))

    def fail(*a, **kw):
        raise TaskError("reduce refused")

    monkeypatch.setattr(rt, "reduce", fail)
    SUM.reset_counts()
    x = np.random.RandomState(0).rand(1000).astype(dtype)
    got = ens.handle_request(x)
    assert ens.lineage_folds == 4 and SUM.counts == {"chunk_reduce": 4}
    want = (x * np.float32(2.0)).astype(np.float64)  # five equal replies, their mean
    np.testing.assert_allclose(t2n(got).astype(np.float64), want, rtol=2e-3 if dtype == np.float16 else 2e-6)


def test_ensemble_with_no_device_and_no_cuda_raises(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        EnsembleGroup(Runtime(num_nodes=2), model_fn=_model, config=EnsembleConfig(num_replicas=2, quorum=1))


# ---------------------------------------------------------------------------
# tests/test_elastic_membership.py:276-424: the autoscaler and the router
# ---------------------------------------------------------------------------


class _FakeQueue:
    def __init__(self):
        self.inflight = 0


class _FakeReplica:
    def __init__(self, rid, node):
        self.replica_id = rid
        self.node = node
        self.queue = _FakeQueue()
        self.alive = True


class _FakeGroup:
    def __init__(self, n, metrics=None):
        self.config = SimpleNamespace(quorum=2)
        self.replicas = [_FakeReplica(i, i) for i in range(n)]
        self.metrics = metrics if metrics is not None else ServeMetrics()

    def alive_replicas(self):
        return [r for r in self.replicas if r.alive]

    def add_replica(self, node):
        rid = max(r.replica_id for r in self.replicas) + 1
        r = _FakeReplica(rid, node)
        self.replicas.append(r)
        return r

    def retire_replica(self, rid):
        for r in self.replicas:
            if r.replica_id == rid and r.alive:
                r.alive = False
                return r
        return None


class _FakeRuntime:
    def __init__(self):
        self.next_node = 100
        self.drained = []

    def add_node(self):
        self.next_node += 1
        return self.next_node

    def drain_node(self, node, deadline=None):
        self.drained.append(node)
        return []


class _Clock:
    def __init__(self):
        self.t = 0.0

    def __call__(self):
        return self.t


def _scaler(n=2, AS=TAS, metrics=None, **cfg):
    group = _FakeGroup(n, metrics)
    rt = _FakeRuntime()
    clock = _Clock()
    defaults = dict(min_replicas=2, max_replicas=6, hysteresis_s=1.0, retire_wait_s=0.1)
    defaults.update(cfg)
    sc = AS.QueueAutoscaler(rt, group, metrics=group.metrics, config=AS.AutoscalerConfig(**defaults), clock=clock)
    return sc, group, rt, clock


def test_autoscaler_scales_up_on_queue_depth():
    sc, group, rt, clock = _scaler(2)
    for r in group.alive_replicas():
        r.queue.inflight = 5
    assert sc.tick() == "scale-up"
    assert len(group.alive_replicas()) == 3
    assert sc.actions[0][1] == "scale-up"


def test_autoscaler_scales_up_on_rejections():
    sc, group, rt, clock = _scaler(2)
    group.metrics.inc("rejected", 3)
    assert sc.tick() == "scale-up"


def test_autoscaler_cooldown_blocks_back_to_back_actions():
    sc, group, rt, clock = _scaler(2, hysteresis_s=1.0)
    for r in group.alive_replicas():
        r.queue.inflight = 5
    assert sc.tick() == "scale-up"
    clock.t = 0.5
    assert sc.tick() is None
    clock.t = 1.5
    assert sc.tick() == "scale-up"


def test_autoscaler_scale_down_needs_full_dwell_and_respects_floor():
    sc, group, rt, clock = _scaler(2, hysteresis_s=1.0)
    for r in group.alive_replicas():
        r.queue.inflight = 5
    assert sc.tick() == "scale-up"
    for r in group.alive_replicas():
        r.queue.inflight = 0
    clock.t = 2.0
    assert sc.tick() is None
    clock.t = 2.5
    assert sc.tick() is None
    clock.t = 3.1
    assert sc.tick() == "scale-down"
    assert len(group.alive_replicas()) == 2
    assert rt.drained == [101]
    clock.t = 10.0
    assert sc.tick() is None
    assert len(group.alive_replicas()) == 2


def test_autoscaler_never_exceeds_max_replicas():
    sc, group, rt, clock = _scaler(2, max_replicas=3)
    for r in group.alive_replicas():
        r.queue.inflight = 9
    assert sc.tick() == "scale-up"
    clock.t = 5.0
    for r in group.alive_replicas():
        r.queue.inflight = 9
    assert sc.tick() is None
    assert len(group.alive_replicas()) == 3


def test_autoscaler_end_to_end_scale_up_then_down():
    """Real runtime + ensemble: saturate -> scale-up joins a node and stages
    the weights; idle dwell -> scale-down drains it back out."""
    rt = Runtime(num_nodes=3, executors_per_node=2, device="cpu")
    ens = EnsembleGroup(
        rt, model_fn=_model,
        config=EnsembleConfig(num_replicas=3, quorum=2, max_fanout=2, request_timeout_s=30.0),
    )
    ens.deploy(np.full(32 * 1024, 2.0))
    clock = _Clock()
    sc = QueueAutoscaler(
        rt, ens, metrics=ens.metrics,
        config=AutoscalerConfig(min_replicas=3, max_replicas=5, hysteresis_s=1.0, retire_wait_s=2.0,
                                drain_deadline_s=10.0),
        clock=clock,
    )
    n0 = rt.num_nodes
    ens.metrics.inc("rejected", 5)
    assert sc.tick() == "scale-up"
    assert rt.num_nodes == n0 + 1
    assert len(ens.alive_replicas()) == 4
    joiner = ens.replicas[-1].node
    assert rt.cluster.stores[joiner].contains(ens.deployment.current()[1].id)  # staged warm
    np.testing.assert_allclose(t2n(ens.handle_request(np.full(64, 3.0))), np.full(64, 6.0))

    clock.t = 2.0
    assert sc.tick() is None
    clock.t = 3.1
    assert sc.tick() == "scale-down"
    assert len(ens.alive_replicas()) == 3
    assert rt.num_nodes == n0
    np.testing.assert_allclose(t2n(ens.handle_request(np.full(64, 5.0))), np.full(64, 10.0))


class _SlowBackend:
    """handle_request blocks until released; counts concurrent entries."""

    def __init__(self):
        self.gate = threading.Event()
        self.entered = 0
        self._lock = threading.Lock()

    def handle_request(self, payload):
        with self._lock:
            self.entered += 1
        self.gate.wait(10.0)
        return payload


def test_router_drain_waits_for_in_flight():
    backend = _SlowBackend()
    metrics = ServeMetrics()
    router = OpenLoopRouter(backend, RouterConfig(rate_rps=1000.0, max_outstanding=4), metrics)
    for i in range(6):
        router.dispatch(i, np.float64(i))
    assert router.outstanding == 4
    snap = metrics.snapshot()
    assert snap["offered"] == 6 and snap["rejected"] == 2

    done = threading.Event()
    t = threading.Thread(target=lambda: (router.drain(timeout=30.0), done.set()), daemon=True)
    t.start()
    wait_for(lambda: backend.entered == 4)
    assert not done.wait(0.1)  # drain really waits on in-flight work
    backend.gate.set()
    assert done.wait(10.0)
    assert router.outstanding == 0
    snap = metrics.snapshot()
    assert snap["completed"] == 4
    assert snap["offered"] == snap["completed"] + snap["rejected"] + snap["failed"]
    assert snap["failed"] == 0


def test_router_drain_releases_replica_queue_slots():
    rt = Runtime(num_nodes=4, executors_per_node=2, device="cpu")
    release = threading.Event()

    def slow_model(w, x):
        release.wait(10.0)
        return x * float(w.reshape(-1)[0])

    ens = EnsembleGroup(
        rt, model_fn=slow_model,
        config=EnsembleConfig(num_replicas=4, quorum=3, replica_queue_depth=4, request_timeout_s=30.0),
    )
    ens.deploy(np.full(1024, 2.0))
    metrics = ens.metrics
    router = OpenLoopRouter(ens, RouterConfig(rate_rps=1000.0, max_outstanding=8), metrics)
    for i in range(10):
        router.dispatch(i, np.full(16, float(i)))
    wait_for(lambda: router.outstanding > 0 and any(r.queue.inflight for r in ens.replicas))
    release.set()
    router.drain(timeout=60.0)
    assert router.outstanding == 0
    wait_for(lambda: not any(r.queue.inflight for r in ens.replicas))
    snap = metrics.snapshot()
    assert snap["offered"] == 10
    assert snap["offered"] == snap["completed"] + snap["rejected"] + snap["failed"]
    assert snap["failed"] == 0 and len(router.errors) == 0


# ---------------------------------------------------------------------------
# parity with the JAX package
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("rows", [4, 160])  # replies of 2 KB (inline) and 80 KB (streamed, folded)
def test_aggregated_values_match_the_jax_ensemble(rows):
    """Both ``EnsembleGroup``s on the same f32 weights and payloads, the
    model ``x @ w`` (numpy on the JAX side, torch on the port's): the k-of-n
    means agree within 2e-5."""
    rng = np.random.RandomState(0)
    w = rng.randn(128, 128).astype(np.float32) / 8
    xs = [rng.randn(rows, 128).astype(np.float32) for _ in range(4)]

    def model(a, b):
        return b @ a

    cfg = dict(num_replicas=6, quorum=4, request_timeout_s=30.0)
    jens = JE.EnsembleGroup(JRuntime(num_nodes=6, executors_per_node=2), model, JE.EnsembleConfig(**cfg))
    tens = EnsembleGroup(Runtime(num_nodes=6, executors_per_node=2, device="cpu"), model, EnsembleConfig(**cfg))
    jens.deploy(w)
    tens.deploy(w)
    SUM.reset_counts()
    for x in xs:
        want = np.asarray(jens.handle_request(x))
        got = tens.handle_request(x)
        assert got.dtype == torch.float32 and want.dtype == np.float32
        np.testing.assert_allclose(t2n(got), want, rtol=2e-5, atol=2e-5)
        np.testing.assert_allclose(t2n(got), x.astype(np.float64) @ w.astype(np.float64), rtol=2e-5, atol=2e-5)
    assert SUM.counts.get("chunk_reduce", 0) >= 3 * len(xs) and set(SUM.counts) == {"chunk_reduce"}


def _signal_script(seed, steps=80):
    """A seeded sequence of (clock advance, per-replica in-flight depth,
    new rejections) ticks: bursts and idle spells."""
    rng = np.random.RandomState(seed)
    script = []
    for _ in range(steps):
        hot = rng.rand() < 0.4
        depth = int(rng.randint(3, 9)) if hot else int(rng.randint(0, 2))
        rejections = int(rng.randint(0, 4)) if hot and rng.rand() < 0.5 else 0
        script.append((float(rng.choice([0.2, 0.5, 1.1])), depth, rejections))
    return script


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_autoscalers_take_the_jax_autoscalers_actions(seed):
    """Both ``QueueAutoscaler``s driven through the same fake group, runtime
    and clock sequence take the same actions, tick for tick."""
    runs = {}
    for name, AS, M in (("jax", JAS, JM), ("torch", TAS, TM)):
        sc, group, rt, clock = _scaler(2, AS=AS, metrics=M.ServeMetrics(), max_replicas=7)
        ticks = []
        for dt, depth, rejections in _signal_script(seed):
            clock.t += dt
            for r in group.alive_replicas():
                r.queue.inflight = depth
            if rejections:
                group.metrics.inc("rejected", rejections)
            ticks.append(sc.tick())
        runs[name] = (ticks, sc.actions, rt.drained, [r.alive for r in group.replicas])
    assert runs["torch"] == runs["jax"]
    assert {"scale-up", "scale-down"} <= set(runs["torch"][0])


class _FakeTime:
    """``time`` for one router module: ``perf_counter`` and ``time`` read a
    virtual clock that only ``sleep`` advances."""

    def __init__(self):
        self.t = 1000.0
        self.sleeps = []
        self._lock = threading.Lock()

    def perf_counter(self):
        with self._lock:
            return self.t

    time = perf_counter

    def sleep(self, seconds):
        with self._lock:
            self.sleeps.append(seconds)
            self.t += seconds


class _EchoBackend:
    def handle_request(self, payload):
        return payload


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_routers_sleep_the_jax_routers_schedule(monkeypatch, seed):
    """With ``time`` faked in each router module, both routers sleep the same
    Poisson schedule (``np.random.RandomState(seed)``) and offer the same
    requests at the same virtual times."""
    runs = {}
    for name, R, M in (("jax", JRT, JM), ("torch", TRT, TM)):
        fake = _FakeTime()
        monkeypatch.setattr(R, "time", fake)
        arrivals = []
        router = R.OpenLoopRouter(_EchoBackend(), R.RouterConfig(rate_rps=40.0, max_outstanding=64, seed=seed),
                                  M.ServeMetrics())
        router.run_open_loop(list(range(25)), on_arrival=lambda i, f=fake, a=arrivals: a.append((i, f.t)),
                             drain_timeout=10.0)
        snap = router.metrics.snapshot()
        runs[name] = (fake.sleeps, arrivals, snap["offered"], snap["completed"], sorted(router.results))
    assert runs["torch"] == runs["jax"]
    assert len(runs["torch"][0]) == 25


# ---------------------------------------------------------------------------
# chip_smoke.py's serve_ensemble phase, rehearsed on the CPU at a small width
# ---------------------------------------------------------------------------


def _chip_smoke():
    import importlib.util
    from pathlib import Path

    spec = importlib.util.spec_from_file_location("chip_smoke", Path(__file__).resolve().parents[1] / "chip_smoke.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def test_chip_smoke_serve_ensemble_phase_on_the_cpu():
    """The phase's stream at d = 128 (8 KB payloads and replies) and 20 rps:
    the kill, the hot swap and the added replica, every value within its
    version's bound, nothing leaked, every fold counted."""
    cs = _chip_smoke()
    rec = cs.se_stream(torch, "cpu", device="cpu", d=128, rows=16, rate=20.0)
    assert rec["completed"] + rec["rejected"] == rec["offered"] == cs.SE_REQUESTS
    assert rec["versions_served"]["2"] >= 1 and rec["versions_served"]["1"] <= cs.SE_SWAP_AT
    assert rec["alive_replicas"] == cs.SE_REPLICAS and rec["added"]["staged"]
    assert rec["per_replica"][str(rec["added"]["replica"])] >= 1 and len(rec["alone_s"]) == cs.SE_WARMUP
    assert rec["chunk_reduce"] == 0 and rec["sum_folds"] >= (cs.SE_QUORUM - 1) * rec["completed"]
    assert rec["request_state_after"] == rec["request_state_before"]


def test_chip_smoke_version_check_fails_a_mix_and_a_wrong_value():
    cs = _chip_smoke()
    gen = torch.Generator().manual_seed(0)
    x = torch.randn(16, 64, generator=gen)
    w1, w2 = torch.randn(64, 64, generator=gen), torch.randn(64, 64, generator=gen)
    refs = {1: x @ w1, 2: x @ w2}
    k = 5
    assert cs.se_version_of(torch, sum([x @ w1] * k) / k, refs, k) == 1
    assert cs.se_version_of(torch, sum([x @ w2] * k) / k, refs, k) == 2
    mixed = (3 * (x @ w1) + 2 * (x @ w2)) / k  # three replies of version 1, two of version 2
    assert cs.se_version_of(torch, mixed, refs, k) is None
    off = refs[1].clone()
    off[3, 7] += 1e-3 * off.abs().max()
    assert cs.se_version_of(torch, off, refs, k) is None
