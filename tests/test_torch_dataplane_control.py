"""The data plane's control modules in the port against the JAX package's.

``repro_torch.core``'s planner, scheduler, fault injector, flight recorder
and directory are copies of ``repro.core``'s (they touch no payload), so
each is held to its counterpart exactly: the same inputs, or the same
seeded operation sequence, give the same outputs.  Also here: the package
rules of the data plane's modules (no ``repro``, no JAX; no device and no
CUDA raises) and the chunk autotune, which the port runs with its step
overhead of 0 on the paper's EC2 link.
"""

import ast
import dataclasses
import json
import random
from pathlib import Path

import numpy as np
import pytest
import torch

from repro.core import api as JA
from repro.core import directory as JD
from repro.core import faults as JF
from repro.core import planner as JP
from repro.core import scheduler as JS
from repro.core import store as JST
from repro.core import trace as JT
from repro.core.collectives import autotune_num_chunks as j_autotune_num_chunks
from repro.core.comm import backoff_delay as j_backoff_delay
from repro_torch.core import api as TA
from repro_torch.core import directory as TD
from repro_torch.core import faults as TF
from repro_torch.core import planner as TP
from repro_torch.core import scheduler as TS
from repro_torch.core import store as TST
from repro_torch.core import trace as TT
from repro_torch.core.comm import backoff_delay as t_backoff_delay
from repro_torch.core.local import LocalCluster
from repro_torch.runtime import Runtime

SRC = Path(__file__).resolve().parents[1] / "src" / "repro_torch"
DATAPLANE_MODULES = [
    "core/api.py", "core/planner.py", "core/scheduler.py", "core/trace.py", "core/faults.py",
    "core/directory.py", "core/store.py", "core/local.py", "core/comm/__init__.py",
    "core/comm/core.py", "core/comm/inproc.py", "core/comm/socket.py",
    "runtime/__init__.py", "runtime/runtime.py", "examples/async_parameter_server.py",
    "core/simulation.py", "serve/__init__.py", "serve/metrics.py", "serve/router.py", "serve/deploy.py",
    "serve/ensemble.py", "serve/autoscaler.py", "examples/quickstart.py",
]

KB, MB, GB = 1 << 10, 1 << 20, 1 << 30
NS = [1, 2, 3, 4, 7, 8, 9, 16, 64, 256, 1024]
SIZES = [1, KB, 64 * KB - 1, 64 * KB, MB, 32 * MB, GB]


def _links():
    return [(JP.EC2_LINK, TP.EC2_LINK), (JP.LinkSpec(1.25e9, 125e-6), TP.LinkSpec(1.25e9, 125e-6)),
            (JP.LinkSpec(2.162e9, 480.1e-6), TP.LinkSpec(2.162e9, 480.1e-6)),
            (JP.LinkSpec(1e8, 1e-3), TP.LinkSpec(1e8, 1e-3))]


def _plain(x):
    """Dataclasses and lists as plain Python values, for comparing the two
    packages' (distinct) classes."""
    if dataclasses.is_dataclass(x):
        return {f.name: _plain(getattr(x, f.name)) for f in dataclasses.fields(x)}
    if isinstance(x, (list, tuple)):
        return [_plain(v) for v in x]
    if isinstance(x, dict):
        return {k: _plain(v) for k, v in x.items()}
    if hasattr(x, "value") and hasattr(x, "name") and type(x).__module__.endswith(".api"):
        return x.name  # Progress
    return x


# ---------------------------------------------------------------------------
# package rules
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("module", DATAPLANE_MODULES)
def test_dataplane_module_imports_no_repro_and_no_jax(module):
    tree = ast.parse((SRC / module).read_text())
    for node in ast.walk(tree):
        names = []
        if isinstance(node, ast.Import):
            names = [a.name for a in node.names]
        elif isinstance(node, ast.ImportFrom) and node.module:
            names = [node.module]
        for name in names:
            top = name.split(".")[0]
            assert top not in ("repro", "jax", "jaxlib", "ml_dtypes"), f"{module} imports {name}"


def test_cluster_and_runtime_with_no_device_and_no_cuda_raise(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        LocalCluster(2)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        Runtime(num_nodes=2)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        LocalCluster(2, device="cuda")
    c = LocalCluster(2, device="cpu")
    assert c.device == torch.device("cpu")
    assert all(s.device == torch.device("cpu") for s in c.stores)
    assert Runtime(num_nodes=2, device="cpu").cluster.device == torch.device("cpu")


def test_the_port_carries_the_papers_link_and_no_tpu_link():
    assert dataclasses.astuple(TP.EC2_LINK) == dataclasses.astuple(JP.EC2_LINK)
    assert not hasattr(TP, "ICI_LINK") and not hasattr(TP, "DCN_LINK")
    assert LocalCluster(2, device="cpu").link == TP.EC2_LINK


# ---------------------------------------------------------------------------
# planner: every function over a grid of n, sizes and links
# ---------------------------------------------------------------------------


PLANNER_FNS = {
    "use_two_dimensional": lambda m, n, l, s: m.use_two_dimensional(n, l, s),
    "t_1d": lambda m, n, l, s: m.t_1d(n, l, s),
    "t_2d": lambda m, n, l, s: m.t_2d(n, l, s),
    "predicted_reduce_time": lambda m, n, l, s: m.predicted_reduce_time(n, l, s),
    "t_pipelined_multicast": lambda m, n, l, s: m.t_pipelined_multicast(n, l, s, 4096),
    "t_binomial_store_forward": lambda m, n, l, s: m.t_binomial_store_forward(n, l, s),
    "t_fused_allreduce": lambda m, n, l, s: m.t_fused_allreduce(n, l, s, 65536),
    "t_sequential_allreduce": lambda m, n, l, s: m.t_sequential_allreduce(n, l, s, 65536),
    "broadcast_policy_shared": lambda m, n, l, s: _plain(m.broadcast_policy(n, l, s, chunk=4096)),
    "broadcast_policy_independent": lambda m, n, l, s: _plain(
        m.broadcast_policy(n, l, s, chunk=float(max(64, s // 16)), egress_sharing=False)),
    "allreduce_policy": lambda m, n, l, s: _plain(m.allreduce_policy(n, l, s, chunk=4096)),
    "allreduce_policy_independent": lambda m, n, l, s: _plain(
        m.allreduce_policy(n, l, s, chunk=float(max(64, s // 16)), egress_sharing=False)),
    "bounded_time_participants": lambda m, n, l, s: (
        m.bounded_time_participants(n), m.bounded_time_participants(n, s % 7)),
    "splice_mode": lambda m, n, l, s: [m.splice_mode(a, f, s) for a in (True, False) for f in (0, n)],
}


@pytest.mark.parametrize("fn", sorted(PLANNER_FNS))
def test_planner_function_matches_jax_on_a_grid(fn):
    f = PLANNER_FNS[fn]
    for jl, tl in _links():
        for n in NS:
            for s in SIZES:
                assert f(TP, n, tl, s) == f(JP, n, jl, s), (fn, n, s, jl)


@pytest.mark.parametrize("n", [1, 2, 3, 5, 8, 17, 64, 256])
@pytest.mark.parametrize("size", [KB, MB, GB])
def test_plan_reduce_matches_jax(n, size):
    for jl, tl in _links():
        for seed in range(3):
            jp = JP.plan_reduce(range(n), jl, size, rng=random.Random(seed))
            tp = TP.plan_reduce(range(n), tl, size, rng=random.Random(seed))
            assert _plain(tp) == _plain(jp)
            assert TP.plan_depth(tp) == JP.plan_depth(jp)
            assert TP.max_chain_length(tp) == JP.max_chain_length(jp)
            assert tp.chain_lengths() == jp.chain_lengths() and tp.is_flat == jp.is_flat


# ---------------------------------------------------------------------------
# the chunk autotune: the EC2 link at a step overhead of 0
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("num_nodes", [2, 4, 8, 16])
def test_chunk_sizes_follow_ec2_at_zero_step_overhead(num_nodes):
    c = LocalCluster(num_nodes, device="cpu")
    for nbytes in [1, 63, 64, KB, 64 * KB, MB, 32 * MB + 4, GB]:
        k = j_autotune_num_chunks(num_nodes, nbytes, JP.EC2_LINK, 0.0)
        chunk = -(-nbytes // k)
        assert c.chunk_size_for(nbytes) == max(64, chunk + (-chunk) % 64), nbytes
    assert c.chunk_size_for(0) == TA.DEFAULT_CHUNK_SIZE
    pinned = LocalCluster(num_nodes, device="cpu", chunk_size=8192)
    assert pinned.chunk_size_for(GB) == pinned.chunk_size_for(KB) == 8192


# ---------------------------------------------------------------------------
# scheduler: partitions, chain lineage, source selection
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("n", [0, 1, 2, 3, 4, 5, 8, 16, 17, 40, 100])
def test_partition_groups_matches_jax(n):
    items = [f"o{i}" for i in range(n)]
    assert TS.partition_groups(items) == JS.partition_groups(items)
    for seed in range(5):
        for k in (None, 2, 3):
            assert (TS.partition_groups(items, random.Random(seed), k)
                    == JS.partition_groups(items, random.Random(seed), k))


def _drive_chain(mod, seed):
    """A seeded arrival sequence with tail and side splices and drain
    handoffs; every hop, the lineage and the final hop."""
    rng = random.Random(seed)
    chain = mod.ChainState(rng.randrange(5), tag=f"t{seed}", epoch=seed)
    out = []
    for i in range(rng.randrange(2, 14)):
        node, oid = rng.randrange(5), f"o{i}"
        r = rng.random()
        if r < 0.15:
            hop = chain.splice_source(node, oid, epoch=seed + i)
        elif r < 0.25:
            chain.splice_side(oid, epoch=seed + i)
            hop = None
        else:
            hop = chain.on_ready(node, oid)
        if rng.random() < 0.1:
            chain.note_drain_handoff(oid, epoch=seed + i)
        out.append(_plain(hop))
        out.append((chain.tail, list(chain.local_objects), dict(chain.lineage), chain.epoch))
    out.append(_plain(chain.final_hop("final")))
    return out


@pytest.mark.parametrize("seed", range(12))
def test_chain_state_lineage_matches_jax(seed):
    assert _drive_chain(TS, seed) == _drive_chain(JS, seed)


@pytest.mark.parametrize("seed", range(6))
def test_select_source_matches_jax(seed):
    rng = random.Random(seed)
    for _ in range(200):
        spec = [(rng.randrange(8), rng.random() < 0.4, rng.randrange(0, 100)) for _ in range(rng.randrange(0, 6))]
        loads = {rng.randrange(8): rng.randrange(3) for _ in range(rng.randrange(4))}
        served = {rng.randrange(8): rng.randrange(3) for _ in range(rng.randrange(4))}
        kw = dict(loads=loads, served=served, min_lead=rng.randrange(-1, 80),
                  max_out_degree=rng.choice([None, 1, 2]), tick=rng.randrange(100),
                  avoid=frozenset(rng.sample(range(8), rng.randrange(3))))

        def locs(api):
            return [api.Location(n, api.Progress.COMPLETE if c else api.Progress.PARTIAL, b) for n, c, b in spec]

        assert _plain(TS.select_source(locs(TA), **kw)) == _plain(JS.select_source(locs(JA), **kw))


# ---------------------------------------------------------------------------
# faults: the injector's draws and the backoff
# ---------------------------------------------------------------------------


def _injector_draws(mod, seed, n):
    plan = mod.FaultPlan.storm(seed, n, straggler_nodes=(1,), join_nodes=(n,), drain_nodes=(n - 1,),
                               bandwidth_factor=0.5)
    plan.conn_faults = [mod.ConnFault(kind="drop", p=0.5), mod.ConnFault(kind="delay", delay_s=0.01, p=0.5),
                        mod.ConnFault(kind="reset", src=0, reset_after=2, p=0.8)]
    inj = mod.FaultInjector(plan)
    out = [_plain(plan), inj.timeline()]
    for s in range(n):
        for d in range(n):
            for k in range(4):
                out.append((inj.chunk_factors(s, d, k), inj.window_penalty(s, d, k, 0.01),
                            inj.connect_fault(s, d, k), inj.reset_window(s, d, k)))
        out.append((inj.compute_delay(s, 1.0, k=s), inj.slow_factor(s, 0.0)))
    return out


@pytest.mark.parametrize("seed", [0, 3, 7, 21])
@pytest.mark.parametrize("n", [4, 8])
def test_fault_injector_draws_match_jax(seed, n):
    assert _injector_draws(TF, seed, n) == _injector_draws(JF, seed, n)


def test_fault_tolerance_config_and_backoff_match_jax():
    assert _plain(TF.FaultToleranceConfig()) == _plain(JF.FaultToleranceConfig())
    for seed in range(4):
        for src, dst in ((0, 1), (3, 2)):
            for k in range(10):
                for base, cap in ((0.05, 1.0), (0.01, 0.05)):
                    assert t_backoff_delay(seed, src, dst, k, base, cap) == j_backoff_delay(seed, src, dst, k, base, cap)


# ---------------------------------------------------------------------------
# trace: recorder, stage clock, critical path, Chrome export, histograms
# ---------------------------------------------------------------------------


def _recorded(mod, stats_mod, tmp_path, tag):
    now = [0.0]
    rec = mod.FlightRecorder(enabled=True, clock=lambda: now[0], capacity_per_thread=64)
    stats = stats_mod.DataPlaneStats()
    for i in range(90):
        now[0] += 0.001 * (i % 7)
        rec.instant(mod.CATEGORIES[i % len(mod.CATEGORIES)], f"e{i}", i % 5, f"x{i % 3}", k=i)
        if i % 4 == 0:
            rec.span(mod.CAT_STREAM, "copy-leg", i % 3, now[0], 0.002 * i, f"x{i % 3}", bytes=i)
    sc = mod.StageClock(stats, rec, node=2, object_id="x1")
    for st in mod.STAGES:
        now[0] += 0.25
        sc.switch(st)
    now[0] += 0.5
    sc.close()
    path = tmp_path / f"{tag}.json"
    n = rec.dump_chrome_trace(str(path))
    evs = [(e[0], e[1]) + tuple(e[3:]) for e in rec.events()]  # e[2]: the thread's ring
    return (evs, rec.count(), rec.count(mod.CAT_STREAM), n, json.loads(path.read_text()),
            mod.critical_path(rec.events()), mod.critical_path(rec.events(), "x1"), stats.stage_seconds)


def test_flight_recorder_and_chrome_export_match_jax(tmp_path):
    got = _recorded(TT, TST, tmp_path, "port")
    want = _recorded(JT, JST, tmp_path, "jax")
    assert got == want


@pytest.mark.parametrize("exact_limit", [50, 4096])
def test_latency_histogram_matches_jax(exact_limit):
    rng = np.random.RandomState(exact_limit)
    samples = np.exp(rng.normal(-6.0, 1.0, size=3000))
    t, j = TT.LatencyHistogram(exact_limit=exact_limit), JT.LatencyHistogram(exact_limit=exact_limit)
    for v in samples:
        t.record(float(v))
        j.record(float(v))
    assert t.summary() == j.summary()
    assert [t.percentile(p) for p in (1, 10, 50, 75, 99, 99.9, 100)] == [
        j.percentile(p) for p in (1, 10, 50, 75, 99, 99.9, 100)]
    assert (t.count, t.mean()) == (j.count, j.mean())


def test_dataplane_stats_match_jax_with_the_fold_count_beside():
    """The port's counters are the reference's, key by key, but for these:
    it leaves out ``notified_waiters`` and ``dir_wakeups`` (read by nothing
    in the port), and adds ``fold_ops``, the hand-off timers and
    ``task_seconds``."""
    t, j = TST.DataPlaneStats(), JST.DataPlaneStats()
    for s in (t, j):
        s.wakeups += 3
        s.note_bytes_served(1, 10)
        s.note_outbound(2, 4)
        s.note_bytes_reduced(0, 7)
        s.note_reduce_hop(0)
        s.note_stage("streaming", 0.5)
    snap = t.snapshot()
    assert snap.pop("fold_ops") == 0
    assert snap.pop("woken") == 0
    assert snap.pop("wake_lag_seconds") == 0.0
    assert snap.pop("window_issue_seconds") == 0.0
    assert snap.pop("dir_lock_wait_seconds") == 0.0
    assert snap.pop("task_seconds") == {}
    want = j.snapshot()
    assert want.pop("notified_waiters") == 0
    assert want.pop("dir_wakeups") == 0
    assert snap == want
    t.fold_ops = 5
    t.note_wake(0.25)
    t.note_window(0.5)
    t.note_seconds("task_seconds", "task-run", 1.0)
    assert (t.woken, t.wake_lag_seconds, t.windows, t.window_issue_seconds) == (1, 0.25, 1, 0.5)
    t.reset()
    assert t.fold_ops == 0 and t.snapshot()["bytes_served"] == {}
    assert (t.woken, t.wake_lag_seconds, t.window_issue_seconds, t.task_seconds) == (0, 0.0, 0.0, {})


# ---------------------------------------------------------------------------
# directory: the same operations with the same seed select the same sources
# ---------------------------------------------------------------------------


def _drive_directory(dmod, seed, replicated):
    rng = random.Random(seed)
    d = dmod.ReplicatedDirectory(num_shards=4, num_replicas=1) if replicated else dmod.ObjectDirectory(num_shards=4)
    fired = []
    oids = [f"x{i}" for i in range(5)]
    for o in oids[:3]:
        d.subscribe(o, fired.append)
    out = []
    epochs = {}
    for step in range(300):
        o, n = rng.choice(oids), rng.randrange(6)
        op = rng.randrange(16)
        if op == 0:
            r = d.publish_partial(o, n, 1000, producing=rng.random() < 0.3)
        elif op == 1:
            r = d.publish_complete(o, n, 1000)
        elif op == 2:
            r = d.update_progress(o, n, rng.randrange(1000))
        elif op in (3, 4, 5):
            loc = d.select_source(o, exclude=rng.choice([None, n]), min_lead=rng.randrange(-1, 500),
                                  max_out_degree=rng.choice([None, 1, 2]),
                                  avoid=frozenset(rng.sample(range(6), rng.randrange(2))))
            if loc is not None:
                epochs[(o, loc.node)] = d.charge_epoch(loc.node)
            r = _plain(loc)
        elif op == 6 and epochs:
            (ro, rn), ep = rng.choice(sorted(epochs.items()))
            r = d.release_source(ro, rn, ep if rng.random() < 0.7 else None)
        elif op == 7:
            r = _plain(d.checkout_location(o, remove=rng.random() < 0.5, exclude=rng.choice([None, n])))
        elif op == 8:
            r = d.return_location(o, n)
        elif op == 9 and rng.random() < 0.3:
            r = d.delete(o)
        elif op == 10:
            r = d.revive(o)
        elif op == 11 and rng.random() < 0.3:
            r = d.fail_node(n)
        elif op == 12:
            r = d.set_draining(n, rng.random() < 0.5)
        elif op == 13:
            r = (d.reset_outbound(n), d.outbound_load(n), d.charge_epoch(n))
        elif op == 14:
            r = (d.is_available(o), d.available_elsewhere(o, n), d.sole_holder(o, n), d.producing_at(o, n),
                 d.is_deleted(o), d.size_of(o), sorted(d.objects_at(n)))
        else:
            r = d.drop_location(o, n)
        if replicated and step == 150:
            d = d.fail_primary() or d
        out.append((step, op, r, [_plain(l) for l in d.locations(o)]))
    out.append(sorted(fired))
    return out


@pytest.mark.parametrize("seed", range(8))
@pytest.mark.parametrize("replicated", [False, True])
def test_directory_operation_sequences_match_jax(seed, replicated):
    assert _drive_directory(TD, seed, replicated) == _drive_directory(JD, seed, replicated)


def test_directory_inline_values_and_shards_match_jax():
    t, j = TD.ObjectDirectory(num_shards=8), JD.ObjectDirectory(num_shards=8)
    ids = ["x", "obj-0", "grad:layer3:step12", "", "ünicøde-id", "a" * 300]
    assert [t.shard_index(i) for i in ids] == [j.shard_index(i) for i in ids]
    t.publish_inline("s", torch.arange(4), 32)
    j.publish_inline("s", np.arange(4), 32)
    assert torch.equal(t.get_inline("s"), torch.arange(4)) and t.size_of("s") == j.size_of("s") == 32
    assert t.is_available("s") == j.is_available("s")
