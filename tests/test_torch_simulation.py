"""The port's discrete-event simulator against the JAX package's.

``repro_torch.core.simulation`` is a copy of ``repro.core.simulation`` that
runs the port's control plane (directory, chain state, planner, fault
injector, flight recorder).  Each simulator scenario of the JAX tests
(``test_core_hoplite.py``, ``test_elastic_reduce.py``,
``test_properties.py``, ``test_trace.py``, ``test_serve_ensemble.py``) runs
through both simulators from the same arguments, and the two runs must be
EQUAL: every completion time, ``bytes_on_wire``, every buffer's watermark and
contributor set, every node's resource occupancy, the directory's locations,
the splice counters, each ``FlightRecorder`` event list and
``ensemble_serving``'s whole returned dict.  The JAX tests' own assertions
run on the port's copy too.  A ``ClusterSpec`` whose ``dir_latency`` differs
by 1 us on one side must fail the comparison.
"""

import dataclasses
import json
from types import SimpleNamespace

import pytest
from hypothesis import given, settings, strategies as st

from repro.core import faults as JF
from repro.core import simulation as JS
from repro_torch.core import faults as TF
from repro_torch.core import simulation as TS

MB = 1 << 20
JAX = SimpleNamespace(name="jax", sim=JS, faults=JF)
TORCH = SimpleNamespace(name="torch", sim=TS, faults=TF)


def _plain_location(loc):
    d = dataclasses.asdict(loc)
    d["progress"] = loc.progress.name
    return d


def state(c, h=None, **extra):
    """Everything a simulated run leaves behind, as plain values."""
    buffers = sorted(
        (n, oid, b.size, b.bytes_present, tuple(sorted(map(str, b.content))))
        for n, node in c.nodes.items() for oid, b in node.buffers.items())
    oids = sorted({oid for _, oid, *_ in buffers})
    out = {
        "now": c.sim.now,
        "bytes_on_wire": c.bytes_on_wire,
        "membership_epoch": c.membership_epoch,
        "buffers": buffers,
        "busy": [(n, node.failed, node.egress.busy_time, node.ingress.busy_time, node.mem.busy_time)
                 for n, node in sorted(c.nodes.items())],
        "locations": {oid: [_plain_location(l) for l in c.directory.locations(oid)] for oid in oids},
        "trace": c.trace.events(),
    }
    if h is not None and hasattr(h, "splices_join"):
        out["splices"] = (h.splices_join, h.splices_drain)
    out.update(extra)
    return out


def assert_same(j: dict, t: dict) -> None:
    assert j.keys() == t.keys()
    for key in j:
        assert j[key] == t[key], f"{key}: the JAX simulator gives {j[key]!r:.300}, the port {t[key]!r:.300}"


def both(scenario, *args, spec_torch=None, **kw):
    """Run ``scenario`` through each simulator; the port's run with
    ``spec_torch`` (ClusterSpec fields) changed when given.  Returns both
    records, held equal."""
    j = scenario(JAX, *args, **kw)
    t = scenario(TORCH, *args, spec=spec_torch or {}, **kw)
    assert_same(j, t)
    return j, t


def spec_of(P, spec=None, **fields):
    return P.sim.ClusterSpec(**{**fields, **(spec or {})})


# ---------------------------------------------------------------------------
# tests/test_core_hoplite.py:113-174
# ---------------------------------------------------------------------------


def sim_broadcast_content_and_relay(P, spec=None):
    c = P.sim.SimCluster(spec_of(P, spec, num_nodes=8), trace=True)
    h = P.sim.Hoplite(c)
    h.put(0, "obj-b", 64 << 20)
    c.sim.run()
    t_put = c.sim.now
    for i in range(1, 8):
        h.get(i, "obj-b", to_executor=False)
    c.sim.run()
    for i in range(1, 8):
        buf = c.nodes[i].buffers["obj-b"]
        assert buf.complete and buf.content == frozenset(["obj-b"])
    mpi = P.sim.MPIStyle(P.sim.SimCluster()).bcast_time(8, 64 << 20)
    assert c.sim.now < mpi
    return state(c, h, t_put=t_put, mpi_bcast_time=mpi)


def sim_reduce_all_contributions_any_order(P, spec=None):
    c = P.sim.SimCluster(spec_of(P, spec, num_nodes=16), trace=True)
    h = P.sim.Hoplite(c)
    oids = {}
    for i in range(16):
        oid = f"obj-{i}"
        c.sim.schedule((15 - i) * 0.01, lambda i=i, oid=oid: h.put(i, oid, 1 << 20))
        oids[oid] = i
    done = h.reduce(0, "target", oids, 1 << 20)
    c.sim.run()
    buf = c.nodes[0].buffers["target"]
    assert done.done and buf.complete and buf.content == frozenset(oids)
    return state(c, h)


def sim_hoplite_beats_ray_broadcast_16n(P, spec=None):
    def bcast(api_cls):
        c = P.sim.SimCluster(spec_of(P, spec), trace=True)
        api = api_cls(c)
        api.put(0, "obj-256m", 256 << 20)
        c.sim.run()
        t0 = c.sim.now
        for i in range(1, 16):
            api.get(i, "obj-256m", to_executor=False)
        c.sim.run()
        return c.sim.now - t0, state(c, api)

    th, hoplite = bcast(P.sim.Hoplite)
    tr, ray = bcast(P.sim.RayStyle)
    assert th * 3 < tr
    return {"hoplite": hoplite, "ray": ray, "times": (th, tr)}


def sim_asynchrony_tracks_last_arrival(P, spec=None):
    c = P.sim.SimCluster(spec_of(P, spec), trace=True)
    h = P.sim.Hoplite(c)
    h.put(0, "obj-1g", 1 << 30)
    c.sim.run()
    interval = 0.5
    for i in range(1, 16):
        c.sim.schedule(i * interval, lambda i=i: h.get(i, "obj-1g", to_executor=False))
    c.sim.run()
    assert c.sim.now < 15 * interval + 1.5 * (1 << 30) / c.spec.link.bandwidth
    return state(c, h)


CORE_SCENARIOS = [sim_broadcast_content_and_relay, sim_reduce_all_contributions_any_order,
                  sim_hoplite_beats_ray_broadcast_16n, sim_asynchrony_tracks_last_arrival]


@pytest.mark.parametrize("scenario", CORE_SCENARIOS, ids=lambda f: f.__name__)
def test_core_scenarios_give_the_jax_simulators_events(scenario):
    j, t = both(scenario)
    assert t == j


# ---------------------------------------------------------------------------
# tests/test_elastic_reduce.py: the simulator halves of :74, :360 and :388
# ---------------------------------------------------------------------------


def sim_membership_epoch_tracks_member_deltas(P, spec=None):
    s = P.sim.SimCluster(spec_of(P, spec, num_nodes=3), trace=True)
    epochs = [s.membership_epoch]
    j = s.add_node()
    epochs.append(s.membership_epoch)
    assert epochs[-1] > epochs[-2]
    orphaned = s.drain_node(j)
    epochs.append(s.membership_epoch)
    assert epochs[-1] > epochs[-2]
    return state(s, epochs=epochs, joined=j, orphaned=orphaned)


def sim_join_tail_splice(P, spec=None):
    c = P.sim.SimCluster(spec_of(P, spec, num_nodes=4), trace=True)
    h = P.sim.Hoplite(c)
    size = 1 * MB
    for i in range(3):
        h.put(i, f"g{i}", size)
    h.reduce(3, "sum", {f"g{i}": i for i in range(3)}, size)
    admitted = {}

    def churn():
        n = c.add_node()
        h.put(n, "g-new", size)
        admitted["ok"] = h.splice_contribution("sum", "g-new", n)

    c.sim.schedule(0.0005, churn)
    c.sim.run()
    assert admitted["ok"] is True
    assert c.nodes[3].buffers["sum"].content == frozenset(["g0", "g1", "g2", "g-new"])
    instants = [e for e in c.trace.events() if e[4] == "splice-join"]
    assert h.splices_join == len(instants) == 1
    late = h.splice_contribution("sum", "g-too-late", 0)
    assert late is False
    return state(c, h, admitted=admitted, late=late)


def sim_baseline_noise(P, spec=None):
    size, n = 1 * MB, 4
    plan = P.faults.FaultPlan(seed=7, link_faults=[P.faults.LinkFault(jitter_s=0.002)])

    def arm(plane, noisy):
        c = P.sim.SimCluster(spec_of(P, spec, num_nodes=n), trace=True,
                             faults=P.faults.FaultInjector(plan) if noisy else None)
        api = P.sim.Hoplite(c) if plane == "hoplite" else P.sim.RayStyle(c)
        for i in range(n):
            api.put(i, f"g{i}", size)
        c.sim.run()
        t0 = c.sim.now
        oids = {f"g{i}": i for i in range(n)}
        if plane == "hoplite":
            api.allreduce(list(range(n)), oids, "sum", size)
        else:
            red = api.reduce(0, "sum", oids, size)
            red.add_waiter(lambda _e: [api.get(m, "sum", to_executor=False) for m in range(1, n)])
        c.sim.run()
        return c.sim.now - t0, state(c, api)

    out = {}
    for plane in ("hoplite", "ray"):
        (clean, s_clean), (noisy, s_noisy) = arm(plane, False), arm(plane, True)
        assert noisy > clean, (plane, clean, noisy)
        out[plane] = {"clean": s_clean, "noisy": s_noisy, "times": (clean, noisy)}
    return out


def sim_kill_armed_from_a_fault_plan(P, spec=None):
    """A kill and a join on the plan's timeline, armed through
    ``apply_to_sim``, land mid-broadcast at the same simulated times in both
    simulators, under the plan's link jitter and a straggler."""
    F = P.faults
    plan = F.FaultPlan(seed=3, kills=[F.KillSpec(node=2, at=0.02)], joins=[F.JoinSpec(node=6, at=0.01)],
                       link_faults=[F.LinkFault(jitter_s=0.0005)],
                       stragglers=[F.StragglerSpec(node=3, factor=4.0, start=0.0, end=0.05)])
    c = P.sim.SimCluster(spec_of(P, spec, num_nodes=6), trace=True, faults=plan)
    h = P.sim.Hoplite(c)
    c.faults.apply_to_sim(c)
    h.put(0, "obj-k", 16 * MB)
    for i in range(1, 6):
        h.get(i, "obj-k", to_executor=False)
    c.sim.run()
    assert c.nodes[2].failed and 6 in c.nodes
    return state(c, h, log=c.faults.log)


ELASTIC_SCENARIOS = [sim_membership_epoch_tracks_member_deltas, sim_join_tail_splice, sim_baseline_noise,
                     sim_kill_armed_from_a_fault_plan]


@pytest.mark.parametrize("scenario", ELASTIC_SCENARIOS, ids=lambda f: f.__name__)
def test_elastic_scenarios_give_the_jax_simulators_events(scenario):
    j, t = both(scenario)
    assert t == j


# ---------------------------------------------------------------------------
# tests/test_properties.py:35 under hypothesis
# ---------------------------------------------------------------------------


def sim_reduce_any_arrival_order(P, n, delays, size, spec=None):
    c = P.sim.SimCluster(spec_of(P, spec, num_nodes=max(n, 4)), trace=True)
    h = P.sim.Hoplite(c)
    oids = {}
    for i in range(n):
        oid = f"obj-{i}"
        c.sim.schedule(delays[i] * 0.003, lambda i=i, oid=oid: h.put(i, oid, size))
        oids[oid] = i
    h.reduce(0, "t", oids, size)
    c.sim.run()
    buf = c.nodes[0].buffers["t"]
    assert buf.complete
    assert buf.content == frozenset(oids), "a contribution was lost or duplicated"
    return state(c, h)


@settings(max_examples=20, deadline=None)
@given(n=st.integers(2, 12), order=st.randoms(use_true_random=False),
       size=st.sampled_from([1 << 12, 1 << 20]))
def test_reduce_in_any_arrival_order_gives_the_jax_simulators_events(n, order, size):
    delays = list(range(n))
    order.shuffle(delays)
    both(sim_reduce_any_arrival_order, n, delays, size)


# ---------------------------------------------------------------------------
# tests/test_trace.py:252
# ---------------------------------------------------------------------------


def sim_trace_uses_simulated_time(P, path, spec=None):
    c = P.sim.SimCluster(spec_of(P, spec, num_nodes=4), trace=True)
    h = P.sim.Hoplite(c)
    oids = {}
    for i in range(4):
        oid = f"g{i}"
        h.put(i, oid, 1 << 20)
        oids[oid] = i
    c.sim.run()
    h.reduce(0, "sum", oids, 1 << 20)
    c.sim.run()
    evs = c.trace.events()
    assert evs, "simulator recorded nothing"
    assert {e[3] for e in evs} >= {"stream", "chain"}
    assert max(e[0] for e in evs) < 60.0
    out = path / f"{P.name}.json"
    assert c.dump_trace(str(out)) == len(evs)
    with open(out) as f:
        dumped = json.load(f)
    return state(c, h, dumped=dumped)


def test_trace_on_simulated_time_gives_the_jax_simulators_events(tmp_path):
    j, t = both(sim_trace_uses_simulated_time, tmp_path)
    assert t["dumped"] == j["dumped"] and t["trace"]


# ---------------------------------------------------------------------------
# tests/test_serve_ensemble.py:119, at n = 4, 8 and 16
# ---------------------------------------------------------------------------


def ensemble(P, n, spec=None):
    out = {}
    for plane in ("hoplite", "ray"):
        kw = {"spec": spec_of(P, spec, num_nodes=n + 1)} if spec else {}
        out[plane] = P.sim.ensemble_serving(data_plane=plane, num_replicas=n, num_requests=10, **kw)
    return out


@pytest.mark.parametrize("n", [4, 8, 16])
def test_ensemble_serving_returns_the_jax_simulators_dict(n):
    j, t = both(ensemble, n)
    h, r = t["hoplite"], t["ray"]
    assert h["completed"] == r["completed"] == 10
    assert h["deploy_time"] < r["deploy_time"]
    if n >= 8:  # the JAX test's own bounds, at its n
        assert r["deploy_time"] / h["deploy_time"] > 2.0
        assert h["latency"]["p99"] <= r["latency"]["p99"] * 1.05


# ---------------------------------------------------------------------------
# the planted fault: the comparison must see 1 us of directory latency
# ---------------------------------------------------------------------------


PLANTED = [(sim_reduce_all_contributions_any_order, ()), (sim_join_tail_splice, ()), (ensemble, (8,))]


@pytest.mark.parametrize("scenario, args", PLANTED, ids=lambda x: getattr(x, "__name__", ""))
def test_the_comparison_fails_a_dir_latency_off_by_one_microsecond(scenario, args):
    j, t = both(scenario, *args, spec_torch={"dir_latency": JS.ClusterSpec().dir_latency})
    assert t == j  # the same spec, written out: still equal
    with pytest.raises(AssertionError):
        both(scenario, *args, spec_torch={"dir_latency": JS.ClusterSpec().dir_latency + 1e-6})

