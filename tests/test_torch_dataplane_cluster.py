"""The port's threaded cluster against the JAX package's ``LocalCluster``.

Each scenario runs on ``repro.core.local.LocalCluster`` and on
``repro_torch.core.local.LocalCluster(..., device="cpu")`` with the same
numpy-seeded inputs: put/get, broadcast relays, reduce, allreduce (full and
bounded), small inline objects, a node failure with refetch, a re-splice
after a kill mid-chain, drain and join, eviction, and the socket backend.
Integer-valued data are held bit for bit (any arrival order sums them
exactly); random f32 at the reference's 2e-5 and random f64 at its 1e-12;
f16, bf16, f64 and int32 each get a case.  Scenarios that depend on timing
(kills mid-stream) are held to the run without the fault and to the exact
sum; nothing here asserts a wall-clock time.
"""

import threading
import time
from concurrent.futures import Future

import ml_dtypes
import numpy as np
import pytest
import torch
from hypothesis import given, settings, strategies as st

from repro.core import api as JA
from repro.core import local as JL
from repro.core.faults import FaultToleranceConfig as JFT
from repro_torch.core import api as TA
from repro_torch.core import local as TL
from repro_torch.core.faults import ConnFault, FaultPlan, FaultToleranceConfig
from repro_torch.core.scheduler import Hop

KB = 1 << 10


def t2n(t):
    t = t.detach().cpu()
    if t.dtype == torch.bfloat16:
        return t.view(torch.int16).numpy().view(ml_dtypes.bfloat16)
    return t.numpy()


class Side:
    """One package's cluster, ops and value conversion."""

    def __init__(self, name):
        self.name = name
        self.api = TA if name == "torch" else JA
        self.local = TL if name == "torch" else JL
        self.ft = FaultToleranceConfig if name == "torch" else JFT

    def cluster(self, n, **kw):
        if self.name == "torch":
            kw.setdefault("device", "cpu")
        return self.local.LocalCluster(n, **kw)

    def np(self, x):
        return t2n(x) if isinstance(x, torch.Tensor) else np.asarray(x)

    def get(self, c, node, oid, **kw):
        return self.np(c.get(node, oid, **kw))


JAX, TORCH = Side("jax"), Side("torch")


def both(fn, *args, **kw):
    return fn(JAX, *args, **kw), fn(TORCH, *args, **kw)


def same_bits(a, b):
    a, b = np.asarray(a), np.asarray(b)
    assert a.dtype == b.dtype and a.shape == b.shape, (a.dtype, b.dtype, a.shape, b.shape)
    assert a.tobytes() == b.tobytes()


# numpy-seeded data of each kind: integer-valued (exact under any order) or random
def data(kind, n, seed):
    rng = np.random.RandomState(seed)
    return {
        "f32_int": lambda: rng.randint(-1000, 1000, size=n).astype(np.float32),
        "f32": lambda: rng.rand(n).astype(np.float32),
        "f16_int": lambda: rng.randint(-64, 64, size=n).astype(np.float16),
        "bf16_int": lambda: rng.randint(-16, 16, size=n).astype(ml_dtypes.bfloat16),
        "f64": lambda: rng.rand(n),
        "i32": lambda: rng.randint(-(1 << 20), 1 << 20, size=n).astype(np.int32),
        "i64": lambda: rng.randint(-(1 << 40), 1 << 40, size=n).astype(np.int64),
        "u8": lambda: rng.randint(0, 256, size=n).astype(np.uint8),
        "bool": lambda: rng.rand(n) < 0.5,
        "i8": lambda: rng.randint(-128, 128, size=n).astype(np.int8),
    }[kind]()


EXACT = ("f32_int", "f16_int", "bf16_int", "i32", "i64")


def hold(kind, got, want):
    if kind in EXACT:
        same_bits(got, want)
    elif kind == "f32":
        np.testing.assert_allclose(got, want, rtol=2e-5, atol=2e-5)
    else:
        np.testing.assert_allclose(got, want, rtol=1e-12)


# ---------------------------------------------------------------------------
# put / get
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("kind", ["f32", "f16_int", "bf16_int", "f64", "i32", "i64", "u8", "bool", "i8"])
@pytest.mark.parametrize("elems", [1000, 70_000])
def test_put_get_matches_jax(kind, elems):
    x = data(kind, elems, seed=1).reshape(10, -1)

    def run(side):
        c = side.cluster(3)
        c.put(0, "x", x)
        inline = c.directory.get_inline("x") is not None
        out = [side.get(c, n, "x", timeout=30.0) for n in (0, 1, 2)]
        return inline, out, c.meta["x"][1]

    (ji, jo, js), (ti, to, ts) = both(run)
    assert ji == ti == (x.nbytes < JA.SMALL_OBJECT_THRESHOLD)
    assert tuple(js) == tuple(ts) == x.shape
    for a, b in zip(jo, to):
        same_bits(a, x)
        same_bits(b, x)


def test_get_returns_a_copy_the_caller_may_update_in_place():
    """``get`` copies, as the JAX package's does (``local.py:521-542``):
    ``w -= ...`` on a result leaves the object as it was, inline or not."""
    c = TORCH.cluster(2)
    for oid, n in (("small", 100), ("big", 50_000)):
        x = np.arange(n, dtype=np.float32)
        c.put(0, oid, x)
        for node in (0, 1):
            w = c.get(node, oid, timeout=30.0)
            w -= 1000.0
            same_bits(TORCH.get(c, node, oid), x)


def test_broadcast_relays_deliver_identical_bytes():
    x = np.random.RandomState(0).rand(300_000).astype(np.float32)

    def run(side):
        c = side.cluster(8, chunk_size=8192, pace=0.0002)
        c.put(0, "x", x)
        futs = [c.get_async(i, "x") for i in range(1, 8)]
        got = [side.np(f.result(timeout=60)) for f in futs]
        return got, max(c.bytes_sent_per_node), {oid for _s, _d, oid in c.transfers}

    for got, sent, oids in both(run):
        for g in got:
            same_bits(g, x)
        assert sent <= 2 * x.nbytes  # one-outbound cap: no node sends more than ~2 copies
        assert oids == {"x"}


def test_origin_serves_out_degree_not_n():
    n_recv = 12
    x = np.random.RandomState(0).rand(100_000).astype(np.float32)
    c = TORCH.cluster(n_recv + 1, chunk_size=64 * KB, pace=0.0005)
    c.put(0, "x", x)
    futs = [c.get_async(i, "x", timeout=60.0) for i in range(1, n_recv + 1)]
    for f in futs:
        same_bits(t2n(f.result(timeout=60.0)), x)
    cap = c.broadcast_out_degree(x.nbytes)
    assert cap == JL.LocalCluster(n_recv + 1, chunk_size=64 * KB).broadcast_out_degree(x.nbytes)
    assert c.stats["bytes_served"].get(0, 0) <= cap * x.nbytes
    assert max(c.stats["peak_outbound"].values()) <= cap


# ---------------------------------------------------------------------------
# reduce and allreduce, by dtype
# ---------------------------------------------------------------------------

REDUCE_KINDS = ["f32_int", "f32", "f16_int", "bf16_int", "f64", "i32"]


@pytest.mark.parametrize("kind", REDUCE_KINDS)
@pytest.mark.parametrize("n,elems", [(2, 100_000), (4, 100_000), (8, 30_000), (9, 12_500)])
def test_reduce_matches_jax(kind, n, elems):
    vals = [data(kind, elems, seed=10 + i) for i in range(n)]

    def run(side):
        c = side.cluster(n + 1)
        for i, v in enumerate(vals):
            c.put(i + 1, f"g{i}", v)
        c.reduce(0, "sum", [f"g{i}" for i in range(n)], timeout=60.0)
        return side.get(c, 0, "sum"), side.get(c, n, "sum", timeout=30.0)

    (j0, j1), (t0, t1) = both(run)
    same_bits(t0, t1)
    hold(kind, t0, j0)
    want = vals[0]
    for v in vals[1:]:
        want = want + v
    hold(kind, t0, want.astype(vals[0].dtype))


@pytest.mark.parametrize("kind", REDUCE_KINDS)
def test_allreduce_matches_jax(kind):
    vals = [data(kind, 30_000, seed=20 + i) for i in range(8)]

    def run(side):
        c = side.cluster(8)
        for i, v in enumerate(vals):
            c.put(i, f"g{i}", v)
        res = c.allreduce(list(range(8)), "ar", [f"g{i}" for i in range(8)], timeout=60.0)
        assert res == "ar" and res.dropped == () and res.mask == (True,) * 8
        return [side.get(c, i, "ar", timeout=30.0) for i in range(8)]

    jo, to = both(run)
    for t in to:
        same_bits(t, to[0])
    hold(kind, to[0], jo[0])


@pytest.mark.parametrize("op", ["MIN", "MAX"])
def test_min_max_reduce_matches_jax(op):
    vals = [data("f32", 50_000, seed=30 + i) for i in range(5)]

    def run(side):
        c = side.cluster(5)
        for i, v in enumerate(vals):
            c.put(i, f"g{i}", v)
        c.reduce(0, "m", [f"g{i}" for i in range(5)], getattr(side.api, op), timeout=60.0)
        return side.get(c, 0, "m")

    j, t = both(run)
    same_bits(t, j)  # min and max are exact under any order


def test_sum_folds_are_counted_and_go_through_chunk_reduce():
    """Every window of a SUM fold over f32 is one ``chunk_reduce`` call:
    the cluster's ``fold_ops`` and SUM's kernel route count the same."""
    TA.SUM.reset_counts()
    c = TORCH.cluster(5)
    vals = [data("f32_int", 200_003, seed=40 + i) for i in range(4)]
    for i, v in enumerate(vals):
        c.put(i + 1, f"g{i}", v)
    c.reduce(0, "sum", [f"g{i}" for i in range(4)], timeout=60.0)
    same_bits(TORCH.get(c, 0, "sum"), sum(vals[1:], vals[0]))
    folds = c.stats["fold_ops"]
    window = max(c.chunk_size_for(vals[0].nbytes), -(-vals[0].nbytes // TL.PIPELINE_MIN_WINDOWS))
    assert folds >= 3 * -(-vals[0].nbytes // (window + (-window) % 64))  # 3 folds a window at least
    assert TA.SUM.counts == {"chunk_reduce": folds}
    c2 = TORCH.cluster(3)
    ints = [data("i32", 50_000, seed=i) for i in range(3)]
    for i, v in enumerate(ints):
        c2.put(i, f"g{i}", v)
    c2.reduce(0, "s", ["g0", "g1", "g2"], timeout=60.0)
    assert TA.SUM.counts["add"] == c2.stats["fold_ops"] > 0


def test_bounded_allreduce_cuts_a_straggler_like_jax():
    vals = [data("f64", 40_000, seed=100 + i) for i in range(4)]

    def run(side):
        c = side.cluster(4, trace=True)
        for i in range(3):
            c.put(i, f"g{i}", vals[i])
        t = threading.Timer(3.0, lambda: c.put(3, "g3", vals[3]))
        t.daemon = True
        t.start()
        res = c.allreduce([0, 1, 2, 3], "sum", [f"g{i}" for i in range(4)], deadline=0.3, min_participants=3)
        t.cancel()
        return (res.cut, res.mask, res.dropped, res.participants, c.stats["straggler_cuts"],
                [side.get(c, n, "sum") for n in range(3)])

    (jc, jm, jd, jp, js, jo), (tc, tm, td, tp, ts, to) = both(run)
    assert (tc, tm, td, tp, ts) == (jc, jm, jd, jp, js) == (True, (True, True, True, False), ("g3",),
                                                           ("g0", "g1", "g2"), 1)
    for a, b in zip(jo, to):
        np.testing.assert_allclose(b, a, rtol=1e-12)
        np.testing.assert_allclose(b, vals[0] + vals[1] + vals[2], rtol=1e-10)


def test_bounded_allreduce_folds_at_quorum_and_raises_below_it():
    vals = [data("f64", 40_000, seed=110 + i) for i in range(3)]
    c = TORCH.cluster(3)
    c.put(0, "g0", vals[0])
    c.put(1, "g1", vals[1])
    res = c.allreduce([0, 1, 2], "sum", ["g0", "g1", "g2"], min_participants=2, timeout=10.0)
    assert res.cut and res.dropped == ("g2",)
    np.testing.assert_allclose(TORCH.get(c, 0, "sum"), vals[0] + vals[1], rtol=1e-10)
    c2 = TORCH.cluster(3)
    for i in range(3):
        c2.put(i, f"g{i}", vals[i])
    c2.fail_node(1)
    with pytest.raises(TA.ObjectLost):
        c2.allreduce([0, 2], "sum", ["g0", "g1", "g2"], deadline=0.2, min_participants=3, timeout=2.0)


# ---------------------------------------------------------------------------
# small objects, failures, re-splice
# ---------------------------------------------------------------------------


def test_reduce_of_inline_only_sources_after_node_loss_matches_jax():
    small = [np.full(128, float(i)) for i in range(5)]  # 1 KB each -> 2-D chain

    def run(side):
        c = side.cluster(8)
        for i, v in enumerate(small):
            c.put(i + 1, f"s{i}", v)
        for i in range(5):
            c.fail_node(i + 1)  # locations drop; inline entries survive
        c.reduce(0, "tot", [f"s{i}" for i in range(5)], timeout=10.0)
        return side.get(c, 0, "tot")

    j, t = both(run)
    same_bits(t, j)
    same_bits(t, sum(small))


def test_failure_refetch_and_orphan_like_jax():
    x = np.random.RandomState(1).rand(100_000).astype(np.float32)

    def run(side):
        c = side.cluster(4, pace=0.0002)
        c.put(0, "x", x)
        c.get(1, "x")
        orphaned0 = c.fail_node(0)  # copy survives at node 1
        got = side.get(c, 2, "x", timeout=30)
        c.fail_node(1)
        orphaned2 = c.fail_node(2)
        with pytest.raises((side.api.ObjectLost, TimeoutError)):
            c.get(3, "x", timeout=0.5)
        return orphaned0, orphaned2, got

    (jo0, jo2, jg), (to0, to2, tg) = both(run)
    assert (to0, to2) == (jo0, jo2) == ([], ["x"])
    same_bits(tg, x)


def _chain_cluster(side, num_nodes, vals, victim_src, dup_node):
    """tests/test_pipelined_reduce.py's chain: sources at nodes 1..k, a
    second copy of the victim's source at ``dup_node``."""
    c = side.cluster(num_nodes, chunk_size=32 * KB, pace=0.002)
    for i, v in enumerate(vals):
        c.put(i + 1, f"g{i}", v)
    c.put(dup_node, f"g{victim_src}", vals[victim_src])
    return c


def _reduce_in_thread(c, srcs):
    fut: Future = Future()

    def run():
        try:
            c.reduce(0, "sum", srcs, timeout=60.0)
            fut.set_result(c.get(0, "sum", timeout=30.0))
        except BaseException as e:  # noqa: BLE001
            fut.set_exception(e)

    threading.Thread(target=run, daemon=True).start()
    return fut


def _kill_when(c, pred, node, what):
    deadline = time.time() + 20.0
    while time.time() < deadline:
        if pred():
            c.fail_node(node)
            return
        time.sleep(0.0005)
    raise AssertionError(f"never caught {what}")


@pytest.mark.parametrize("kind", ["f32_int", "f16_int", "f64"])
def test_mid_chain_kill_resplices_byte_equal(kind):
    """Kill node 2 (g1 and the hop folding g0+g1) while node 3's hop
    streams its output: the chain re-splices from the predecessor's
    watermark, element-aligned, and the bytes equal the run without the
    kill and the JAX package's."""
    elems = 800 * KB // {"f32_int": 4, "f16_int": 2, "f64": 8}[kind]  # 1-D: n*B*L < S
    vals = [data(kind, elems, seed=100 + i) for i in range(4)]
    srcs = [f"g{i}" for i in range(4)]

    def ref(side):
        c = _chain_cluster(side, 6, vals, 1, 5)
        c.reduce(0, "sum", srcs, timeout=60.0)
        return side.get(c, 0, "sum")

    jref, tref = both(ref)
    c = _chain_cluster(TORCH, 6, vals, 1, 5)
    fut = _reduce_in_thread(c, srcs)
    _kill_when(c, lambda: any("-hop" in o and 0 < b.bytes_present < b.size
                              for o, b in list(c.stores[3].objects.items())), 2, "the hop mid-stream")
    got = t2n(fut.result(timeout=60.0))
    assert c.stats["resplices"] >= 1
    same_bits(got, tref)
    hold(kind, got, jref)


def test_tail_kill_resplices_final_fold():
    vals = [data("f32_int", 200 * KB, seed=200 + i) for i in range(4)]
    srcs = [f"g{i}" for i in range(4)]
    want = sum(vals[1:], vals[0])
    c = _chain_cluster(TORCH, 6, vals, 3, 5)
    fut = _reduce_in_thread(c, srcs)
    _kill_when(c, lambda: (b := c.stores[0].get("sum")) is not None and 0 < b.bytes_present < b.size,
               4, "the final fold mid-stream")
    same_bits(t2n(fut.result(timeout=60.0)), want)
    assert c.stats["resplices"] >= 1


def test_kill_without_surviving_copy_fails_with_object_lost():
    c = TORCH.cluster(5, chunk_size=32 * KB, pace=0.002)
    for i in range(4):
        c.put(i + 1, f"g{i}", data("f64", 100_000, seed=i))
    fut: Future = Future()

    def run():
        try:
            fut.set_result(c.reduce(0, "sum", [f"g{i}" for i in range(4)], timeout=30.0))
        except BaseException as e:  # noqa: BLE001
            fut.set_exception(e)

    threading.Thread(target=run, daemon=True).start()
    _kill_when(c, lambda: any("-hop" in o and b.bytes_present > 0 for s in c.stores
                              for o, b in list(s.objects.items())), 2, "a hop")
    with pytest.raises(Exception):
        fut.result(timeout=30.0)


def test_failed_reduce_reclaims_pinned_intermediates():
    c = TORCH.cluster(8, chunk_size=8192, pace=0.0005)
    for i in range(7):
        c.put(i + 1, f"fr{i}", data("f64", 50_000, seed=i))
    killer = threading.Timer(0.02, lambda: c.fail_node(3))
    killer.start()
    try:
        c.reduce(0, "frsum", [f"fr{i}" for i in range(7)], timeout=20.0)
    except Exception:  # noqa: BLE001 -- failure is an acceptable outcome; leaking is not
        pass
    killer.join()
    c.join(timeout=20.0)
    leaked = [o for s in c.stores for o in s.objects if "-hop" in o and o in s.pinned]
    assert not leaked


def test_hop_failure_before_output_creation_marks_it_lost():
    c = TORCH.cluster(3)
    c.put(1, "src", data("f64", 30_000, seed=0))
    hop = Hop(1, "src", 2, "missing-local", "t-hop1-missing-local")
    fut = c._exec_hop_async(hop, torch.float64, (30_000,), TA.SUM, deadline=time.time() + 30.0, lineage={})
    with pytest.raises(TA.ObjectLost):
        fut.result(timeout=10.0)
    with c.lock:
        assert c._object_lost(hop.out_object) or not c.directory.is_available(hop.out_object)


def test_re_reduce_into_an_existing_target_raises():
    a = [data("f64", 20_000, seed=i) for i in range(2)]
    b = [data("f64", 20_000, seed=10 + i) for i in range(2)]
    c = TORCH.cluster(4)
    for i in range(2):
        c.put(i, f"a{i}", a[i])
        c.put(i + 2, f"b{i}", b[i])
    c.reduce(0, "t", ["a0", "a1"], timeout=30.0)
    with pytest.raises(TA.ObjectAlreadyExists):
        c.reduce(0, "t", ["b0", "b1"], timeout=30.0)
    same_bits(TORCH.get(c, 0, "t"), a[0] + a[1])
    c.delete("t")
    c.reduce(0, "t", ["b0", "b1"], timeout=30.0)
    same_bits(TORCH.get(c, 0, "t"), b[0] + b[1])


def held_bytes_before_the_root_was_whole(c, oid, root, receivers):
    """The overlap claim, read from the stores' recorded window times: some
    receiver's first window of ``oid`` landed before the root's last one."""
    last = c.stores[root].get(oid).last_window_at
    return min(c.stores[i].get(oid).first_window_at for i in receivers) < last


def test_fused_allreduce_receivers_hold_bytes_while_the_reduce_produces():
    vals = [data("f64", 64_000, seed=i) for i in range(4)]
    c = TORCH.cluster(4, chunk_size=64 * KB, pace=0.003)
    for i, v in enumerate(vals):
        c.put(i, f"g{i}", v)
    c.allreduce(list(range(4)), "ar", [f"g{i}" for i in range(4)], timeout=60.0)
    assert held_bytes_before_the_root_was_whole(c, "ar", 0, range(1, 4))
    for i in range(4):
        np.testing.assert_allclose(TORCH.get(c, i, "ar"), sum(vals), rtol=1e-12)


def test_store_and_forward_allreduce_fails_the_overlap_check():
    """A planted allreduce that reduces into the root and only then fetches
    to the receivers: the check above must refuse it."""
    vals = [data("f64", 64_000, seed=i) for i in range(4)]
    c = TORCH.cluster(4, chunk_size=64 * KB, pace=0.003)
    for i, v in enumerate(vals):
        c.put(i, f"g{i}", v)
    c.reduce(0, "ar", [f"g{i}" for i in range(4)], timeout=60.0)
    for i in range(1, 4):
        c.get(i, "ar", timeout=60.0)
    assert not held_bytes_before_the_root_was_whole(c, "ar", 0, range(1, 4))
    for i in range(4):
        np.testing.assert_allclose(TORCH.get(c, i, "ar"), sum(vals), rtol=1e-12)


# ---------------------------------------------------------------------------
# delete, eviction, drain and join
# ---------------------------------------------------------------------------


def test_delete_mid_transfer_and_reput():
    c = TORCH.cluster(2, pace=0.002, chunk_size=4096)
    c.put(0, "w", np.arange(256 * KB // 8, dtype=np.float64))
    fut = c.get_async(1, "w", timeout=10.0)
    time.sleep(0.02)
    c.delete("w")
    with pytest.raises((TA.ObjectLost, TimeoutError)):
        fut.result(timeout=10.0)
    assert not c.stores[1].contains("w") and c.directory.locations("w") == []
    c.put(0, "v", np.ones(4))
    c.delete("v")
    c.put(0, "v", np.full(4, 2.0))
    same_bits(TORCH.get(c, 1, "v"), np.full(4, 2.0))


def test_stale_location_after_capacity_eviction_recovers_like_jax():
    size = 150_000
    a = np.arange(size // 8, dtype=np.float64)

    def run(side):
        c = side.cluster(3, store_capacity=220_000)
        c.put(0, "A", a)
        first = side.get(c, 1, "A")
        c.put(1, "B", np.zeros(size // 8))
        evicted = not c.stores[1].contains("A")
        again = side.get(c, 2, "A", timeout=5.0)
        c2 = side.cluster(3, store_capacity=220_000)
        c2.put(0, "A", a)
        c2.get(1, "A")
        c2.put(1, "B", np.zeros(size // 8))
        c2.fail_node(0)
        with pytest.raises((side.api.ObjectLost, TimeoutError)):
            c2.get(2, "A", timeout=1.0)
        return first, evicted, again, c.stores[0].used_bytes, c.stores[1].used_bytes

    (jf, je, ja, j0, j1), (tf, te, ta, t0, t1) = both(run)
    assert je and te and (j0, j1) == (t0, t1)
    for x in (jf, ja, tf, ta):
        same_bits(x, a)


def test_drain_evacuates_and_join_participates_like_jax():
    big = np.random.RandomState(1).rand(100_000)

    def run(side):
        c = side.cluster(4, chunk_size=32 * KB)
        c.put(2, "big", big)
        evacuated = c.drain_node(2, deadline=15.0)
        got = side.get(c, 0, "big", timeout=15.0)
        j = c.add_node()
        nodes = c.stores.ids()
        parts = {i: np.full(50_000, float(i + 1)) for i in nodes}
        for i, v in parts.items():
            c.put(i, f"part-{i}", v)
        c.allreduce(nodes, "ar-out", [f"part-{i}" for i in nodes], timeout=60.0)
        return (evacuated, c.num_nodes, j, nodes, got, [side.get(c, i, "ar-out", timeout=60.0) for i in nodes],
                c.stats["drains"], c.stats["evacuated_objects"], c.stats["joins"])

    (je, jn, jj, jnodes, jg, jar, *jst), (te, tn, tj, tnodes, tg, tar, *tst) = both(run)
    assert (te, tn, tj, tnodes, tst) == (je, jn, jj, jnodes, jst) == (["big"], 4, 4, [0, 1, 3, 4], [1, 1, 1])
    same_bits(tg, big)
    for a, b in zip(jar, tar):
        same_bits(b, a)
        same_bits(b, np.full(50_000, 1.0 + 2 + 4 + 5))


def test_mid_collective_join_and_drain_under_load_zero_loss():
    data_ = np.random.RandomState(7).rand(300_000)
    c = TORCH.cluster(4, chunk_size=64 * KB, pace=0.0003, trace=True)
    c.put(0, "w", data_)
    futs = [c.get_async(i, "w", timeout=60.0) for i in (1, 2, 3)]
    time.sleep(0.05)
    joiner = c.add_node()
    late = c.get_async(joiner, "w", timeout=60.0)
    for f in futs + [late]:
        same_bits(t2n(f.result(timeout=60.0)), data_)
    assert c.stats["joins"] == 1
    c2 = TORCH.cluster(4, chunk_size=32 * KB, pace=0.0005)
    payload = np.random.RandomState(2).rand(200_000)
    c2.put(1, "p", payload)
    futs = [c2.get_async(i, "p", timeout=30.0) for i in (0, 2, 3)]
    assert "p" in c2.drain_node(1, deadline=15.0)
    for f in futs:
        same_bits(t2n(f.result(timeout=30.0)), payload)


def test_join_tail_splice_mid_reduce():
    vals = [np.full(32_768, float(i + 1)) for i in range(4)]
    c = TORCH.cluster(3, chunk_size=4 * KB, pace=0.002, trace=True)
    c.put(0, "g0", vals[0])
    timers = [threading.Timer(0.25, lambda: c.put(1, "g1", vals[1])),
              threading.Timer(0.50, lambda: c.put(2, "g2", vals[2]))]
    for t in timers:
        t.start()
    fut = Future()
    threading.Thread(target=lambda: fut.set_result(c.reduce(0, "sum", ["g0", "g1", "g2"], TA.SUM,
                                                             timeout=30.0)), daemon=True).start()
    time.sleep(0.1)
    joiner = c.add_node()
    c.put(joiner, "g3", vals[3])
    assert c.splice_contribution("sum", "g3")
    fut.result(timeout=30.0)
    same_bits(TORCH.get(c, 0, "sum"), sum(vals))
    assert c.stats["splices_join"] == 1 and c.stats["resplices"] == 0


# ---------------------------------------------------------------------------
# the socket backend
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("backend", ["inproc", "socket"])
def test_collectives_byte_identical_across_backends_and_packages(backend):
    parts = [np.arange(20_000, dtype=np.float64) * (n + 1) for n in range(4)]

    def run(side):
        c = side.cluster(4, comm_backend=backend)
        try:
            for n in range(4):
                c.put(n, f"p{n}", parts[n])
            c.reduce(0, "sum", [f"p{n}" for n in range(4)])
            c.allreduce(list(range(4)), "ar", [f"p{n}" for n in range(4)])
            return c.comm_backend, side.get(c, 0, "sum", timeout=30.0), [
                side.get(c, n, "ar", timeout=30.0) for n in range(4)]
        finally:
            c.shutdown()

    (jb, js, ja), (tb, ts, ta) = both(run)
    assert jb == tb == backend
    same_bits(ts, js)
    same_bits(ts, sum(parts))
    for a, b in zip(ja, ta):
        same_bits(b, a)


@pytest.mark.parametrize("backend", ["inproc", "socket"])
def test_zero_byte_and_ragged_tail_objects(backend):
    c = TORCH.cluster(3, comm_backend=backend, chunk_size=4096)
    try:
        c.put(0, "z", np.empty(0, dtype=np.uint8))
        assert c.get(1, "z", timeout=30.0).numel() == 0
        x = np.random.RandomState(7).randint(0, 256, size=64 * KB + 4096 + 37).astype(np.uint8)
        c.put(0, "t", x)
        same_bits(TORCH.get(c, 1, "t", timeout=30.0), x)
        same_bits(TORCH.get(c, 2, "t", timeout=30.0), x)
    finally:
        c.shutdown()


@pytest.mark.parametrize("backend", ["inproc", "socket"])
def test_mid_stream_reset_resumes_from_watermark(backend):
    plan = FaultPlan(seed=5, conn_faults=[ConnFault(kind="reset", src=0, dst=1, reset_after=3)])
    c = TORCH.cluster(2, comm_backend=backend, chunk_size=4096, faults=plan, trace=True,
                      fault_tolerance=FaultToleranceConfig(connect_backoff_base_s=0.01,
                                                           connect_backoff_cap_s=0.05))
    try:
        x = np.random.RandomState(11).randint(0, 256, size=512 * KB).astype(np.uint8)
        c.put(0, "r", x)
        same_bits(TORCH.get(c, 1, "r", timeout=30.0), x)
        assert c.stats["comm_reconnects"] >= 1
        assert len([e for e in c.trace.events() if e[4] == "reconnect"]) == c.stats["comm_reconnects"]
    finally:
        c.shutdown()


def test_socket_reduce_of_f16_folds_through_relays():
    """On the socket backend each remote fold input is staged into a relay
    buffer fed from a socket; the fold reads the relays' watermarks."""
    vals = [data("f16_int", 100_003, seed=i) for i in range(4)]
    c = TORCH.cluster(4, comm_backend="socket")
    try:
        for i, v in enumerate(vals):
            c.put(i, f"h{i}", v)
        c.reduce(0, "hs", [f"h{i}" for i in range(4)], timeout=60.0)
        same_bits(TORCH.get(c, 0, "hs"), sum(vals[1:], vals[0]))
        assert c.stats["fold_ops"] > 0
    finally:
        c.shutdown()


def test_socket_heartbeat_detects_silent_death():
    ft = FaultToleranceConfig(heartbeat_interval_s=0.05, heartbeat_timeout=0.4)
    c = TORCH.cluster(3, comm_backend="socket", fault_tolerance=ft, trace=True)
    try:
        x = np.random.RandomState(3).randint(0, 256, size=32 * KB).astype(np.uint8)
        c.put(0, "h", x)
        same_bits(TORCH.get(c, 1, "h", timeout=30.0), x)
        c._comm.silence_node(2)
        deadline = time.time() + 20.0
        while time.time() < deadline and 2 not in c.dead:
            time.sleep(0.01)
        assert 2 in c.dead and c.stats["heartbeat_misses"] >= 1
        same_bits(TORCH.get(c, 1, "h", timeout=30.0), x)
    finally:
        c.shutdown()


# ---------------------------------------------------------------------------
# more scenarios of the JAX package's tests, on the port
# ---------------------------------------------------------------------------


@settings(max_examples=10, deadline=None)
@given(n=st.integers(2, 6), seed=st.integers(0, 2**31 - 1), elems=st.integers(100, 5000))
def test_reduce_is_the_exact_sum_under_any_arrival_order(n, seed, elems):
    """tests/test_properties.py's property on both packages: the reduce of
    random f64 objects at random nodes, read at a random node, is numpy's
    sum within 1e-11, and the two packages agree within it."""
    rng = np.random.RandomState(seed)
    vals = [rng.rand(elems) for _ in range(n)]
    into, read = rng.randint(n), rng.randint(n)

    def run(side):
        c = side.cluster(n)
        for i, v in enumerate(vals):
            c.put(i, f"o{i}", v)
        c.reduce(into, "sum", [f"o{i}" for i in range(n)])
        return side.get(c, read, "sum")

    j, t = both(run)
    np.testing.assert_allclose(t, sum(vals), rtol=1e-11)
    np.testing.assert_allclose(t, j, rtol=1e-11)


def test_get_chases_a_producing_target_until_it_completes():
    """A receiver at the watermark of a producing partial waits for the
    producer instead of declaring the object lost."""
    c = TORCH.cluster(2, chunk_size=16 * KB)
    payload = np.random.RandomState(0).rand(40_000)
    raw = torch.from_numpy(payload.view(np.uint8))
    with c.lock:
        c.meta["t"] = (torch.float64, (40_000,))
        buf = c.stores[0].create("t", raw.numel(), pinned=True, chunk_size=16 * KB)
        c.directory.publish_partial("t", 0, raw.numel(), producing=True)
    half = raw.numel() // 2 - (raw.numel() // 2) % 64
    buf.write_chunk(0, raw[:half])
    with c.lock:
        c.directory.update_progress("t", 0, half)
    f = c.get_async(1, "t", timeout=30.0)
    time.sleep(0.3)
    assert not f.done(), "the receiver gave up on a producing partial"
    buf.write_chunk(half, raw[half:])
    with c.lock:
        c.directory.publish_complete("t", 0, raw.numel())
    same_bits(t2n(f.result(timeout=30.0)), payload)


def test_mid_broadcast_source_failure_replans_and_resumes():
    c = TORCH.cluster(6, chunk_size=32 * KB, pace=0.002, max_out_degree=4)
    x = np.random.RandomState(1).rand(200_000).astype(np.float32)
    c.put(0, "x", x)
    f1 = c.get_async(1, "x", timeout=30.0)
    deadline = time.time() + 10.0
    while time.time() < deadline:
        b = c.stores[1].get("x")
        if b is not None and 0 < b.bytes_present < b.size:
            break
        time.sleep(0.001)
    chasers = [c.get_async(i, "x", timeout=30.0) for i in range(2, 6)]
    deadline = time.time() + 10.0
    while time.time() < deadline and not any(c.stores[i].get("x") is not None for i in range(2, 6)):
        time.sleep(0.001)
    c.fail_node(1)
    for f in chasers:
        same_bits(t2n(f.result(timeout=30.0)), x)
    with pytest.raises(Exception):
        f1.result(timeout=5.0)


def test_failover_resumes_from_the_watermark_not_zero():
    c = TORCH.cluster(3, chunk_size=32 * KB, pace=0.002)
    x = np.random.RandomState(2).rand(200_000).astype(np.float32)
    c.put(0, "x", x)
    c.put(2, "x", x)
    with c.lock:
        c.directory._outbound[2] = 1_000  # the fetch must start from node 0
    f = c.get_async(1, "x", timeout=30.0)
    deadline = time.time() + 10.0
    while time.time() < deadline:
        b = c.stores[1].get("x")
        if b is not None and b.bytes_present > 2 * 32 * KB:
            break
        time.sleep(0.001)
    with c.lock:
        c.directory._outbound[2] = 0
        mark = c.stores[1].get("x").bytes_present
    c.fail_node(0)
    same_bits(t2n(f.result(timeout=30.0)), x)
    resumed = c.stats["bytes_served"].get(2, 0)
    assert 0 < resumed <= x.nbytes - mark + 4 * 32 * KB


def test_sibling_gets_share_one_inbound_stream():
    c = TORCH.cluster(2, chunk_size=32 * KB, pace=0.001)
    x = np.random.RandomState(3).rand(150_000).astype(np.float32)
    c.put(0, "x", x)
    for f in [c.get_async(1, "x", timeout=30.0) for _ in range(4)]:
        same_bits(t2n(f.result(timeout=30.0)), x)
    assert len([t for t in c.transfers if t[1] == 1]) == 1
    assert c.stats["bytes_served"].get(0, 0) == x.nbytes


def _wedge(c, node, oid, arr, half, producing):
    """A copy of ``arr`` at ``node`` whose first ``half`` bytes landed and
    whose watermark then froze (its sender died silently)."""
    raw = torch.from_numpy(arr.view(np.uint8))
    buf = c.stores[node].create(oid, raw.numel(), pinned=False, chunk_size=4096)
    buf.write_chunk(0, raw[:half])
    with c.lock:
        if producing:
            c.meta[oid] = (torch.float64, arr.shape)
        c.directory.publish_partial(oid, node, raw.numel(), producing=producing)
        c.directory.update_progress(oid, node, half)


def test_a_stalled_fetch_replans_onto_another_copy():
    ft = FaultToleranceConfig(stall_timeout=0.3, watermark_recheck_s=0.1, get_timeout=30.0)
    c = TORCH.cluster(3, chunk_size=4096, pace=0.002, max_out_degree=1, fault_tolerance=ft, trace=True)
    x = np.random.RandomState(0).rand(40_000)
    c.put(0, "x", x)
    half = x.nbytes // 2 - (x.nbytes // 2) % 4096
    _wedge(c, 1, "x", x, half, producing=False)
    with c.lock:
        epoch0 = c.directory.charge_source("x", 0)  # node 0 at its cap: the wedged copy is planned first
    def free():  # once the fetch has given up on the wedged copy
        deadline = time.time() + 20.0
        while time.time() < deadline and c.stats["stall_replans"] < 1:
            time.sleep(0.01)
        with c.lock:
            c.directory.release_source("x", 0, epoch0)

    t = threading.Thread(target=free, daemon=True)
    t.start()
    same_bits(TORCH.get(c, 2, "x", timeout=30.0), x)
    t.join(timeout=30.0)
    assert c.stats["stall_replans"] >= 1
    replans = [e for e in c.trace.events() if e[4] == "replan" and (e[7] or {}).get("reason") == "source-stalled"]
    assert replans and replans[0][7]["src"] == 1


def test_a_stalled_fold_input_is_evicted_and_respliced():
    ft = FaultToleranceConfig(stall_timeout=0.3, watermark_recheck_s=0.1)
    c = TORCH.cluster(4, chunk_size=4096, pace=0.002, fault_tolerance=ft, trace=True)
    rng = np.random.RandomState(1)
    g1, g2 = rng.rand(40_000), rng.rand(40_000)
    c.put(2, "g2", g2)
    half = g1.nbytes // 2 - (g1.nbytes // 2) % 4096
    _wedge(c, 1, "g1", g1, half, producing=True)

    def replica():  # once the fold has consumed the wedged prefix
        deadline = time.time() + 20.0
        while time.time() < deadline:
            b = c.stores[0].get("rsum")
            if b is not None and b.bytes_present >= half:
                break
            time.sleep(0.01)
        c.put(3, "g1", g1)

    t = threading.Thread(target=replica, daemon=True)
    t.start()
    c.reduce(0, "rsum", ["g1", "g2"], TA.SUM, timeout=30.0)
    t.join(timeout=30.0)
    same_bits(TORCH.get(c, 0, "rsum"), g1 + g2)
    assert c.stats["stall_replans"] >= 1 and c.stats["resplices"] >= 1


def test_a_drain_hands_off_a_producing_chain_partial():
    vals = [np.full(32_768, float(i + 1)) for i in range(3)]
    c = TORCH.cluster(3, chunk_size=2 * KB, pace=0.004, trace=True)
    for i in range(3):
        c.put(i, f"g{i}", vals[i])
    for i in range(3):
        c.prefetch_async((i + 1) % 3, f"g{i}").result(timeout=10)
    fut = Future()
    threading.Thread(target=lambda: fut.set_result(c.reduce(0, "sum", ["g0", "g1", "g2"], TA.SUM, timeout=45.0)),
                     daemon=True).start()
    time.sleep(0.15)
    c.drain_node(2, deadline=0.05)
    fut.result(timeout=45.0)
    same_bits(TORCH.get(c, 0, "sum"), sum(vals))
    assert c.stats["splices_drain"] >= 1 and c.stats["resplices"] == 0


def test_a_waiting_reduce_wakes_after_directory_failover():
    c = TORCH.cluster(2, directory_replicas=1)
    a, b = np.random.RandomState(5).rand(30_000), np.random.RandomState(6).rand(30_000)
    c.put(0, "early", a)
    result = {}

    def blocked():
        c.reduce(1, "out", ["early", "late"], timeout=15.0)
        result["val"] = TORCH.get(c, 1, "out", timeout=15.0)

    th = threading.Thread(target=blocked, daemon=True)
    th.start()
    time.sleep(0.2)
    c.fail_directory_primary()
    c.put(0, "late", b)
    th.join(timeout=20.0)
    assert not th.is_alive()
    same_bits(result["val"], a + b)
