"""The port's own spans and counters at the data plane's hand-offs and in
``Runtime``'s tasks (``core/store.py``, ``core/local.py``,
``runtime/runtime.py``, ``core/trace.py``), and the benchmark's readers of
them (``hoplite_bench/metrics/``), on the CPU.

The spans and the always-on counters read the same clock over the same
intervals, so they must agree: a window span for every ``windows``
increment, their durations summing to ``window_issue_seconds``, a ``wake``
span for every ``woken``.  With the recorder off nothing is appended and no
CUDA event is made.  The benchmark reads the counters; its harness does not
yet turn the recorder on."""

import sys
import threading
import time
from pathlib import Path

import pytest
import torch

from repro_torch.core import trace as TT
from repro_torch.core.api import SUM
from repro_torch.core.local import LocalCluster
from repro_torch.core.store import ChunkedBuffer, DataPlaneStats
from repro_torch.runtime import Runtime

ROOT = Path(__file__).resolve().parents[1]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

from hoplite_bench import harness  # noqa: E402  (after the checkout's root is on the path)

NODES = 8
NBYTES = 1 << 16


def _waiting(buf, hi, out, timeout=None):
    t = threading.Thread(target=lambda: out.append(buf.wait_for_bytes(hi, timeout)))
    t.start()
    deadline = time.time() + 10
    while not buf._waiting and t.is_alive() and time.time() < deadline:
        time.sleep(0.001)
    return t


# -- 1. the watermark hand-off --------------------------------------------------


def test_a_waiter_woken_by_write_chunk_counts_its_lag_and_its_span():
    stats = DataPlaneStats()
    rec = TT.FlightRecorder(enabled=True)
    buf = ChunkedBuffer(128, 32, stats=stats, device=torch.device("cpu"), trace=rec, object_id="x", node=3)
    got = []
    t = _waiting(buf, 64, got)
    # An advance short of the waiter's watermark does not release it ...
    buf.write_chunk(0, torch.ones(32, dtype=torch.uint8))
    time.sleep(0.05)
    assert stats.woken == 0
    # ... the one that meets it does, and the lag runs from that advance.
    t_advance = time.perf_counter()
    buf.write_chunk(32, torch.ones(32, dtype=torch.uint8))
    t.join(10)
    t_back = time.perf_counter()
    assert not t.is_alive() and got == [64]
    assert stats.woken == 1
    assert 0.0 <= stats.wake_lag_seconds <= t_back - t_advance
    wakes = [e for e in rec.events() if e[4] == TT.SPAN_WAKE]
    assert len(wakes) == 1
    ts, node, _tid, cat, _name, dur, oid, _args = wakes[0]
    assert (node, cat, oid) == (3, TT.CAT_STREAM, "x")
    assert dur == stats.wake_lag_seconds and ts >= t_advance
    assert stats.wakeups == 2 and stats.notifies == 2


def test_a_timed_out_wait_is_a_wakeup_but_not_woken():
    stats = DataPlaneStats()
    buf = ChunkedBuffer(64, 32, stats=stats, device=torch.device("cpu"))
    assert buf.wait_for_bytes(64, timeout=0.02) == 0
    assert (stats.wakeups, stats.woken, stats.wake_lag_seconds) == (1, 0, 0.0)


def test_a_failed_buffer_releases_its_waiter_as_woken():
    stats = DataPlaneStats()
    buf = ChunkedBuffer(64, 32, stats=stats, device=torch.device("cpu"))
    got = []
    t = _waiting(buf, 64, got)
    buf.fail()
    t.join(10)
    assert not t.is_alive() and got == [0] and stats.woken == 1


# -- 2. the window, on a traced 8-node allreduce ---------------------------------------


def _cluster(trace):
    c = LocalCluster(NODES, device="cpu", trace=trace)
    for client in range(2):
        for i in range(NODES):
            c.put(i, f"x{client}.{i}", torch.arange(NBYTES // 4, dtype=torch.float32) + i + client)
    return c


def _allreduce(c, client, tid):
    c.allreduce(list(range(NODES)), tid, [f"x{client}.{i}" for i in range(NODES)], SUM)


def test_window_spans_agree_with_the_counters_and_nest_in_their_legs(monkeypatch):
    """Two allreduces at once, the interpreter switching threads every
    10 us: a lost update of ``windows`` or ``window_issue_seconds`` would
    break the equalities."""
    made = []
    real = TT.FlightRecorder.card_event
    monkeypatch.setattr(TT.FlightRecorder, "card_event", lambda self, device: made.append(device) or real(self, device))
    c = _cluster(trace=True)
    s0 = c.stats
    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-5)
    try:
        threads = [threading.Thread(target=_allreduce, args=(c, k, f"t{k}")) for k in range(2)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(120)
    finally:
        sys.setswitchinterval(interval)
    assert not any(t.is_alive() for t in threads)
    s1 = c.stats
    c.trace.disable()
    evs = c.trace.events()
    windows = [e for e in evs if e[4] == TT.SPAN_WINDOW]
    n = s1["windows"] - s0["windows"]
    assert n > 2 * NODES and len(windows) == n == len(made)
    assert sum(e[5] for e in windows) == pytest.approx(s1["window_issue_seconds"] - s0["window_issue_seconds"],
                                                      rel=1e-9, abs=1e-12)
    legs = [e for e in evs if e[4] in ("copy-leg", "fold-leg")]
    for ts, node, tid, cat, _name, dur, oid, args in windows:
        assert cat == TT.CAT_STREAM and dur >= 0.0
        assert args["bytes"] > 0 and args["inputs"] >= 1 and args["card_done"] is None
        assert any(l[2] == tid and l[1] == node and l[6] == oid and l[0] <= ts and ts + dur <= l[0] + l[5]
                   for l in legs), (tid, oid)
    # The ordinals count each leg's windows from 0.
    assert min(e[7]["k"] for e in windows) == 0
    assert s1["woken"] - s0["woken"] == sum(1 for e in evs if e[4] == TT.SPAN_WAKE)
    assert c.trace.dropped == 0
    for client in range(2):
        want = sum(torch.arange(NBYTES // 4, dtype=torch.float32) + i + client for i in range(NODES))
        assert all(torch.equal(c.get(i, f"t{client}"), want) for i in range(NODES))
    c.shutdown()


def test_with_the_recorder_off_an_allreduce_appends_nothing_and_makes_no_card_event(monkeypatch):
    appended, made = [], []
    monkeypatch.setattr(TT.FlightRecorder, "_append", lambda self, ev: appended.append(ev))
    monkeypatch.setattr(TT.FlightRecorder, "card_event", lambda self, device: made.append(device))
    c = _cluster(trace=False)
    s0 = c.stats
    _allreduce(c, 0, "t")
    s1 = c.stats
    assert c.trace.events() == [] and appended == [] and made == []
    # The always-on counters still count.
    assert s1["windows"] > s0["windows"] and s1["window_issue_seconds"] > s0["window_issue_seconds"]
    c.shutdown()


# -- 3. the directory lock -------------------------------------------------------------


def test_only_a_contended_directory_lock_is_timed_and_traced():
    c = LocalCluster(2, device="cpu", trace=True)
    with c.lock:
        with c._dir_lock:  # re-entrant, uncontended: not timed
            pass
    assert c.stats["dir_lock_wait_seconds"] == 0.0
    assert not [e for e in c.trace.events() if e[4] == TT.SPAN_DIR_LOCK]
    held = threading.Event()

    def hold():
        with c._dir_lock:
            held.set()
            time.sleep(0.05)

    t = threading.Thread(target=hold)
    t.start()
    held.wait(10)
    with c._dir_lock:
        pass
    t.join(10)
    assert not t.is_alive()
    spans = [e for e in c.trace.events() if e[4] == TT.SPAN_DIR_LOCK]
    assert len(spans) == 1
    ts, node, _tid, cat, _name, dur, _oid, _args = spans[0]
    assert (node, cat) == (TT.NODE_DIRECTORY, TT.CAT_DIRECTORY)
    assert dur == c.stats["dir_lock_wait_seconds"] and 0.0 < dur <= 10
    assert c._dir_lock.acquire(blocking=False)
    c._dir_lock.release()
    c.shutdown()


# -- 4. Runtime tasks ----------------------------------------------------------------------


def test_a_tasks_four_stages_tile_its_wall_time():
    rt = Runtime(num_nodes=2, device="cpu")
    rt.cluster.trace.enable()
    x = rt.put(torch.ones(NBYTES // 4), node=0)

    def twice(a):
        time.sleep(0.01)
        return a * 2

    t0 = time.perf_counter()
    ref = rt.remote(twice, x, node=1)
    assert ref.ready.wait(30) and ref.error is None
    t1 = time.perf_counter()
    spans = [e for e in rt.cluster.trace.events() if e[3] == TT.CAT_TASK and e[6] == ref.id]
    assert [e[4] for e in spans] == list(TT.TASK_STAGES)
    assert all(e[1] == 1 for e in spans)
    assert t0 <= spans[0][0] and spans[-1][0] + spans[-1][5] <= t1
    for a, b in zip(spans, spans[1:]):
        assert a[0] + a[5] == pytest.approx(b[0], abs=1e-9)
    assert spans[2][5] >= 0.01  # the function's own sleep
    totals = rt.cluster.stats["task_seconds"]
    assert {k: pytest.approx(v) for k, v in totals.items()} == {e[4]: e[5] for e in spans}
    # The data plane's stages read what they read without tasks on top.
    assert not set(TT.TASK_STAGES) & set(rt.cluster.stats["stage_seconds"])
    assert torch.equal(rt.get(ref), torch.full((NBYTES // 4,), 2.0))
    rt.cluster.shutdown()


# -- the recorder itself ------------------------------------------------------------------------


def test_the_recorder_counts_what_it_drops_and_exports_absolute_times():
    now = [100.0]
    rec = TT.FlightRecorder(enabled=True, capacity_per_thread=8, clock=lambda: now[0])
    for i in range(20):
        now[0] += 1.0
        rec.span(TT.CAT_STREAM, "window", 0, now[0], 0.5, "x", k=i)
    kept = rec.events()
    assert rec.dropped == 20 - len(kept) > 0
    rel, ab = rec.to_chrome_trace(), rec.to_chrome_trace(absolute=True)
    rel_ts = [e["ts"] for e in rel["traceEvents"] if e["ph"] == "X"]
    abs_ts = [e["ts"] for e in ab["traceEvents"] if e["ph"] == "X"]
    assert abs_ts == [e[0] * 1e6 for e in kept]
    assert rel_ts == [(e[0] - kept[0][0]) * 1e6 for e in kept]
    rec.clear()
    assert rec.dropped == 0 and rec.events() == []
    assert rec.card_event(torch.device("cpu")) is None and rec.card_skew() is None


def test_the_port_names_sit_beside_the_reference_vocabulary():
    assert not set(TT.TASK_STAGES) & set(TT.STAGES)
    assert not set(TT.PORT_CATEGORIES) & set(TT.CATEGORIES)
    assert {TT.SPAN_WAKE, TT.SPAN_WINDOW, TT.SPAN_DIR_LOCK} & set(TT.STAGES) == set()


# -- the benchmark's readers of the counters, loaded by path -----------------------------------


def _reader(name):
    return harness.Bench(ROOT).reader(name)


def _reading(stats, completed=4):
    cell = harness.Cell("allreduce-1gib", {}, {}, 1, [], [])
    w = harness.Window(start=0.0, close=50.0, completed=completed, samples_ms=[], stats0=stats[0], stats1=stats[1])
    return harness.Reading(cell, w, harness.Spans(), None, None)


def test_the_counter_readers_read_deltas_and_nothing_where_the_counter_is_absent():
    s0 = {"woken": 10, "wake_lag_seconds": 1.0, "windows": 100, "window_issue_seconds": 2.0,
          "dir_lock_wait_seconds": 0.5, "task_seconds": {"task-queued": 1.0, "task-args": 0.5}}
    s1 = {"woken": 30, "wake_lag_seconds": 1.004, "windows": 300, "window_issue_seconds": 2.1,
          "dir_lock_wait_seconds": 0.9, "task_seconds": {"task-queued": 1.2, "task-args": 0.9, "task-put": 0.1}}
    r = _reading((s0, s1))
    got = {m: _reader(m).read(r) for m in ("wake_lag_us.collective", "wake_lag_us.asgd", "window_issue_us",
                                           "dir_lock_wait_ms", "task_queued_ms", "task_io_ms")}
    assert got == pytest.approx({"wake_lag_us.collective": 200.0, "wake_lag_us.asgd": 200.0,
                                 "window_issue_us": 500.0, "dir_lock_wait_ms": 100.0,
                                 "task_queued_ms": 50.0, "task_io_ms": 125.0})
    # The parent commit's counters lack them: no value, not a zero.
    parent = _reading(({"windows": 100}, {"windows": 300}))
    assert all(_reader(m).read(parent) is None for m in got)
    assert all(_reader(m).read(_reading((None, None))) is None for m in got)
