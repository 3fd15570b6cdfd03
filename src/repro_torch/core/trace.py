"""Flight-recorder tracing + latency instrumentation for the data plane.

Three layers, shared verbatim by the threaded cluster (``core/local.py``),
the discrete-event simulator (``core/simulation.py``) and the serving
front-end (``serve/``):

  * :class:`FlightRecorder` -- a low-overhead in-memory event recorder.
    Events are appended to per-thread bounded ring buffers (no lock on
    the append path; each thread owns its ring), timestamps come from a
    pluggable monotonic clock (``time.perf_counter`` on the threaded
    plane, ``sim.now`` on the discrete-event plane -- so ONE event schema
    covers both).  A disabled recorder costs one attribute load + branch
    per call site, so instrumentation can stay compiled-in everywhere.

  * Stage attribution -- every traced operation partitions its wall time
    into the stages of :data:`STAGES` (``producer-wait``, ``cap-blocked``,
    ``streaming``, ``replan``, ``resplice``, plus ``plan`` for in-lock
    planning compute).  :func:`critical_path` walks a recording and sums
    the per-stage spans (optionally for one object id), answering "where
    did this collective's latency go"; live totals are also accumulated
    into ``DataPlaneStats.stage_seconds`` so ``cluster.stats`` carries
    them without a trace dump.

  * :class:`LatencyHistogram` -- a bucketed latency recorder with O(log
    #buckets) insert and p50/p99/p999 queries.  Exact samples are kept
    while ``count <= exact_limit`` (small-n percentiles stay exact, the
    mode the serving tests rely on); past the limit samples spill into
    geometric buckets with ~7% relative resolution.  All reads take the
    lock (the old ``serve/metrics.py`` version read ``count``/``mean``
    unlocked and claimed O(log n) insert for ``bisect.insort``'s O(n)).

Event schema (one tuple per event, converted only at export):

    (ts, node, tid, cat, name, dur, object_id, args)

``ts``/``dur`` are clock-unit floats (seconds); ``dur`` is None for
instant events.  ``node`` is the pid lane in the Chrome-trace export
(``NODE_ROUTER`` = -1 for serving-plane events); ``cat`` is one of
:data:`CATEGORIES`.  :meth:`FlightRecorder.dump_chrome_trace` writes the
standard Chrome trace-event JSON (``{"traceEvents": [...]}``), which
``chrome://tracing`` and Perfetto (https://ui.perfetto.dev) open
directly.
"""

from __future__ import annotations

import bisect
import json
import math
import threading
import time
from typing import Callable, Dict, Iterable, List, Optional, Tuple

# -- stage vocabulary (critical-path attribution) ---------------------------

STAGE_PLAN = "plan"                    # in-lock planning compute
STAGE_PRODUCER_WAIT = "producer-wait"  # no feasible source: waiting on a
#                                        watermark/publication to appear
STAGE_CAP_BLOCKED = "cap-blocked"      # feasible sources exist but all sit
#                                        at the out-degree cap
STAGE_STREAMING = "streaming"          # bytes moving (copy or fold windows)
STAGE_REPLAN = "replan"                # re-planning after a failed leg
STAGE_RESPLICE = "resplice"            # rebuilding a lost chain partial
STAGE_STRAGGLER_CUT = "straggler-cut"  # bounded-time allreduce: waiting past
#                                        the soft deadline for the k-of-n
#                                        participation quorum

STAGES = (
    STAGE_PLAN,
    STAGE_PRODUCER_WAIT,
    STAGE_CAP_BLOCKED,
    STAGE_STREAMING,
    STAGE_REPLAN,
    STAGE_RESPLICE,
    STAGE_STRAGGLER_CUT,
)

# -- event categories -------------------------------------------------------

CAT_FETCH = "fetch"          # fetch plan / re-plan / resume decisions
CAT_STREAM = "stream"        # window drains, watermark stalls
CAT_DIRECTORY = "directory"  # select_source / release_source / cap-blocked
CAT_CHAIN = "chain"          # reduce hops, chain folds, re-splices
CAT_STAGE = "stage"          # stage-attribution spans (critical path)
CAT_SERVE = "serve"          # router / request lifecycle
CAT_FAULT = "fault"          # injected faults (kills, restarts, slow onsets)
CAT_MEMBERSHIP = "membership"  # elastic membership (joins, drains)
CAT_COMM = "comm"            # transport: connects, retries, reconnects,
#                              heartbeat misses

CATEGORIES = (CAT_FETCH, CAT_STREAM, CAT_DIRECTORY, CAT_CHAIN, CAT_STAGE,
              CAT_SERVE, CAT_FAULT, CAT_MEMBERSHIP, CAT_COMM)

# pid lane for serving-plane events (data-plane nodes are >= 0)
NODE_ROUTER = -1

# -- the port's own names (the JAX package has none of them) ----------------
#
# Spans of the data plane's hand-offs, recorded only while the recorder is
# on; their always-on totals are ``DataPlaneStats`` counters:
SPAN_WAKE = "wake"          # CAT_STREAM: a watermark advance that could
#                             release a waiter, to the waiter's return
#                             (``woken``, ``wake_lag_seconds``)
SPAN_WINDOW = "window"      # CAT_STREAM: one copy or fold window, from every
#                             input's watermark held to its own advance
#                             (``windows``, ``window_issue_seconds``); args
#                             ``card_done``: when the card ran its work
#                             (None off the card)
SPAN_DIR_LOCK = "dir-lock"  # CAT_DIRECTORY: a contended wait for the
#                             directory lock (``dir_lock_wait_seconds``)

# Runtime tasks: each task's wall time, from ``remote()`` to its ref being
# ready, as consecutive stages summed into ``stats["task_seconds"]`` (never
# into ``stage_seconds``) and recorded as CAT_TASK spans.
TASK_QUEUED = "task-queued"  # submitted, waiting for an executor slot
TASK_ARGS = "task-args"      # resolving ObjectRef arguments (Gets)
TASK_RUN = "task-run"        # the task's function
TASK_PUT = "task-put"        # the result's Put

TASK_STAGES = (TASK_QUEUED, TASK_ARGS, TASK_RUN, TASK_PUT)

CAT_TASK = "task"

PORT_CATEGORIES = (CAT_TASK,)

# pid lane for the directory lock's waits (its callers span every node)
NODE_DIRECTORY = -2

# Re-splice reason carried by member-change splice instants
# (``splice-join`` / ``splice-drain`` under CAT_CHAIN): distinguishes an
# elastic member-set change from the failure-driven ``resplice`` events,
# whose count must keep matching ``stats["resplices"]`` exactly.
RESPLICE_MEMBER_CHANGE = "member-change"


class FlightRecorder:
    """Bounded in-memory recorder of structured data-plane events.

    Appends go to a per-thread ring buffer discovered through a
    ``threading.local`` -- no lock is taken on the hot path, and a full
    ring drops the oldest events (flight-recorder semantics: the tail of
    a long run is what you want when something goes wrong).  ``enabled``
    is checked first at every call site, so a disabled recorder costs a
    bool read; construction is cheap enough to always hang one off a
    cluster.

    ``clock`` must be monotonic and return float seconds; the threaded
    plane uses ``time.perf_counter``, the simulator passes ``lambda:
    sim.now`` so simulated traces carry simulated time.

    ``dropped`` counts the events full rings have dropped since the last
    ``clear``.

    On a CUDA ``device`` the recorder also places the card's clock on its
    own: ``enable`` and ``disable`` each record an anchor, a CUDA event on
    an idle stream of its own, synchronised at a known ``clock`` reading.
    ``card_event`` records a timing event after work the caller enqueued;
    an event in a span's args is resolved to the ``clock`` time at which
    the card ran it only when ``events`` reads it (linearly between the
    first and the last anchor), never on the append path.
    """

    def __init__(
        self,
        enabled: bool = False,
        capacity_per_thread: int = 1 << 16,
        clock: Callable[[], float] = time.perf_counter,
        device=None,
    ):
        self.enabled = False
        self.capacity = capacity_per_thread
        self.clock = clock
        self.dropped = 0
        self._local = threading.local()
        self._rings: List[Tuple[str, List]] = []  # (tid label, ring)
        self._reg_lock = threading.Lock()
        self._cuda = getattr(device, "type", None) == "cuda"
        self._device = device
        self._anchors: List[tuple] = []  # (CUDA event, clock time, half-width)
        self._anchor_stream = None
        if enabled:
            self.enable()

    # -- lifecycle ----------------------------------------------------------

    def enable(self) -> None:
        if self._cuda:
            self._anchor()
        self.enabled = True

    def disable(self) -> None:
        self.enabled = False
        if self._cuda and self._anchors:
            self._anchor()

    def clear(self) -> None:
        with self._reg_lock:
            for _tid, ring in self._rings:
                del ring[:]
            self.dropped = 0

    # -- the card's clock ---------------------------------------------------

    def _anchor(self) -> None:
        """A CUDA event on an idle stream, stamped by the card as soon as it
        is enqueued, synchronised between two ``clock`` readings: their
        midpoint is its time, good to half their distance."""
        import torch

        if self._anchor_stream is None:
            self._anchor_stream = torch.cuda.Stream(device=self._device)
        ev = torch.cuda.Event(enable_timing=True)
        t0 = self.clock()
        ev.record(self._anchor_stream)
        ev.synchronize()
        t1 = self.clock()
        self._anchors.append((ev, (t0 + t1) / 2, (t1 - t0) / 2))

    def card_event(self, device):
        """A timing CUDA event recorded now on the current stream of
        ``device`` (after the work the caller enqueued there), or None off
        the card or before the first anchor."""
        if not self._anchors or getattr(device, "type", None) != "cuda":
            return None
        import torch

        ev = torch.cuda.Event(enable_timing=True)
        ev.record()
        return ev

    def _card_time(self, ev) -> float:
        ev.synchronize()
        a0, h0, _ = self._anchors[0]
        a1, h1, _ = self._anchors[-1]
        ms = a0.elapsed_time(ev)
        if a1 is not a0:
            span_ms = a0.elapsed_time(a1)
            if span_ms > 0.0:
                return h0 + ms * (h1 - h0) / span_ms
        return h0 + ms / 1e3

    def card_skew(self) -> Optional[float]:
        """Seconds by which the first anchor alone, at the card's own rate,
        misplaces the last anchor on ``clock`` (None with fewer than two):
        the drift between the two clocks that the linear map takes out."""
        if len(self._anchors) < 2:
            return None
        (a0, h0, _), (a1, h1, _) = self._anchors[0], self._anchors[-1]
        return h0 + a0.elapsed_time(a1) / 1e3 - h1

    # -- append path --------------------------------------------------------

    def _ring(self) -> List:
        ring = getattr(self._local, "ring", None)
        if ring is None:
            ring = []
            self._local.ring = ring
            tid = threading.current_thread().name
            with self._reg_lock:
                self._rings.append((f"{tid}-{len(self._rings)}", ring))
        return ring

    def _append(self, event: tuple) -> None:
        ring = self._ring()
        ring.append(event)
        if len(ring) > self.capacity:
            # Drop the oldest half in one slice (amortized O(1)/event)
            # instead of popping per append.
            del ring[: self.capacity // 2]
            with self._reg_lock:
                self.dropped += self.capacity // 2

    def instant(
        self,
        cat: str,
        name: str,
        node: int,
        object_id: Optional[str] = None,
        **args,
    ) -> None:
        """Zero-duration marker event (rendered as an arrow in Perfetto)."""
        if not self.enabled:
            return
        self._append((self.clock(), node, None, cat, name, None, object_id, args or None))

    def span(
        self,
        cat: str,
        name: str,
        node: int,
        t0: float,
        dur: float,
        object_id: Optional[str] = None,
        **args,
    ) -> None:
        """Complete event covering ``[t0, t0 + dur]`` in clock units."""
        if not self.enabled:
            return
        self._append((t0, node, None, cat, name, dur, object_id, args or None))

    # -- reads --------------------------------------------------------------

    def events(self) -> List[tuple]:
        """Merged time-ordered snapshot of every thread's ring.  A CUDA event
        left in a span's ``card_done`` is resolved to its ``clock`` time
        here, once (the card is waited for)."""
        with self._reg_lock:
            merged = []
            for tid, ring in self._rings:
                for ev in list(ring):
                    args = ev[7]
                    if args and args.get("card_done") is not None and not isinstance(args["card_done"], float):
                        args["card_done"] = self._card_time(args["card_done"])
                    merged.append(ev[:2] + (tid,) + ev[3:])
        merged.sort(key=lambda e: e[0])
        return merged

    def count(self, cat: Optional[str] = None) -> int:
        evs = self.events()
        if cat is None:
            return len(evs)
        return sum(1 for e in evs if e[3] == cat)

    # -- export -------------------------------------------------------------

    def to_chrome_trace(self, absolute: bool = False) -> Dict:
        """Chrome trace-event JSON object (``chrome://tracing`` / Perfetto).

        Timestamps are exported in microseconds relative to the first
        event, one pid per data-plane node (plus a ``router`` lane for
        serving events), one tid per recording thread.  With ``absolute``
        they are the ``clock``'s own readings in microseconds
        (``time.perf_counter`` on the threaded plane), so that a dump can be
        laid over a ``torch.profiler`` trace whose marks place that clock.
        """
        evs = self.events()
        t_base = evs[0][0] if evs and not absolute else 0.0
        out = []
        pids = set()
        tids = set()
        for ts, node, tid, cat, name, dur, oid, args in evs:
            pids.add(node)
            tids.add((node, tid))
            rec = {
                "name": name,
                "cat": cat,
                "pid": int(node),
                "tid": tid,
                "ts": (ts - t_base) * 1e6,
            }
            a = dict(args) if args else {}
            if oid is not None:
                a["object_id"] = oid
            if a:
                rec["args"] = a
            if dur is None:
                rec["ph"] = "i"
                rec["s"] = "t"  # thread-scoped instant
            else:
                rec["ph"] = "X"
                rec["dur"] = dur * 1e6
            out.append(rec)
        meta = []
        for pid in sorted(pids):
            label = ("router" if pid == NODE_ROUTER else "directory lock" if pid == NODE_DIRECTORY
                     else f"node {pid}")
            meta.append(
                {
                    "name": "process_name",
                    "ph": "M",
                    "pid": int(pid),
                    "args": {"name": label},
                }
            )
        return {"traceEvents": meta + out, "displayTimeUnit": "ms"}

    def dump_chrome_trace(self, path: str, absolute: bool = False) -> int:
        """Write the Chrome-trace JSON to ``path``; returns #events."""
        trace = self.to_chrome_trace(absolute)
        with open(path, "w") as f:
            json.dump(trace, f)
        return sum(1 for e in trace["traceEvents"] if e.get("ph") != "M")


# ---------------------------------------------------------------------------
# critical-path analysis
# ---------------------------------------------------------------------------


def critical_path(
    events: Iterable[tuple], object_id: Optional[str] = None
) -> Dict[str, object]:
    """Attribute a recording's latency to stages.

    Walks the ``stage``-category spans (each traced operation partitions
    its own wall time into consecutive stage spans) and sums durations
    per stage, optionally restricted to one ``object_id`` -- "where did
    this collective's time go".  Returns::

        {"stages": {stage: seconds}, "total": sum, "wall": last_end -
         first_start, "events": #spans}

    ``total`` can exceed ``wall`` when several operations (threads)
    overlapped: stage seconds are per-operation, wall is the union.
    """
    stages: Dict[str, float] = {}
    n = 0
    t_lo = None
    t_hi = None
    for ev in events:
        ts, _node, _tid, cat, name, dur, oid = ev[:7]
        if cat != CAT_STAGE or dur is None:
            continue
        if object_id is not None and oid != object_id:
            continue
        n += 1
        stages[name] = stages.get(name, 0.0) + dur
        t_lo = ts if t_lo is None else min(t_lo, ts)
        end = ts + dur
        t_hi = end if t_hi is None else max(t_hi, end)
    return {
        "stages": stages,
        "total": sum(stages.values()),
        "wall": (t_hi - t_lo) if n else 0.0,
        "events": n,
    }


class StageClock:
    """Partition one operation's wall time into attribution stages.

    Owned by a single thread (one per fetch / chain finalization / hop;
    a Runtime task's clock passes from ``remote`` to the task's thread).
    ``switch(stage)`` closes the current stage span and opens the next;
    consecutive switches to the same stage merge (no event spam from a
    window loop flapping between wait and copy with nothing to wait for).
    Each closed span is added to the stats dict named by ``field``
    (``stats.stage_seconds`` by default; always, cheap) and recorded as a
    ``cat`` span in the trace (when enabled), so ``critical_path`` over a
    dump and ``cluster.stats`` agree.
    """

    __slots__ = ("_stats", "_trace", "_node", "_oid", "_t", "_stage", "_cat", "_field")

    def __init__(self, stats, trace: FlightRecorder, node: int, object_id: Optional[str],
                 stage: str = STAGE_PLAN, *, cat: str = CAT_STAGE, field: str = "stage_seconds"):
        self._stats = stats
        self._trace = trace
        self._node = node
        self._oid = object_id
        self._t = trace.clock()
        self._stage = stage
        self._cat = cat
        self._field = field

    @property
    def stage(self) -> str:
        return self._stage

    def switch(self, stage: str) -> None:
        if stage == self._stage:
            return
        self._flush(self._trace.clock())
        self._stage = stage

    def _flush(self, now: float) -> None:
        dur = now - self._t
        if dur > 0.0:
            if self._stats is not None:
                self._stats.note_seconds(self._field, self._stage, dur)
            if self._trace.enabled:
                self._trace.span(
                    self._cat, self._stage, self._node, self._t, dur,
                    object_id=self._oid,
                )
        self._t = now

    def close(self) -> None:
        """Close the final span (call exactly once, in a finally)."""
        self._flush(self._trace.clock())


# ---------------------------------------------------------------------------
# latency histogram
# ---------------------------------------------------------------------------

# Geometric bucket bounds: 1 us .. ~3.7 h at ~7% relative resolution.
_BUCKET_LO = 1e-6
_BUCKET_FACTOR = 1.07
_NUM_BUCKETS = int(math.log(1e10) / math.log(_BUCKET_FACTOR)) + 1
_BOUNDS = [_BUCKET_LO * _BUCKET_FACTOR ** i for i in range(_NUM_BUCKETS)]


class LatencyHistogram:
    """Latency recorder with exact small-n percentiles and bucketed tails.

    ``record`` is O(1) while ``count <= exact_limit`` (append to an
    unsorted list) and O(log #buckets) afterwards (bisect into geometric
    buckets, ~7% relative resolution -- plenty for p50/p99/p999 tails).
    Percentile queries are exact in the first mode and bucket-resolution
    in the second.  Every read (``count``, ``mean``, ``percentile``)
    takes the lock: latency recording races with reporting in both the
    serving stack and the benchmark harness.
    """

    def __init__(self, exact_limit: int = 4096):
        self.exact_limit = exact_limit
        self._samples: Optional[List[float]] = []
        self._buckets: Optional[List[int]] = None
        self._count = 0
        self._sum = 0.0
        self._max = 0.0
        self._lock = threading.Lock()

    # -- writes -------------------------------------------------------------

    def _bucket_index(self, seconds: float) -> int:
        if seconds <= _BUCKET_LO:
            return 0
        return min(_NUM_BUCKETS - 1, bisect.bisect_left(_BOUNDS, seconds))

    def _spill(self) -> None:
        """Switch from exact samples to buckets (holding the lock)."""
        self._buckets = [0] * _NUM_BUCKETS
        for s in self._samples:
            self._buckets[self._bucket_index(s)] += 1
        self._samples = None

    def record(self, seconds: float) -> None:
        with self._lock:
            self._count += 1
            self._sum += seconds
            if seconds > self._max:
                self._max = seconds
            if self._samples is not None:
                self._samples.append(seconds)
                if len(self._samples) > self.exact_limit:
                    self._spill()
            else:
                self._buckets[self._bucket_index(seconds)] += 1

    def reset(self) -> None:
        with self._lock:
            self._samples = []
            self._buckets = None
            self._count = 0
            self._sum = 0.0
            self._max = 0.0

    # -- reads --------------------------------------------------------------

    @property
    def count(self) -> int:
        with self._lock:
            return self._count

    def mean(self) -> float:
        with self._lock:
            return self._sum / self._count if self._count else 0.0

    def percentile(self, p: float) -> float:
        """p in [0, 100]; 0.0 when empty.  Exact below ``exact_limit``
        samples, bucket-resolution (~7%) above."""
        with self._lock:
            if not self._count:
                return 0.0
            if p >= 100.0:
                return self._max  # exact in both modes
            if self._samples is not None:
                ordered = sorted(self._samples)
                idx = min(
                    len(ordered) - 1,
                    int(round(p / 100.0 * (len(ordered) - 1))),
                )
                return ordered[idx]
            # Bucketed: rank-walk the cumulative counts; report the
            # geometric midpoint of the covering bucket, capped by the
            # exact max (p100 must equal max, not a bucket bound).
            rank = p / 100.0 * (self._count - 1)
            seen = 0
            for i, c in enumerate(self._buckets):
                if c == 0:
                    continue
                seen += c
                if seen > rank:
                    lo = _BOUNDS[i - 1] if i else 0.0
                    return min(self._max, (lo + _BOUNDS[i]) / 2.0)
            return self._max

    def summary(self) -> Dict[str, float]:
        return {
            "count": float(self.count),
            "mean": self.mean(),
            "p50": self.percentile(50),
            "p90": self.percentile(90),
            "p99": self.percentile(99),
            "p999": self.percentile(99.9),
            "max": self.percentile(100),
        }
