"""Seeded fault-injection plane + fault-tolerance timing knobs.

Real clusters rarely fail the way ``fail_node`` does: the failures that
dominate tail latency are *gray* -- per-link jitter, bandwidth droop, a
node that runs 4x slow for a while, a process that crawls and THEN dies,
a machine that comes back minutes later.  This module gives both data
planes one seeded, replayable schema for all of them:

  * :class:`FaultPlan` -- a declarative, deterministic description of a
    fault campaign: per-link latency jitter and bandwidth degradation
    (:class:`LinkFault`), straggler nodes with a multiplicative slowdown
    over a time window (:class:`StragglerSpec`), delayed/flaky kills
    that crawl before dying (:class:`KillSpec`), and scheduled restarts
    (:class:`RestartSpec`).  ``FaultPlan.storm(seed, ...)`` derives a
    random-but-reproducible campaign from one seed: equal seeds produce
    equal plans (dataclass equality), which is what the chaos-soak
    replay test pins.

  * :class:`FaultInjector` -- the plan's executor, consumed by BOTH
    planes through one schema:

      - threaded ``LocalCluster``: ``window_penalty(src, dst, k, base)``
        returns extra seconds a paced stream window sleeps (injected in
        ``_stream_copy`` / ``_stream_fold``), and ``start(cluster)``
        drives kills/restarts on a wall-clock timeline;
      - discrete-event simulator: ``chunk_factors(src, dst, k, now)``
        returns (extra latency, bandwidth scale) applied per chunk in
        ``net_stream``, and ``apply_to_sim(cluster)`` schedules the
        kills in simulated time.

    Every stochastic draw is a PURE function of (seed, src, dst, k) --
    no shared RNG stream -- so injected noise is deterministic under any
    thread interleaving, and the applied kill/restart sequence is logged
    (``injector.log``) for the deterministic-replay assertion.

  * :class:`FaultToleranceConfig` -- the consolidated timing knobs the
    recovery machinery runs on (stall budget, watermark recheck period,
    default Get/reduce/join timeouts), threaded through ``LocalCluster``
    and the task runtime so chaos tests and benchmarks tighten budgets
    without monkeypatching module constants.
"""

from __future__ import annotations

import dataclasses
import math
import random
import threading
import time
from typing import Callable, List, Optional, Tuple

from repro_torch.core.trace import CAT_FAULT

_MASK = (1 << 64) - 1


def _mix(seed: int, *xs: int) -> int:
    """Deterministic 64-bit hash of (seed, *xs) -- splitmix64-style
    finalizers folded left.  Pure (no RNG state), so concurrent streams
    drawing jitter never perturb each other's sequences."""
    h = (seed * 0x9E3779B97F4A7C15) & _MASK
    for x in xs:
        x = (int(x) & _MASK) * 0xBF58476D1CE4E5B9 & _MASK
        x ^= x >> 31
        h = ((h ^ x) * 0x94D049BB133111EB) & _MASK
        h ^= h >> 29
    return h


def _unit(seed: int, *xs: int) -> float:
    """Uniform [0, 1) draw, pure in (seed, *xs)."""
    return _mix(seed, *xs) / float(1 << 64)


# ---------------------------------------------------------------------------
# timing knobs (fault-tolerance budgets)
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class FaultToleranceConfig:
    """Consolidated recovery/timeout knobs for the threaded data plane.

    ``stall_timeout`` is the *stall budget*: a stream whose source
    watermark has not advanced for this long (while recovery is
    possible -- another copy exists, or the chain can re-splice) is
    treated as :class:`~repro.core.local.SourceStalled` and re-planned.
    ``watermark_recheck_s`` bounds how long a blocked reader sleeps
    before re-checking membership; keep it below the stall budget or
    stalls are detected a whole recheck late.  The ``*_timeout`` fields
    are the default deadlines of ``get``/``reduce``/``allreduce``/
    ``join`` when the caller passes none.

    Comm-transport knobs (``core/comm``): a dropped connection retries
    up to ``connect_retries`` times with capped exponential backoff
    (``connect_backoff_base_s`` doubling up to ``connect_backoff_cap_s``,
    jittered deterministically via the splitmix hash) before the stream
    is treated as stalled and re-planned.  Backends with real endpoints
    ping peers every ``heartbeat_interval_s``; a peer silent for
    ``heartbeat_timeout`` is fed to ``fail_node`` (0 disables the
    monitor).
    """

    stall_timeout: float = 10.0
    watermark_recheck_s: float = 5.0
    get_timeout: float = 30.0
    reduce_timeout: float = 60.0
    join_timeout: float = 30.0
    connect_retries: int = 5
    connect_backoff_base_s: float = 0.05
    connect_backoff_cap_s: float = 1.0
    heartbeat_interval_s: float = 0.2
    heartbeat_timeout: float = 2.0


# ---------------------------------------------------------------------------
# fault plan schema
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class LinkFault:
    """Degrade links: extra per-window/per-chunk latency drawn uniform in
    [0, jitter_s), and a bandwidth multiplier (< 1 slows the link).
    ``src``/``dst`` of None match any endpoint, so one entry can noise
    the whole fabric."""

    src: Optional[int] = None
    dst: Optional[int] = None
    jitter_s: float = 0.0
    bandwidth_factor: float = 1.0

    def matches(self, src: int, dst: int) -> bool:
        return (self.src is None or self.src == src) and (
            self.dst is None or self.dst == dst
        )


@dataclasses.dataclass(frozen=True)
class StragglerSpec:
    """Node-wide multiplicative slowdown over [start, end): every stream
    touching the node (either endpoint) and its simulated compute run
    ``factor`` x slower."""

    node: int
    factor: float = 4.0
    start: float = 0.0
    end: float = math.inf


@dataclasses.dataclass(frozen=True)
class KillSpec:
    """Kill ``node`` at ``at`` seconds (relative to injector start).
    ``slow_for > 0`` makes the kill *flaky* (slow-then-dead): the node
    crawls at ``slow_factor`` x for ``slow_for`` seconds first -- the
    gray-failure shape clean kills never exercise."""

    node: int
    at: float
    slow_for: float = 0.0
    slow_factor: float = 8.0


@dataclasses.dataclass(frozen=True)
class RestartSpec:
    node: int
    at: float


@dataclasses.dataclass(frozen=True)
class JoinSpec:
    """``node`` joins the cluster (``add_node``) at ``at`` seconds --
    elastic-membership churn in the same deterministic-replay schema as
    kills/restarts."""

    node: int
    at: float


@dataclasses.dataclass(frozen=True)
class DrainSpec:
    """``node`` begins a planned drain (``drain_node(deadline=)``) at
    ``at`` seconds: evacuate sole copies, then leave membership."""

    node: int
    at: float
    deadline: float = 10.0


# Draw tags decoupling the comm-fault hash streams from the link-jitter
# draws (both are pure in (seed, src, dst, k); the tag keeps a conn
# fault from reusing a jitter draw at the same coordinates).
_TAG_CONN_DROP = 0xC0D0
_TAG_CONN_DELAY = 0xC0D1
_TAG_CONN_RESET = 0xC0D2


@dataclasses.dataclass(frozen=True)
class ConnFault:
    """Comm-level fault on a link, active over [start, end) of
    plan-relative time -- consumed by the transport layer (both comm
    backends) rather than the window pacing:

      * ``drop``      -- connection attempts fail (backoff + retry);
      * ``reset``     -- an established stream is torn down mid-flight
                         after ``reset_after`` delivered windows (the
                         receiver reconnects and resumes from its
                         watermark);
      * ``delay``     -- connection establishment gains extra latency
                         drawn uniform in [0, ``delay_s``);
      * ``partition`` -- like ``drop`` but matches BOTH directions of
                         the (src, dst) pair.

    ``src``/``dst`` of None match any endpoint; ``p`` applies each
    fault probabilistically per attempt/stream via the pure splitmix
    draw, so campaigns replay identically."""

    kind: str  # "drop" | "reset" | "delay" | "partition"
    src: Optional[int] = None
    dst: Optional[int] = None
    start: float = 0.0
    end: float = math.inf
    delay_s: float = 0.0
    reset_after: int = 1
    p: float = 1.0

    def matches(self, src: int, dst: int) -> bool:
        fwd = (self.src is None or self.src == src) and (
            self.dst is None or self.dst == dst
        )
        if self.kind != "partition":
            return fwd
        rev = (self.src is None or self.src == dst) and (
            self.dst is None or self.dst == src
        )
        return fwd or rev


@dataclasses.dataclass
class FaultPlan:
    """One seeded fault campaign, shared verbatim by both planes."""

    seed: int = 0
    link_faults: List[LinkFault] = dataclasses.field(default_factory=list)
    stragglers: List[StragglerSpec] = dataclasses.field(default_factory=list)
    kills: List[KillSpec] = dataclasses.field(default_factory=list)
    restarts: List[RestartSpec] = dataclasses.field(default_factory=list)
    # Elastic-membership churn: planned joins and drains.
    joins: List[JoinSpec] = dataclasses.field(default_factory=list)
    drains: List[DrainSpec] = dataclasses.field(default_factory=list)
    # Fractional jitter on simulated per-node compute (compute_delay).
    compute_jitter: float = 0.2
    # Comm-level faults: connection drop/reset/delay/partition,
    # consumed by the transport layer on both comm backends.
    conn_faults: List[ConnFault] = dataclasses.field(default_factory=list)

    @classmethod
    def storm(
        cls,
        seed: int,
        num_nodes: int,
        *,
        duration: float = 2.0,
        victims: Optional[List[int]] = None,
        kills: int = 1,
        restart: bool = True,
        flaky: bool = True,
        jitter_s: float = 0.0005,
        bandwidth_factor: float = 1.0,
        straggler_nodes: Tuple[int, ...] = (),
        straggler_factor: float = 4.0,
        join_nodes: Tuple[int, ...] = (),
        drain_nodes: Tuple[int, ...] = (),
        drain_deadline: float = 10.0,
    ) -> "FaultPlan":
        """Derive a random storm from one seed: kill times, flakiness and
        restart delays all come from ``random.Random(seed)``, so equal
        (seed, arguments) produce equal plans -- the deterministic-replay
        contract the chaos tests assert.

        ``join_nodes``/``drain_nodes`` add elastic-membership churn: each
        named node gets a seeded join/drain time.  Their draws come AFTER
        every kill/restart draw, so enabling churn never perturbs the
        kill sequence of an existing seed (and churn-off plans stay
        byte-identical to pre-churn ones)."""
        rng = random.Random(seed)
        victims = list(victims if victims is not None else range(1, num_nodes))
        link_faults = (
            [LinkFault(jitter_s=jitter_s, bandwidth_factor=bandwidth_factor)]
            if jitter_s > 0.0 or bandwidth_factor < 1.0
            else []
        )
        stragglers = [
            StragglerSpec(node=s, factor=straggler_factor) for s in straggler_nodes
        ]
        kill_specs: List[KillSpec] = []
        restart_specs: List[RestartSpec] = []
        pool = list(victims)
        rng.shuffle(pool)
        for node in pool[: max(0, kills)]:
            at = rng.uniform(0.15, 0.6) * duration
            slow_for = (
                rng.uniform(0.1, 0.25) * duration
                if flaky and rng.random() < 0.5
                else 0.0
            )
            kill_specs.append(KillSpec(node=node, at=at, slow_for=slow_for))
            if restart:
                restart_specs.append(
                    RestartSpec(node=node, at=at + slow_for + rng.uniform(0.2, 0.4) * duration)
                )
        # Churn draws AFTER the kill/restart draws (see docstring).
        join_specs = [
            JoinSpec(node=n, at=rng.uniform(0.2, 0.7) * duration)
            for n in join_nodes
        ]
        drain_specs = [
            DrainSpec(node=n, at=rng.uniform(0.2, 0.7) * duration,
                      deadline=drain_deadline)
            for n in drain_nodes
        ]
        return cls(
            seed=seed,
            link_faults=link_faults,
            stragglers=stragglers,
            kills=kill_specs,
            restarts=restart_specs,
            joins=join_specs,
            drains=drain_specs,
        )


# ---------------------------------------------------------------------------
# injector
# ---------------------------------------------------------------------------


class FaultInjector:
    """Executes a :class:`FaultPlan` against either data plane.

    Noise queries (``window_penalty`` / ``chunk_factors`` /
    ``compute_delay``) are pure functions of the plan seed and their
    arguments -- safe from any thread, identical across replays.  Timed
    events (kills, restarts, flaky-kill slowdown windows) are driven by
    ``start(cluster)`` on the threaded plane (wall clock, relative to
    start) or ``apply_to_sim(cluster)`` on the simulator (simulated
    time); each applied event is appended to ``self.log`` as
    ``(planned_at, kind, node)``, giving the deterministic injected-event
    sequence the replay test compares."""

    def __init__(self, plan: Optional[FaultPlan] = None):
        self.plan = plan or FaultPlan()
        self._drain_deadlines = {d.node: d.deadline for d in self.plan.drains}
        # Post-event hooks: called (best-effort, off the replay log) with
        # the node id AFTER a churn event lands -- ``on_join`` right after
        # ``add_node`` returns, ``on_drain`` right after ``drain_node``
        # returns.  Chaos tests use them to stage the joiner's
        # contribution (put + ``splice_contribution``) at the
        # deterministic storm instant without polling membership.  They
        # never touch ``self.log``, so the deterministic-replay contract
        # (log == timeline) is unchanged whether or not hooks are set.
        self.on_join: Optional[Callable[[int], None]] = None
        self.on_drain: Optional[Callable[[int], None]] = None
        # Slowdown windows: static stragglers plus the crawl phase of
        # every flaky kill, all queried through one slow_factor().
        self._windows: List[Tuple[int, float, float, float]] = [
            (s.node, s.factor, s.start, s.end) for s in self.plan.stragglers
        ]
        for ks in self.plan.kills:
            if ks.slow_for > 0.0:
                self._windows.append(
                    (ks.node, ks.slow_factor, ks.at, ks.at + ks.slow_for)
                )
        self.log: List[Tuple[float, str, int]] = []
        self._log_lock = threading.Lock()
        self._t0: Optional[float] = None
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None

    # -- schedule ----------------------------------------------------------

    def timeline(self) -> List[Tuple[float, str, int]]:
        """Sorted (at, kind, node) events: ``slow`` (flaky-kill crawl
        onset), ``kill``, ``restart``, ``join``, ``drain``.  Pure in the
        plan."""
        evs: List[Tuple[float, str, int]] = []
        for ks in self.plan.kills:
            if ks.slow_for > 0.0:
                evs.append((ks.at, "slow", ks.node))
            evs.append((ks.at + ks.slow_for, "kill", ks.node))
        for rs in self.plan.restarts:
            evs.append((rs.at, "restart", rs.node))
        for js in self.plan.joins:
            evs.append((js.at, "join", js.node))
        for ds in self.plan.drains:
            evs.append((ds.at, "drain", ds.node))
        return sorted(evs)

    # -- noise (pure) ------------------------------------------------------

    def _match_link(self, src: int, dst: int) -> Optional[LinkFault]:
        for lf in self.plan.link_faults:
            if lf.matches(src, dst):
                return lf
        return None

    def slow_factor(self, node: int, t: float) -> float:
        """Multiplicative slowdown on ``node`` at plan-relative time ``t``."""
        f = 1.0
        for n, factor, start, end in self._windows:
            if n == node and start <= t < end and factor > f:
                f = factor
        return f

    def elapsed(self) -> float:
        """Plan-relative time on the threaded plane (0 before start())."""
        return 0.0 if self._t0 is None else time.monotonic() - self._t0

    def chunk_factors(self, src: int, dst: int, k: int, now: float = 0.0):
        """(extra_latency_s, bandwidth_scale) for the k-th chunk of a
        src->dst stream at plan-relative time ``now`` -- the simulator's
        consumption of the schema (``net_stream``)."""
        extra_lat = 0.0
        bw = 1.0
        lf = self._match_link(src, dst)
        if lf is not None:
            if lf.jitter_s > 0.0:
                extra_lat = lf.jitter_s * _unit(self.plan.seed, src, dst, k)
            bw = lf.bandwidth_factor
        f = max(self.slow_factor(src, now), self.slow_factor(dst, now))
        if f > 1.0:
            bw /= f
        return extra_lat, bw

    def window_penalty(self, src: int, dst: int, k: int, base_s: float) -> float:
        """Extra seconds the k-th paced window of a src->dst stream
        sleeps -- the threaded plane's consumption of the SAME schema:
        jitter is added outright, bandwidth degradation and straggler
        slowdown stretch the window's base duration."""
        extra_lat, bw = self.chunk_factors(src, dst, k, now=self.elapsed())
        extra = extra_lat
        if bw < 1.0:
            extra += base_s * (1.0 / bw - 1.0)
        return extra

    def connect_fault(self, src: int, dst: int, attempt: int) -> Tuple[bool, float]:
        """(dropped, extra_connect_delay_s) for the ``attempt``-th
        connection try of a dst->src stream open at plan-relative now --
        pure in (seed, src, dst, attempt) given the active windows, so
        replays drop/delay the same attempts.  ``drop`` and
        ``partition`` faults refuse the attempt; ``delay`` faults add
        seeded connect latency."""
        t = self.elapsed()
        dropped = False
        delay = 0.0
        for cf in self.plan.conn_faults:
            if not cf.matches(src, dst) or not (cf.start <= t < cf.end):
                continue
            if cf.kind in ("drop", "partition"):
                if _unit(self.plan.seed, _TAG_CONN_DROP, src, dst, attempt) < cf.p:
                    dropped = True
            elif cf.kind == "delay":
                if _unit(self.plan.seed, _TAG_CONN_DELAY, src, dst, attempt) < cf.p:
                    delay += cf.delay_s * _unit(
                        self.plan.seed, _TAG_CONN_DELAY + 1, src, dst, attempt
                    )
        return dropped, delay

    def reset_window(self, src: int, dst: int, stream_k: int) -> Optional[int]:
        """Window ordinal (1-based) at which the ``stream_k``-th dst->src
        stream is reset mid-flight, or None.  Evaluated once at stream
        open against the plan windows active then; the receiver recovers
        by backoff-reconnect + watermark resume."""
        t = self.elapsed()
        for cf in self.plan.conn_faults:
            if cf.kind != "reset" or not cf.matches(src, dst):
                continue
            if not (cf.start <= t < cf.end):
                continue
            if _unit(self.plan.seed, _TAG_CONN_RESET, src, dst, stream_k) < cf.p:
                return max(1, cf.reset_after)
        return None

    def compute_delay(self, node: int, base_s: float, k: int = 0) -> float:
        """Simulated per-node compute time (e.g. a gradient step): the
        base stretched by the node's slowdown, plus seeded fractional
        jitter -- what makes a straggler's *contribution* late, not just
        its links slow."""
        f = self.slow_factor(node, self.elapsed())
        jitter = base_s * self.plan.compute_jitter * _unit(self.plan.seed, node, node, k)
        return base_s * f + jitter

    # -- timed events (threaded plane) -------------------------------------

    def start(self, cluster) -> "FaultInjector":
        """Begin the wall-clock timeline against a ``LocalCluster``:
        slowdown windows activate relative to now, and a daemon thread
        applies kills/restarts at their planned offsets."""
        if self._t0 is not None:
            return self
        self._t0 = time.monotonic()
        if any(
            kind in ("kill", "restart", "join", "drain")
            for _at, kind, _n in self.timeline()
        ):
            self._thread = threading.Thread(
                target=self._drive, args=(cluster,), daemon=True
            )
            self._thread.start()
        return self

    def stop(self) -> None:
        self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout=5.0)

    def _drive(self, cluster) -> None:
        trace = getattr(cluster, "trace", None)
        for at, kind, node in self.timeline():
            delay = (self._t0 + at) - time.monotonic()
            if delay > 0 and self._stop.wait(delay):
                return
            if self._stop.is_set():
                return
            if kind == "kill":
                cluster.fail_node(node)
            elif kind == "restart":
                cluster.restart_node(node)
            elif kind == "join":
                # Churn events are applied best-effort (e.g. a join of an
                # already-member id is a no-op revive) but ALWAYS logged:
                # the replay contract compares the applied sequence, and
                # an exception must not kill the injector thread mid-storm.
                try:
                    cluster.add_node(node)
                    if self.on_join is not None:
                        self.on_join(node)
                except Exception:  # noqa: BLE001
                    pass
            elif kind == "drain":
                # Drains block on evacuation: run each on its own thread
                # so the storm's later events stay on schedule.
                deadline = self._drain_deadlines.get(node, 10.0)

                def _drain(node=node, deadline=deadline):
                    try:
                        cluster.drain_node(node, deadline=deadline)
                        if self.on_drain is not None:
                            self.on_drain(node)
                    except Exception:  # noqa: BLE001
                        pass

                threading.Thread(target=_drain, daemon=True).start()
            # "slow" needs no action: slowdown windows are time-indexed.
            with self._log_lock:
                self.log.append((round(at, 9), kind, node))
            if trace is not None and trace.enabled:
                trace.instant(CAT_FAULT, kind, node, at=at)

    # -- timed events (simulated plane) -------------------------------------

    def apply_to_sim(self, cluster) -> None:
        """Schedule the plan's kills and membership churn in simulated
        time (call at sim time 0, before running).  Restarts are skipped:
        the simulator models node death but not rejoin.  Joins/drains map
        onto the simulator's ``add_node``/``drain_node`` when it grows
        them (placement-policy modeling); missing hooks are skipped, not
        errors.  Slowdown windows need no scheduling --
        ``chunk_factors`` is queried with ``sim.now``."""
        for at, kind, node in self.timeline():
            if kind == "kill":
                cluster.sim.schedule(at, self._sim_kill, cluster, node, at)
            elif kind == "join" and hasattr(cluster, "add_node"):
                cluster.sim.schedule(at, self._sim_churn, cluster, kind, node, at)
            elif kind == "drain" and hasattr(cluster, "drain_node"):
                cluster.sim.schedule(at, self._sim_churn, cluster, kind, node, at)

    def _sim_kill(self, cluster, node: int, at: float) -> None:
        cluster.fail_node(node)
        with self._log_lock:
            self.log.append((round(at, 9), "kill", node))
        if cluster.trace.enabled:
            cluster.trace.instant(CAT_FAULT, "kill", node, at=at)

    def _sim_churn(self, cluster, kind: str, node: int, at: float) -> None:
        try:
            if kind == "join":
                cluster.add_node(node)
                if self.on_join is not None:
                    self.on_join(node)
            else:
                cluster.drain_node(
                    node, deadline=self._drain_deadlines.get(node, 10.0)
                )
                if self.on_drain is not None:
                    self.on_drain(node)
        except Exception:  # noqa: BLE001 -- best-effort, always logged
            pass
        with self._log_lock:
            self.log.append((round(at, 9), kind, node))
        if cluster.trace.enabled:
            cluster.trace.instant(CAT_FAULT, kind, node, at=at)
