"""Open-loop serving front-end: Poisson arrivals, admission control,
per-replica queues (port of ``repro.serve.router``).

Open loop is the methodology point (OptiReduce-style): arrivals are
generated from a Poisson process *independent of completions*, so queueing
delay and tail latency are observable instead of being absorbed by a
closed loop that only issues a request when the previous one returns.
The router enforces two limits:

  * ``max_outstanding`` -- global admission control; beyond it requests
    are counted ``rejected`` and dropped (load shedding, not queueing);
  * ``replica_queue_depth`` -- a bounded per-replica queue (held by the
    backend's ReplicaHandles); a saturated or dead replica simply drops
    out of a request's fan-out instead of stalling it.

The arrival gaps are drawn on the host from ``np.random.RandomState(seed)``,
the JAX router's generator: for one seed both routers sleep the same
schedule.  It is a host schedule, not device data.
"""

from __future__ import annotations

import dataclasses
import threading
import time
from typing import Callable, List, Optional, Tuple

import numpy as np

from repro_torch.core.trace import CAT_SERVE, NODE_ROUTER, FlightRecorder
from repro_torch.serve.metrics import ServeMetrics


class Rejected(RuntimeError):
    """Request refused by admission control (router or replica queues)."""


class ReplicaQueue:
    """Bounded in-flight counter for one replica."""

    def __init__(self, depth: int):
        self.depth = depth
        self._inflight = 0
        self._lock = threading.Lock()

    def try_acquire(self) -> bool:
        with self._lock:
            if self._inflight >= self.depth:
                return False
            self._inflight += 1
            return True

    def release(self) -> None:
        with self._lock:
            self._inflight = max(0, self._inflight - 1)

    @property
    def inflight(self) -> int:
        return self._inflight


@dataclasses.dataclass
class RouterConfig:
    rate_rps: float = 100.0        # Poisson arrival rate
    max_outstanding: int = 64      # global admission bound
    seed: int = 0


class OpenLoopRouter:
    """Drives a backend (``handle_request(payload) -> value``) open-loop."""

    def __init__(
        self,
        backend,
        config: Optional[RouterConfig] = None,
        metrics: Optional[ServeMetrics] = None,
        trace: Optional[FlightRecorder] = None,
    ):
        self.backend = backend
        self.config = config if config is not None else RouterConfig()
        self.metrics = metrics or ServeMetrics()
        # Optional flight recorder (pass the backing cluster's to get one
        # merged timeline); request events land in the "router" pid lane.
        self.trace = trace if trace is not None else FlightRecorder(enabled=False)
        self._outstanding = 0
        self._lock = threading.Lock()
        self._threads: List[threading.Thread] = []
        self.results: List[Tuple[int, object]] = []  # (request_idx, value)
        self.errors: List[Tuple[int, BaseException]] = []

    # -- single dispatch ----------------------------------------------------

    def dispatch(self, idx: int, payload) -> bool:
        """Admit-and-fire one request on its own thread; returns admitted?"""
        self.metrics.inc("offered")
        with self._lock:
            if self._outstanding >= self.config.max_outstanding:
                self.metrics.inc("rejected")
                if self.trace.enabled:
                    self.trace.instant(
                        CAT_SERVE, "rejected", NODE_ROUTER, f"req-{idx}",
                        outstanding=self._outstanding,
                    )
                return False
            self._outstanding += 1
        self.metrics.inc("admitted")
        t = threading.Thread(target=self._run_one, args=(idx, payload), daemon=True)
        t.start()
        self._threads.append(t)
        # Prune finished request threads so a long-running router does not
        # accumulate one Thread object per request ever served.
        if len(self._threads) > 2 * self.config.max_outstanding:
            self._threads = [th for th in self._threads if th.is_alive()]
        return True

    def _run_one(self, idx: int, payload) -> None:
        t0 = time.perf_counter()
        trace_t0 = self.trace.clock() if self.trace.enabled else None
        try:
            value = self.backend.handle_request(payload)
        except Rejected:
            with self._lock:
                self._outstanding -= 1
            # backend-side admission (replica queues full): not a failure
            self.metrics.inc("admitted", -1)
            self.metrics.inc("rejected")
            if trace_t0 is not None:
                self.trace.instant(
                    CAT_SERVE, "replica-rejected", NODE_ROUTER, f"req-{idx}"
                )
            return
        except BaseException as e:  # noqa: BLE001
            with self._lock:
                self._outstanding -= 1
            self.metrics.inc("failed")
            self.errors.append((idx, e))
            if trace_t0 is not None:
                self.trace.span(
                    CAT_SERVE, "request-failed", NODE_ROUTER,
                    trace_t0, self.trace.clock() - trace_t0, f"req-{idx}",
                    error=type(e).__name__,
                )
            return
        with self._lock:
            self._outstanding -= 1
            self.results.append((idx, value))
        self.metrics.inc("completed")
        self.metrics.record_latency(time.perf_counter() - t0)
        if trace_t0 is not None:
            self.trace.span(
                CAT_SERVE, "request", NODE_ROUTER,
                trace_t0, self.trace.clock() - trace_t0, f"req-{idx}",
            )

    # -- open-loop run ------------------------------------------------------

    def run_open_loop(
        self,
        payloads,
        *,
        on_arrival: Optional[Callable[[int], None]] = None,
        drain_timeout: float = 60.0,
    ) -> ServeMetrics:
        """Fire each payload at its Poisson arrival time, then drain.

        ``on_arrival(idx)`` runs just before request ``idx`` is offered --
        the hook tests use to kill a replica mid-stream.
        """
        rng = np.random.RandomState(self.config.seed)
        start = time.perf_counter()
        next_t = 0.0
        for idx, payload in enumerate(payloads):
            next_t += rng.exponential(1.0 / self.config.rate_rps)
            sleep = start + next_t - time.perf_counter()
            if sleep > 0:
                time.sleep(sleep)  # open loop: never waits on completions
            if on_arrival is not None:
                on_arrival(idx)
            self.dispatch(idx, payload)
        self.drain(drain_timeout)
        return self.metrics

    def drain(self, timeout: float = 60.0) -> None:
        deadline = time.time() + timeout
        for t in self._threads:
            t.join(max(0.0, deadline - time.time()))

    @property
    def outstanding(self) -> int:
        return self._outstanding
