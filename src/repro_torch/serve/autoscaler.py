"""Queue-driven ensemble autoscaler (port of ``repro.serve.autoscaler``).

Scales the :class:`~repro_torch.serve.ensemble.EnsembleGroup` replica set off
the router's admission signals -- per-replica queue depth and the
rejection counter -- in the HopperKV admission-control style:
pressure is measured where requests are *shed*, not where they succeed.

Policy (deliberately simple and fully deterministic given the signal
stream):

  * **Scale up** when mean in-flight per alive replica exceeds
    ``scale_up_queue_depth`` OR the rejection counter grew by more than
    ``scale_up_rejection_rate`` since the last tick.  A scale-up joins a
    fresh runtime node (``Runtime.add_node``) and adds a replica on it;
    the current weight version is staged to the joiner through the
    receiver-driven broadcast tree (``EnsembleGroup.add_replica``), so
    the new replica serves its first request from a warm local copy.
  * **Scale down** when pressure has stayed below
    ``scale_down_queue_depth`` with zero new rejections for a full
    ``hysteresis_s`` window.  A scale-down retires the least-loaded
    *autoscaled* replica (never a seed replica, never below
    ``max(min_replicas, quorum)``): new requests stop routing to it,
    in-flight tasks finish and free their queue slots, and the hosting
    node is then drained (``Runtime.drain_node`` -- zero object loss)
    out of membership.
  * **Hysteresis** both ways: at most one action per ``hysteresis_s``,
    and scale-down additionally requires the full low-pressure dwell --
    a spike's trailing edge never triggers an immediate give-back that
    the next burst would have to re-pay.

``tick()`` is synchronous and side-effect-complete (benchmarks and tests
drive it directly with an injectable clock); ``start()``/``stop()`` wrap
it in a background thread for long-running deployments.  Every action is
appended to ``self.actions`` as ``(t, action, node, replica_id)`` -- the
deterministic churn log the elasticity benchmark records.
"""

from __future__ import annotations

import dataclasses
import threading
import time
from typing import Callable, List, Optional, Tuple

from repro_torch.serve.metrics import ServeMetrics


@dataclasses.dataclass
class AutoscalerConfig:
    min_replicas: int = 2
    max_replicas: int = 8
    # Pressure thresholds: mean in-flight tasks per alive replica.
    scale_up_queue_depth: float = 2.0
    scale_down_queue_depth: float = 0.5
    # Rejections since the previous tick that force a scale-up even when
    # queue depths look calm (shed load never shows up as queued load).
    scale_up_rejection_rate: int = 1
    # Minimum seconds between actions, and the low-pressure dwell a
    # scale-down must observe.
    hysteresis_s: float = 1.0
    check_interval_s: float = 0.25
    # Deadline handed to Runtime.drain_node on scale-down.
    drain_deadline_s: float = 10.0
    # Bound on waiting for a retired replica's in-flight tasks to finish
    # before draining its node.
    retire_wait_s: float = 10.0


class QueueAutoscaler:
    """Grow/shrink an EnsembleGroup off router queue/rejection pressure."""

    def __init__(
        self,
        runtime,
        group,
        metrics: Optional[ServeMetrics] = None,
        config: Optional[AutoscalerConfig] = None,
        clock: Callable[[], float] = time.monotonic,
    ):
        self.runtime = runtime
        self.group = group
        self.metrics = metrics if metrics is not None else getattr(
            group, "metrics", ServeMetrics()
        )
        self.config = config or AutoscalerConfig()
        self.clock = clock
        # Floor: never shrink below the quorum the group needs to admit
        # anything at all.
        self._floor = max(self.config.min_replicas, group.config.quorum)
        # Replica ids this autoscaler added; only these are give-backs.
        self._autoscaled: List[int] = []
        self.actions: List[Tuple[float, str, int, int]] = []
        self._last_action_t: Optional[float] = None
        self._below_since: Optional[float] = None
        self._last_rejected = int(self.metrics.get("rejected"))
        self._lock = threading.Lock()
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None

    # -- signals -------------------------------------------------------------

    def pressure(self) -> Tuple[float, int]:
        """(mean in-flight per alive replica, rejections since last tick)."""
        alive = self.group.alive_replicas()
        depth = (
            sum(r.queue.inflight for r in alive) / len(alive) if alive else 0.0
        )
        rejected = int(self.metrics.get("rejected"))
        delta = rejected - self._last_rejected
        self._last_rejected = rejected
        return depth, delta

    def replica_count(self) -> int:
        return len(self.group.alive_replicas())

    # -- policy --------------------------------------------------------------

    def tick(self) -> Optional[str]:
        """Evaluate the policy once; returns "scale-up"/"scale-down"/None."""
        with self._lock:
            now = self.clock()
            cfg = self.config
            depth, rejected_delta = self.pressure()
            n = self.replica_count()

            hot = depth > cfg.scale_up_queue_depth or (
                rejected_delta >= cfg.scale_up_rejection_rate
            )
            cold = depth < cfg.scale_down_queue_depth and rejected_delta == 0

            # Low-pressure dwell tracking (scale-down hysteresis).
            if cold:
                if self._below_since is None:
                    self._below_since = now
            else:
                self._below_since = None

            in_cooldown = (
                self._last_action_t is not None
                and now - self._last_action_t < cfg.hysteresis_s
            )
            if in_cooldown:
                return None

            if hot and n < cfg.max_replicas:
                self._scale_up(now)
                return "scale-up"
            if (
                cold
                and self._autoscaled
                and n > self._floor
                and self._below_since is not None
                and now - self._below_since >= cfg.hysteresis_s
            ):
                self._scale_down(now)
                return "scale-down"
            return None

    def _scale_up(self, now: float) -> None:
        node = self.runtime.add_node()
        handle = self.group.add_replica(node)
        self._autoscaled.append(handle.replica_id)
        self._last_action_t = now
        self.actions.append((round(now, 6), "scale-up", node, handle.replica_id))

    def _scale_down(self, now: float) -> None:
        # Least-loaded autoscaled replica gives back first (ties by id,
        # newest first, for a deterministic action log).
        alive = {r.replica_id: r for r in self.group.alive_replicas()}
        candidates = sorted(
            (rid for rid in self._autoscaled if rid in alive),
            key=lambda rid: (alive[rid].queue.inflight, -rid),
        )
        if not candidates:
            return
        rid = candidates[0]
        handle = self.group.retire_replica(rid)
        if handle is None:
            return
        self._autoscaled.remove(rid)
        # In-flight tasks finish and free their slots before the node
        # leaves (late completions land on a still-member node).
        deadline = time.time() + self.config.retire_wait_s
        while handle.queue.inflight > 0 and time.time() < deadline:
            time.sleep(0.01)
        try:
            self.runtime.drain_node(
                handle.node, deadline=self.config.drain_deadline_s
            )
        except Exception:  # noqa: BLE001 -- node may host other replicas' peers
            pass
        self._last_action_t = now
        self.actions.append((round(now, 6), "scale-down", handle.node, rid))

    # -- background loop -----------------------------------------------------

    def start(self) -> "QueueAutoscaler":
        if self._thread is not None:
            return self
        self._stop.clear()

        def loop():
            while not self._stop.wait(self.config.check_interval_s):
                try:
                    self.tick()
                except Exception:  # noqa: BLE001 -- policy errors never kill serving
                    pass

        self._thread = threading.Thread(target=loop, daemon=True)
        self._thread.start()
        return self

    def stop(self) -> None:
        self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout=5.0)
            self._thread = None
