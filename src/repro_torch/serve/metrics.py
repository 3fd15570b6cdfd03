"""Serving telemetry shared by the threaded cluster and the simulator (port
of ``repro.serve.metrics``).

Pure-python, clock-agnostic: callers supply latencies in seconds (wall
time for the threaded stack, simulated time for the discrete-event
scenario in ``core/simulation.py``), so one summary format covers both.
Open-loop methodology: the *offered* counter advances on every generated
arrival whether or not the request is admitted, so rejection shows up as
``offered - admitted`` rather than silently slowing the arrival process.
"""

from __future__ import annotations

import collections
import threading
from typing import Dict, List, Optional, Sequence

# The serving latency recorder is the shared core histogram: exact
# percentiles below ``exact_limit`` samples, geometric buckets past it, and
# every read takes the lock.
from repro_torch.core.trace import LatencyHistogram

__all__ = ["LatencyHistogram", "ServeMetrics"]


class ServeMetrics:
    """Counters + latency histogram + per-replica and per-node accounting."""

    COUNTERS = ("offered", "admitted", "rejected", "completed", "failed")

    def __init__(self):
        self._lock = threading.Lock()
        self._counters: Dict[str, int] = collections.defaultdict(int)
        self.latency = LatencyHistogram()
        self.per_replica: Dict[int, int] = collections.defaultdict(int)
        self._bytes_baseline: Optional[List[int]] = None

    # -- counters ------------------------------------------------------------

    def inc(self, name: str, n: int = 1) -> None:
        with self._lock:
            self._counters[name] += n

    def get(self, name: str) -> int:
        with self._lock:
            return self._counters[name]

    def record_latency(self, seconds: float) -> None:
        self.latency.record(seconds)

    def replica_completed(self, replica_id: int) -> None:
        with self._lock:
            self.per_replica[replica_id] += 1

    # -- per-node bytes moved -------------------------------------------------

    def capture_bytes(self, bytes_sent_per_node: Sequence[int]) -> None:
        """Snapshot a cluster's per-node egress counters
        (``LocalCluster.bytes_sent_per_node``) as the baseline."""
        with self._lock:
            self._bytes_baseline = list(bytes_sent_per_node)

    def bytes_moved(self, bytes_sent_per_node: Sequence[int]) -> List[int]:
        """Per-node bytes sent since :meth:`capture_bytes` (or since ever)."""
        with self._lock:
            base = self._bytes_baseline or [0] * len(bytes_sent_per_node)
        return [int(b) - int(a) for b, a in zip(bytes_sent_per_node, base)]

    # -- reporting ------------------------------------------------------------

    def snapshot(self) -> Dict:
        with self._lock:
            counters = dict(self._counters)
            per_replica = dict(self.per_replica)
        out = {name: counters.get(name, 0) for name in self.COUNTERS}
        out["latency"] = self.latency.summary()
        out["per_replica"] = per_replica
        return out
