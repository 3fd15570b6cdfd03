"""Versioned weight deployment over the Hoplite broadcast tree (port of
``repro.serve.deploy``).

``publish`` Puts the weight object ONCE onto the cluster's device (the card
unless the runtime was made with ``device="cpu"``), then stages it at every
alive replica with ``runtime.broadcast`` -- concurrent receiver-driven
prefetches that the directory's load-aware source selection organizes
into a pipelined multicast tree (partial-copy relaying, per-node
out-degree caps), so the publisher's node sends the object its out-degree
times, not ``n`` times (paper section 4.3; the paper's 3.3x
ensemble-serving result rides on exactly this path).

Hot swap: the current-version pointer flips only after every alive
replica has a complete staged copy, so in-flight requests keep the
version they captured at admission and new requests see the new weights
-- mid-traffic deployment never mixes versions inside one request.
"""

from __future__ import annotations

import itertools
import threading
from typing import Dict, List, Optional, Tuple


class WeightDeployment:
    """Versioned weight objects for one ensemble."""

    def __init__(self, runtime, replicas, *, keep_versions: int = 2):
        self.runtime = runtime
        self.replicas = replicas  # list of ReplicaHandle (shared, live view)
        self.keep_versions = keep_versions
        self._versions: Dict[int, object] = {}  # version -> weights ObjectRef
        self._active: Dict[int, int] = {}       # version -> in-flight requests
        self._retired: Dict[int, object] = {}   # GC'd versions pinned by requests
        self._current: Optional[int] = None
        self._counter = itertools.count(1)
        self._lock = threading.Lock()

    # -- queries -------------------------------------------------------------

    def current(self) -> Tuple[Optional[int], Optional[object]]:
        with self._lock:
            if self._current is None:
                return None, None
            return self._current, self._versions[self._current]

    def acquire(self) -> Tuple[Optional[int], Optional[object]]:
        """Capture the current version for one request.  The version's
        weight object is protected from GC until :meth:`release`, so a
        publish storm mid-request cannot delete weights the request
        captured at admission."""
        with self._lock:
            if self._current is None:
                return None, None
            self._active[self._current] = self._active.get(self._current, 0) + 1
            return self._current, self._versions[self._current]

    def release(self, version: Optional[int]) -> None:
        if version is None:
            return
        drop = None
        with self._lock:
            n = self._active.get(version, 0) - 1
            if n > 0:
                self._active[version] = n
            else:
                self._active.pop(version, None)
                drop = self._retired.pop(version, None)
        if drop is not None:
            self.runtime.delete([drop])

    def version_ref(self, version: int):
        with self._lock:
            return self._versions.get(version)

    def versions(self) -> List[int]:
        with self._lock:
            return sorted(self._versions)

    def held_refs(self) -> List[object]:
        """Every weight object still held: the kept versions and the retired
        ones that in-flight requests pin."""
        with self._lock:
            return list(self._versions.values()) + list(self._retired.values())

    # -- deployment ----------------------------------------------------------

    def publish(
        self,
        weights,
        *,
        source_node: Optional[int] = None,
        prefetch: bool = True,
        timeout: float = 60.0,
    ) -> int:
        """Put the weight object once (a tensor, or anything ``np.asarray``
        takes, copied onto the cluster's device), fan it to all alive
        replicas through the adaptive broadcast tree (``runtime.broadcast``:
        no staging tasks -- bytes land directly in each replica's store),
        then atomically flip the current-version pointer (hot swap)."""
        version = next(self._counter)
        ref = self.runtime.put(weights, node=source_node)  # api.as_tensor onto the cluster's device
        if prefetch:
            self.runtime.broadcast(
                ref,
                [r.node for r in self.replicas if r.alive],
                timeout=timeout,
            )
        with self._lock:
            self._versions[version] = ref
            self._current = version
            stale = sorted(self._versions)[: -self.keep_versions]
            dropped = []
            for v in stale:
                vref = self._versions.pop(v)
                if self._active.get(v, 0) > 0:
                    self._retired[v] = vref  # in use: deleted on last release
                else:
                    dropped.append(vref)
        if dropped:
            self.runtime.delete(dropped)  # tombstoned: late fetches abort cleanly
        return version
