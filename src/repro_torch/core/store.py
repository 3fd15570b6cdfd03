"""Per-node object store (paper sections 3-4); port of ``repro.core.store``.

Each node buffers a set of application objects as chunked byte buffers.
Objects created locally via Put are *pinned* until Delete (paper section 7:
"the object copy that is created will be pinned in its local store until
the framework calls Delete").  Copies pulled from remote nodes are
unpinned and evictable under a local LRU policy.

The store tracks per-object progress (bytes received) so a partial copy
can serve as an upstream sender without ever forwarding bytes it does not
yet hold (pipelining, section 4.2).

In the port a buffer is a ``torch.uint8`` tensor on the store's device (the
card, or the CPU when the caller asks for it).  Device writes are enqueued
on the device's one default stream before the watermark advances, so a
reader that has seen a watermark enqueues its read after the write; a host
read of device bytes (``to_bytes``, ``torch.equal``) synchronises with it.

Concurrency model (see README "Data-plane concurrency model"): every
``ChunkedBuffer`` owns its *own* lock and condition variable -- the
per-buffer progress watermark.  Writers advance ``bytes_present`` and
signal only that buffer's waiters; readers block in ``wait_for_bytes``.
Disjoint transfers therefore never share a lock on the chunk hot path.
``NodeStore`` itself is a control-plane structure: it is only ever
mutated under the cluster's directory lock, and holds no lock of its own.
A buffer lock is never held across a directory or store call (lock
ordering: directory lock > buffer lock, buffer lock innermost).
"""

from __future__ import annotations

import collections
import threading
import time
from typing import Dict, Optional

import numpy as np
import torch

from repro_torch.core.api import DEFAULT_CHUNK_SIZE, ObjectAlreadyExists
from repro_torch.core.trace import CAT_STREAM, SPAN_WAKE


class DataPlaneStats:
    """Contention counters for the threaded data plane.

    Most are incremented without a dedicated lock (each increment happens
    under *some* buffer/directory lock, but different buffers race): those
    counts are monitoring-grade approximations, good to well under 1%.
    ``windows``, the hand-off timers below and the seconds dicts are exact:
    summed under the stats' own lock (``dir_lock_wait_seconds`` under the
    directory lock itself).  They feed the benchmark's per-layer metrics
    (``hoplite_bench/metrics/``), not correctness decisions.

      * ``wakeups``          -- returns from a blocked data-plane wait
      * ``notifies``         -- watermark signals that had >= 1 waiter
      * ``windows``          -- drained transfer windows (lock acquisitions
        per streamed buffer; chunks/window >> 1 means the drain is working)

    The data plane's hand-offs, timed always (the port's own; the trace's
    ``wake``, ``window`` and ``dir-lock`` spans cover the same intervals):

      * ``woken``                -- waits that returned because a writer
        signalled them (``wakeups`` also counts timeouts)
      * ``wake_lag_seconds``     -- summed over those, the time from the
        first watermark advance that could release the waiter to its
        return: re-taking the buffer's lock, the GIL and the scheduler
      * ``window_issue_seconds`` -- summed over ``windows``, the time from
        holding every input's watermark to the window's own advance: the
        checks, the copy or fold launches, ``write_chunk``
      * ``dir_lock_wait_seconds`` -- time spent blocked on a contended
        directory lock (uncontended acquisitions are not timed)

    Plus per-node serving accounting for the adaptive broadcast tree:

      * ``bytes_served``  -- node -> bytes streamed OUT of that node's
        store (copy and reduce-hop traffic); the broadcast benchmark
        asserts the origin serves O(out-degree) copies, not O(N)
      * ``peak_outbound`` -- node -> max concurrent outbound transfers
        observed (must stay within the broadcast policy's out-degree cap)

    And for the pipelined reduce plane:

      * ``bytes_reduced`` -- node -> bytes that went through a streaming
        reduction op AT that node (hop folds + chain finalization); the
        allreduce benchmark asserts the 2-D plan spreads these evenly
      * ``reduce_hops``   -- node -> streaming reduction executions at
        that node (asserted <= ceil(n/sqrt(n)) per node in the 2-D plan)
      * ``resplices``     -- mid-chain failure recoveries that resumed a
        reduce from the predecessor watermark instead of restarting
      * ``splices_join``  -- member-change re-splices that admitted a
        joiner's contribution into an in-flight reduce chain
      * ``splices_drain`` -- member-change re-splices that handed a
        draining node's chain position (its producing partial) to a
        successor instead of dropping the contribution

    And the comm transport (``core/comm``):

      * ``comm_reconnects``   -- streams that lost their connection
        mid-flight and resumed from the receiver watermark after a
        successful backoff-reconnect
      * ``connect_retries``   -- individual connection attempts that
        failed and were retried with backoff
      * ``heartbeat_misses``  -- silent peers detected by the heartbeat
        monitor and fed to ``fail_node`` (matches the ``heartbeat-miss``
        trace instants exactly)

    And critical-path attribution (fed by ``core/trace.StageClock``):

      * ``stage_seconds`` -- stage name -> seconds summed across all
        traced operations; each operation partitions its own wall time
        into the stages of ``core/trace.STAGES`` (``producer-wait``,
        ``cap-blocked``, ``streaming``, ``replan``, ``resplice``,
        ``plan``), so for a single operation the stage sum ~= its
        wall-clock and across concurrent operations it sums their
        individual critical paths.
      * ``task_seconds`` -- the port's own: ``Runtime`` tasks' stages
        (``core/trace.TASK_STAGES``: queued for a slot, argument Gets, the
        function, the result's Put) summed over tasks, apart from
        ``stage_seconds`` so that the data plane's stages read the same
        with tasks on top.

    And the reduce op's calls, exact (counted under the cluster's stats
    lock):

      * ``fold_ops`` -- applications of a reduction op: ``k - 1`` for each
        window of a fold over ``k`` inputs, one for each lineage rebuild.
        A SUM of f32, bf16 or f16 on the card launches ``chunk_reduce``
        once for each.
    """

    __slots__ = (
        "wakeups",
        "notifies",
        "windows",
        "resplices",
        "splices_join",
        "splices_drain",
        "stall_replans",
        "straggler_cuts",
        "dropped_contributions",
        "joins",
        "drains",
        "evacuated_objects",
        "comm_reconnects",
        "connect_retries",
        "heartbeat_misses",
        "bytes_served",
        "peak_outbound",
        "bytes_reduced",
        "reduce_hops",
        "stage_seconds",
        "fold_ops",
        "woken",
        "wake_lag_seconds",
        "window_issue_seconds",
        "dir_lock_wait_seconds",
        "task_seconds",
        "_lock",
    )

    _FIELDS = tuple(k for k in __slots__ if k != "_lock")

    _DICT_FIELDS = (
        "bytes_served",
        "peak_outbound",
        "bytes_reduced",
        "reduce_hops",
        "stage_seconds",
        "task_seconds",
    )

    def __init__(self):
        self.wakeups = 0
        self.notifies = 0
        self.windows = 0
        self.resplices = 0
        self.splices_join = 0
        self.splices_drain = 0
        self.stall_replans = 0
        self.straggler_cuts = 0
        self.dropped_contributions = 0
        self.joins = 0
        self.drains = 0
        self.evacuated_objects = 0
        self.comm_reconnects = 0
        self.connect_retries = 0
        self.heartbeat_misses = 0
        self.bytes_served: Dict[int, int] = {}
        self.peak_outbound: Dict[int, int] = {}
        self.bytes_reduced: Dict[int, int] = {}
        self.reduce_hops: Dict[int, int] = {}
        self.stage_seconds: Dict[str, float] = {}
        self.fold_ops = 0
        self.woken = 0
        self.wake_lag_seconds = 0.0
        self.window_issue_seconds = 0.0
        self.dir_lock_wait_seconds = 0.0
        self.task_seconds: Dict[str, float] = {}
        self._lock = threading.Lock()

    def note_bytes_served(self, node: int, nbytes: int) -> None:
        self.bytes_served[node] = self.bytes_served.get(node, 0) + nbytes

    def note_outbound(self, node: int, concurrent: int) -> None:
        if concurrent > self.peak_outbound.get(node, 0):
            self.peak_outbound[node] = concurrent

    def note_bytes_reduced(self, node: int, nbytes: int) -> None:
        self.bytes_reduced[node] = self.bytes_reduced.get(node, 0) + nbytes

    def note_reduce_hop(self, node: int) -> None:
        self.reduce_hops[node] = self.reduce_hops.get(node, 0) + 1

    def note_seconds(self, field: str, key: str, seconds: float) -> None:
        """Add ``seconds`` under ``key`` of the dict ``field``
        (``stage_seconds``, ``task_seconds``)."""
        with self._lock:
            d = getattr(self, field)
            d[key] = d.get(key, 0.0) + seconds

    def note_stage(self, stage: str, seconds: float) -> None:
        self.note_seconds("stage_seconds", stage, seconds)

    def note_wake(self, lag: float) -> None:
        with self._lock:
            self.woken += 1
            self.wake_lag_seconds += lag

    def note_window(self, issue: float) -> None:
        with self._lock:
            self.windows += 1
            self.window_issue_seconds += issue

    def as_dict(self) -> Dict[str, object]:
        out = {k: getattr(self, k) for k in self._FIELDS if k not in self._DICT_FIELDS}
        for k in self._DICT_FIELDS:
            out[k] = dict(getattr(self, k))
        return out

    def snapshot(self) -> Dict[str, object]:
        """Alias of :meth:`as_dict` -- a deep-enough copy of the current
        counters (dict fields are copied) safe to keep across a reset."""
        return self.as_dict()

    def reset(self) -> None:
        """Zero every counter in place (the object stays shared with the
        buffers/cluster that hold a reference to it).  Benchmark harnesses
        call this between scenarios so per-scenario counter deltas don't
        bleed across a cluster's lifetime."""
        with self._lock:
            for k in self._FIELDS:
                if k in self._DICT_FIELDS:
                    getattr(self, k).clear()
                else:
                    setattr(self, k, 0.0 if k.endswith("_seconds") else 0)


def copy_bytes(dst: torch.Tensor, src: torch.Tensor) -> None:
    """``dst.copy_(src)`` for a window of the data plane.  Between two host
    tensors the bytes move as one serial memcpy on the calling thread: each
    transfer has a thread of its own, and torch's copy of a byte window past
    its grain size fans out to the intra-op pool, whose threads a loaded
    host schedules late (the receivers of a fused allreduce then fell a
    whole object behind the root they chase)."""
    if dst.device.type == "cpu" and src.device.type == "cpu":
        np.copyto(dst.view(torch.uint8).numpy(), src.view(torch.uint8).numpy())
    else:
        dst.copy_(src)


def zero_bytes(size: int, device: torch.device) -> torch.Tensor:
    """``size`` zero bytes on ``device``; on the host filled on the calling
    thread, not on the intra-op pool (see ``copy_bytes``)."""
    if torch.device(device).type == "cpu":
        out = torch.empty(size, dtype=torch.uint8)
        out.numpy().fill(0)
        return out
    return torch.zeros(size, dtype=torch.uint8, device=device)


class _Waiter:
    """A reader blocked in ``wait_for_bytes``: the watermark it waits for,
    and when an advance or a failure first met it."""

    __slots__ = ("hi", "released_at")

    def __init__(self, hi: int):
        self.hi = hi
        self.released_at: Optional[float] = None


class BufferFailed(RuntimeError):
    """The node holding this buffer died while a reader was gated on it."""


class ChunkedBuffer:
    """A byte buffer assembled chunk-by-chunk.

    Backed by a ``torch.uint8`` tensor on ``device``.  ``bytes_present`` advances monotonically
    (chunks arrive in order within one transfer, which is how TCP -- and our
    chunk pipeline -- deliver them).

    The buffer is its own synchronization domain: ``write_chunk`` advances
    the watermark under the buffer's private condition and wakes only this
    buffer's waiters; ``wait_for_bytes`` blocks readers on the watermark.
    Bytes below the watermark are immutable, so readers may take zero-copy
    views of ``data[:bytes_present]`` without holding the lock.

    ``first_window_at`` and ``last_window_at`` record when the watermark
    first left 0 and when it reached ``size`` (``time.perf_counter``; None
    until then, both the creation time for a buffer made complete): whether
    a receiver held bytes before its source was whole is read from them,
    not from a poll.

    A waiter released by a writer's signal times its wake-up: from the
    first advance (or failure) that met its watermark, stamped under the
    condition before ``notify_all``, to its own return.  The lag goes to
    ``stats`` (``woken``, ``wake_lag_seconds``) and, with ``trace`` on, to a
    ``wake`` span on ``node``'s lane under ``object_id``.
    """

    def __init__(
        self,
        size: int,
        chunk_size: int = DEFAULT_CHUNK_SIZE,
        stats: Optional[DataPlaneStats] = None,
        *,
        device: torch.device,
        trace=None,
        object_id: Optional[str] = None,
        node: Optional[int] = None,
    ):
        self.size = size
        self.chunk_size = chunk_size
        self.data = zero_bytes(size, device)
        self.bytes_present = 0
        self.first_window_at: Optional[float] = None
        self.last_window_at: Optional[float] = None
        self.failed = False
        self.stats = stats
        self.trace = trace
        self.object_id = object_id
        self.node = node
        self._cond = threading.Condition(threading.Lock())
        self._waiting: list = []  # _Waiter of each blocked reader

    @classmethod
    def from_bytes(cls, payload: bytes, chunk_size: int = DEFAULT_CHUNK_SIZE, *,
                   device: torch.device) -> "ChunkedBuffer":
        buf = cls(len(payload), chunk_size, device=device)
        if payload:
            copy_bytes(buf.data, torch.frombuffer(bytearray(payload), dtype=torch.uint8))
        buf._made_complete()
        return buf

    @classmethod
    def from_array(
        cls,
        arr: torch.Tensor,
        chunk_size: int = DEFAULT_CHUNK_SIZE,
        stats: Optional[DataPlaneStats] = None,
        *,
        device: Optional[torch.device] = None,
    ) -> "ChunkedBuffer":
        """A complete buffer holding ``arr``'s bytes, on ``device`` (default:
        ``arr``'s)."""
        flat = arr.contiguous().reshape(-1)
        raw = flat.view(torch.uint8) if flat.numel() else flat.new_empty(0, dtype=torch.uint8)
        buf = cls(raw.numel(), chunk_size, stats=stats,
                  device=arr.device if device is None else device)
        copy_bytes(buf.data, raw)
        buf._made_complete()
        return buf

    def _made_complete(self) -> None:
        self.bytes_present = self.size
        self.first_window_at = self.last_window_at = time.perf_counter()

    @property
    def complete(self) -> bool:
        return self.bytes_present >= self.size

    def num_chunks(self) -> int:
        return max(1, -(-self.size // self.chunk_size))

    # -- watermark protocol --------------------------------------------------

    @property
    def device(self) -> torch.device:
        return self.data.device

    def write_chunk(self, offset: int, payload: Optional[torch.Tensor], end: Optional[int] = None) -> None:
        """Write bytes at ``offset`` and advance the watermark, signalling
        only THIS buffer's waiters (never a cluster-global wakeup).

        ``payload=None`` with ``end`` advances the watermark over bytes the
        caller already wrote in place above it (a reduce hop folds a window
        straight into its output: no reader looks above the watermark)."""
        end = offset + payload.numel() if payload is not None else end
        with self._cond:
            if payload is not None:
                copy_bytes(self.data[offset:end], payload)
            if end > self.bytes_present:
                now = time.perf_counter()
                if self.first_window_at is None:
                    self.first_window_at = now
                if end >= self.size:
                    self.last_window_at = now
                self.bytes_present = end
                for w in self._waiting:
                    if w.released_at is None and end >= w.hi:
                        w.released_at = now
            if self._waiting:
                if self.stats is not None:
                    self.stats.notifies += 1
                self._cond.notify_all()

    def wait_for_bytes(self, hi: int, timeout: Optional[float] = None) -> int:
        """Block until ``bytes_present >= hi`` (or the buffer fails, or
        ``timeout`` elapses).  Returns the watermark snapshot; the caller
        may read ``data[:snapshot]`` zero-copy afterwards -- that region
        is immutable."""
        with self._cond:
            if self.bytes_present >= hi or self.failed:
                return self.bytes_present
            w = _Waiter(hi)
            self._waiting.append(w)
            try:
                while True:
                    signaled = self._cond.wait(timeout)
                    if self.stats is not None:
                        self.stats.wakeups += 1
                    if not signaled:
                        break
                    if w.released_at is not None:
                        self._note_wake(w.released_at)
                        break
            finally:
                self._waiting.remove(w)
            return self.bytes_present

    def _note_wake(self, released_at: float) -> None:
        now = time.perf_counter()
        if self.stats is not None:
            self.stats.note_wake(now - released_at)
        if self.trace is not None and self.trace.enabled:
            self.trace.span(CAT_STREAM, SPAN_WAKE, self.node, released_at, now - released_at, self.object_id)

    def fail(self) -> None:
        """Node death: wake every reader gated on this buffer so it can
        fail over to another source instead of riding a timeout."""
        with self._cond:
            self.failed = True
            if self._waiting:
                now = time.perf_counter()
                for w in self._waiting:
                    if w.released_at is None:
                        w.released_at = now
                self._cond.notify_all()

    # -- reads ---------------------------------------------------------------

    def view(self, lo: int, hi: int) -> torch.Tensor:
        """Zero-copy view of ``data[lo:hi]``.  Only valid below a watermark
        snapshot the caller obtained from ``wait_for_bytes``."""
        return self.data[lo:hi]

    def read_chunk(self, index: int) -> torch.Tensor:
        lo = index * self.chunk_size
        hi = min(self.size, lo + self.chunk_size)
        assert hi <= self.bytes_present, "pipelining invariant violated"
        return self.data[lo:hi]

    def available_chunks(self) -> int:
        if self.complete:
            return self.num_chunks()
        return self.bytes_present // self.chunk_size

    def to_array(self, dtype: torch.dtype, shape) -> torch.Tensor:
        """The object as a tensor of ``dtype`` and ``shape``: a view of the buffer."""
        assert self.complete
        return self.data.view(dtype).reshape(shape)

    def to_bytes(self) -> bytes:
        assert self.complete
        return self.data.cpu().numpy().tobytes()


class NodeStore:
    """Object store for a single node.

    Not internally locked: all map mutations happen under the owning
    cluster's directory lock (control plane).  Byte traffic goes through
    the per-buffer watermarks above (data plane)."""

    def __init__(
        self,
        node_id: int,
        capacity_bytes: Optional[int] = None,
        stats: Optional[DataPlaneStats] = None,
        *,
        device: torch.device,
        trace=None,
    ):
        self.node_id = node_id
        self.capacity_bytes = capacity_bytes
        self.stats = stats
        self.device = device
        self.trace = trace  # the cluster's FlightRecorder, for ``wake`` spans
        self.objects: Dict[str, ChunkedBuffer] = {}
        self.pinned: set = set()
        self._lru = collections.OrderedDict()  # unpinned object id -> size
        self._used_bytes = 0  # O(1) maintained; see used_bytes

    # -- accounting ---------------------------------------------------------

    @property
    def used_bytes(self) -> int:
        """O(1) maintained byte count (invariant: equals
        ``recompute_used_bytes()``; asserted in tests/test_store_eviction)."""
        return self._used_bytes

    def recompute_used_bytes(self) -> int:
        """O(n) ground truth for the ``used_bytes`` counter invariant."""
        return sum(b.size for b in self.objects.values())

    def _touch(self, object_id: str) -> None:
        if object_id in self._lru:
            self._lru.move_to_end(object_id)

    def _maybe_evict(self, incoming: int) -> None:
        """Local LRU over unpinned copies (paper section 7: 'Hoplite is free
        to evict any additional copies ... local LRU policy per node').

        Pinned copies are never candidates (they are not in ``_lru``), and
        neither are *incomplete* unpinned copies: those are the destinations
        of in-flight transfers, and evicting one would detach the buffer the
        sender is still streaming into, leaving the directory advertising a
        copy the store no longer holds."""
        if self.capacity_bytes is None:
            return
        skipped = []
        while self._used_bytes + incoming > self.capacity_bytes and self._lru:
            victim, vsize = self._lru.popitem(last=False)
            buf = self.objects.get(victim)
            if buf is None:
                continue  # stale LRU entry; nothing held
            if not buf.complete:
                skipped.append((victim, vsize))
                continue
            self.objects.pop(victim, None)
            self._used_bytes -= buf.size
        # Re-install skipped in-flight entries at the cold end, original order.
        for victim, vsize in reversed(skipped):
            self._lru[victim] = vsize
            self._lru.move_to_end(victim, last=False)

    # -- creation -----------------------------------------------------------

    def create(self, object_id: str, size: int, *, pinned: bool, chunk_size: int = DEFAULT_CHUNK_SIZE) -> ChunkedBuffer:
        if object_id in self.objects:
            existing = self.objects[object_id]
            if existing.size != size:
                raise ObjectAlreadyExists(object_id)
            if pinned and object_id not in self.pinned:
                # Pin upgrade: an evictable copy becomes the pinned one.
                self.pinned.add(object_id)
                self._lru.pop(object_id, None)
            return existing
        self._maybe_evict(size)
        buf = ChunkedBuffer(size, chunk_size, stats=self.stats, device=self.device, trace=self.trace,
                            object_id=object_id, node=self.node_id)
        self.objects[object_id] = buf
        self._used_bytes += size
        if pinned:
            self.pinned.add(object_id)
        else:
            self._lru[object_id] = size
        return buf

    def put_array(self, object_id: str, arr: torch.Tensor, chunk_size: int = DEFAULT_CHUNK_SIZE) -> ChunkedBuffer:
        buf = ChunkedBuffer.from_array(arr, chunk_size, stats=self.stats, device=self.device)
        existing = self.objects.get(object_id)
        if existing is not None:
            if existing.complete and not torch.equal(existing.data, buf.data):
                raise ObjectAlreadyExists(object_id)
            if not existing.complete:
                # Replacing an in-flight partial (re-Put / lineage revive):
                # readers gated on the orphaned buffer's watermark must
                # fail over to the new complete copy, not ride a timeout.
                existing.fail()
            # Replacing our own copy: only the size delta is incoming;
            # counting the full size would double-count the object and
            # evict innocent bystanders.
            self._maybe_evict(buf.size - existing.size)
            self._used_bytes += buf.size - existing.size
        else:
            self._maybe_evict(buf.size)
            self._used_bytes += buf.size
        self.objects[object_id] = buf
        self.pinned.add(object_id)
        self._lru.pop(object_id, None)
        return buf

    # -- access ---------------------------------------------------------------

    def get(self, object_id: str) -> Optional[ChunkedBuffer]:
        buf = self.objects.get(object_id)
        if buf is not None:
            self._touch(object_id)
        return buf

    def contains(self, object_id: str) -> bool:
        return object_id in self.objects

    def delete(self, object_id: str) -> None:
        buf = self.objects.pop(object_id, None)
        if buf is not None:
            self._used_bytes -= buf.size
            if not buf.complete:
                # An in-flight copy deleted out from under its readers:
                # wake them now (they fail over or observe ObjectLost)
                # instead of letting them sleep on a watermark that may
                # never advance again.
                buf.fail()
        self.pinned.discard(object_id)
        self._lru.pop(object_id, None)

    def fail_all_buffers(self) -> None:
        """Node death: wake every reader blocked on any of this store's
        watermarks (targeted replacement for the old global notify_all)."""
        for buf in list(self.objects.values()):
            buf.fail()


class StoreRegistry:
    """Membership-safe registry of per-node stores.

    Replaces the seed-era ``[NodeStore(i) for i in range(num_nodes)]``
    list so node ids are first-class members, not list indices: nodes
    can join (``add``) and leave (``remove``) after construction, and a
    store access with an id beyond the seed range can never raise
    ``IndexError`` or silently fall off a length guard.

    Two structures, deliberately separate:

      * ``_members`` -- the ids that currently *belong* to the cluster
        (``len()``, ``ids()``, ``in``).  ``fail_node`` keeps membership
        (a dead member still counts toward the fleet); ``drain_node``
        removes it (the node left on purpose).
      * ``_stores``  -- node id -> :class:`NodeStore`.  ``__getitem__``
        is ensure-on-access (a stray id gets an empty store rather than
        a crash) but never grows *membership* -- only ``add`` does.

    Iteration yields stores (sorted by id) for compatibility with the
    seed-era list (``for s in cluster.stores``); mutations happen under
    the owning cluster's directory lock, like ``NodeStore`` itself.
    """

    def __init__(
        self,
        capacity_bytes: Optional[int] = None,
        stats: Optional[DataPlaneStats] = None,
        seed_ids=(),
        *,
        device: torch.device,
        trace=None,
    ):
        self.capacity_bytes = capacity_bytes
        self.stats = stats
        self.device = device
        self.trace = trace
        self._stores: Dict[int, NodeStore] = {}
        self._members: set = set()
        for nid in seed_ids:
            self.add(int(nid))

    def _fresh(self, nid: int) -> NodeStore:
        return NodeStore(nid, self.capacity_bytes, stats=self.stats, device=self.device, trace=self.trace)

    # -- membership ----------------------------------------------------------

    def add(self, nid: int) -> NodeStore:
        """Make ``nid`` a member and ensure it has a store."""
        self._members.add(nid)
        store = self._stores.get(nid)
        if store is None:
            store = self._stores[nid] = self._fresh(nid)
        return store

    def remove(self, nid: int) -> Optional[NodeStore]:
        """Drop ``nid`` from membership and discard its store (drain
        departure).  Returns the old store, if any, so the caller can
        fail its buffers outside the directory lock."""
        self._members.discard(nid)
        return self._stores.pop(nid, None)

    def replace(self, nid: int) -> NodeStore:
        """Swap in a fresh empty store (fail/restart), leaving membership
        untouched.  Returns the OLD store so the caller can fail its
        buffers outside the directory lock."""
        old = self._stores.get(nid)
        if old is None:
            old = self._fresh(nid)
        self._stores[nid] = self._fresh(nid)
        return old

    def ids(self):
        """Sorted member ids."""
        return sorted(self._members)

    def __contains__(self, nid) -> bool:
        return nid in self._members

    def __len__(self) -> int:
        return len(self._members)

    # -- store access --------------------------------------------------------

    def __getitem__(self, nid: int) -> NodeStore:
        """Ensure-on-access: a store exists for any id asked about, but
        asking never grows *membership* (see class docstring)."""
        store = self._stores.get(nid)
        if store is None:
            store = self._stores[nid] = self._fresh(nid)
        return store

    def get(self, nid: int) -> Optional[NodeStore]:
        """Non-creating lookup (``delete`` uses this: deleting from a
        node that has no store must not conjure one)."""
        return self._stores.get(nid)

    def __iter__(self):
        # Yields STORES, sorted by node id -- list-compatible with the
        # seed-era ``for s in cluster.stores``.
        return iter([self._stores[i] for i in sorted(self._stores)])
