"""Threaded in-process Hoplite cluster moving REAL bytes (port of
``repro.core.local``).

N "nodes" (thread domains) in one process, real payloads, chunk-granularity
streaming with the same directory / checkout / chain protocols.  In the port
every node's store holds its objects as ``torch.uint8`` buffers on the
cluster's one device (``LocalCluster(..., device=...)``: the card unless the
caller asks for the CPU), a copy is a device copy, and every window of a
SUM fold over f32, bf16 or f16 is the hand-written ``chunk_reduce`` kernel,
written straight into the output buffer above its watermark
(``api.SUM``).  All device work goes on the device's default stream, so a
reader that has seen a watermark is ordered after the writer's kernel.
Objects of numpy's unsigned 16/32/64-bit integers are refused at Put (no
CUDA ``add``).  It backs the task runtime (repro_torch/runtime) and
the property-based tests (reduce == exact sum under any arrival order,
broadcast delivers identical bytes through relay chains, node failure
recovery re-fetches from surviving copies).

Transfers stream chunk-by-chunk gated on the *source's* progress, so a
partial copy genuinely forwards data it has only partially received --
the real pipelining mechanism, not a mock of it.

Broadcast is receiver-driven and adaptive (README "Receiver-driven
broadcast"): each ``_fetch`` asks the directory for the least-loaded copy
whose watermark leads its own progress, registers its in-flight partial
as a candidate source immediately, and publishes its watermark per
window -- so N receivers self-organize into a pipelined multicast tree
whose fan-out is capped by the shared broadcast policy
(``planner.broadcast_policy``), and a source failure or stall mid-stream
re-plans to another copy and resumes from the current watermark.

Reduce is the same machinery pointed upstream (README "Pipelined reduce
and fused allreduce"): every chain target -- group partials included --
is advertised as a *producing* partial before its first byte, consumers
(the next hop, the 2-D top chain, fused-allreduce broadcast receivers)
stream from it as soon as its watermark leads, and a participant death
mid-stream RE-SPLICES the chain: the consumer keeps its prefix, rebuilds
the lost partial from still-live copies via the chain lineage (same fold
association, byte-identical), and resumes from its own watermark --
never a subtree restart.  ``allreduce`` fuses reduce and broadcast into
one pipeline bounded by a single fill past the reduce
(``planner.allreduce_policy``, shared with the simulator).

Concurrency model (README "Data-plane concurrency model"):

  * Data plane: every ``ChunkedBuffer`` owns its progress watermark (its
    own lock + condition).  Senders gate on ``wait_for_bytes``; writers
    signal only that buffer's waiters.  Disjoint transfers share no lock.
  * Control plane: one directory lock (``_dir_lock``) guards the
    directory, object metadata, the per-node store maps and cluster
    membership.  Threads that must wait for *directory state* (a location
    to appear, a watermark to advance past theirs, an outbound slot to
    free up) subscribe to per-object-id events -- ``ObjectDirectory``
    callbacks fired by ``publish_*`` / ``update_progress`` /
    ``release_source`` / ``delete`` / ``fail_node`` -- instead of polling
    a global condition.
  * Lock ordering: the directory lock is never acquired while holding a
    buffer lock; buffer locks are innermost and never held across a
    directory or store call.  Streams take the directory lock only
    *between* windows (watermark publication), never per chunk.
"""

from __future__ import annotations

import collections
import dataclasses
import math
import threading
import time
from concurrent.futures import Future
from typing import Callable, Dict, FrozenSet, List, Optional, Sequence, Tuple

import torch

from repro_torch.core.api import (
    DEFAULT_CHUNK_SIZE,
    ObjectAlreadyExists,
    as_tensor,
    ObjectLost,
    Progress,
    ReduceOp,
    SMALL_OBJECT_THRESHOLD,
    SUM,
)
from repro_torch.core.comm import (
    CommClosedError,
    FaultableStream,
    RemoteBufferFailed,
    backoff_delay,
    create_backend,
)
from repro_torch.core.collectives import CollectiveConfig
from repro_torch.core.directory import ObjectDirectory, ReplicatedDirectory
from repro_torch.core.faults import FaultInjector, FaultPlan, FaultToleranceConfig
from repro_torch.core.planner import (
    LinkSpec,
    EC2_LINK,
    SPLICE_REJECT,
    SPLICE_TAIL,
    allreduce_policy,
    bounded_time_participants,
    broadcast_policy,
    splice_mode,
    use_two_dimensional,
)
from repro_torch.core.scheduler import ChainState, partition_groups
from repro_torch.core.store import (
    ChunkedBuffer,
    DataPlaneStats,
    NodeStore,
    StoreRegistry,
    copy_bytes,
)
from repro_torch.core.trace import (
    CAT_CHAIN,
    CAT_COMM,
    CAT_DIRECTORY,
    CAT_FETCH,
    CAT_MEMBERSHIP,
    CAT_STREAM,
    NODE_DIRECTORY,
    RESPLICE_MEMBER_CHANGE,
    SPAN_DIR_LOCK,
    SPAN_WINDOW,
    FlightRecorder,
    STAGE_CAP_BLOCKED,
    STAGE_PLAN,
    STAGE_PRODUCER_WAIT,
    STAGE_REPLAN,
    STAGE_RESPLICE,
    STAGE_STRAGGLER_CUT,
    STAGE_STREAMING,
    StageClock,
)
from repro_torch.device import resolve_device


def _fold_into(op, a: torch.Tensor, b: torch.Tensor, out: torch.Tensor) -> None:
    """``out = op(a, b)``; ``out`` may be ``a``.  A ``ReduceOp`` writes in
    place (``ReduceOp.into``); any other callable's result is copied."""
    into = getattr(op, "into", None)
    if into is not None:
        into(a, b, out)
    else:
        out.copy_(op(a, b))


class _DirectoryLock:
    """The cluster's re-entrant directory lock, timing only contended
    acquisitions: a non-blocking try first, and a clock around the blocking
    acquire only when the try fails.  The wait is summed, under the lock
    itself, into ``stats.dir_lock_wait_seconds`` and, with the recorder on,
    recorded as a ``dir-lock`` span on the ``directory lock`` lane."""

    __slots__ = ("_lock", "_stats", "_trace")

    def __init__(self, stats: DataPlaneStats, trace: FlightRecorder):
        self._lock = threading.RLock()
        self._stats = stats
        self._trace = trace

    def acquire(self, blocking: bool = True, timeout: float = -1) -> bool:
        if self._lock.acquire(False):
            return True
        if not blocking:
            return False
        t0 = time.perf_counter()
        if not self._lock.acquire(True, timeout):
            return False
        waited = time.perf_counter() - t0
        self._stats.dir_lock_wait_seconds += waited
        if self._trace.enabled:
            self._trace.span(CAT_DIRECTORY, SPAN_DIR_LOCK, NODE_DIRECTORY, t0, waited)
        return True

    def release(self) -> None:
        self._lock.release()

    def __enter__(self) -> bool:
        return self.acquire()

    def __exit__(self, *exc) -> None:
        self._lock.release()


class DeadNode(RuntimeError):
    def __init__(self, node):
        super().__init__(str(node))
        try:
            self.node_id = int(node)
        except (TypeError, ValueError):
            self.node_id = None


class StaleBuffer(RuntimeError):
    """The source buffer was failed/abandoned but its node is alive
    (restart, or an abandoned in-flight partial): drop that one location
    and retry another source -- do NOT declare the whole node dead."""


class SourceStalled(RuntimeError):
    """The source's watermark stopped advancing (its own upstream died or
    wedged) past the stall budget while recovery is possible -- another
    copy exists, or the stalled partial can be re-built from lineage:
    release the slot and re-plan to a different source (the stalled node
    is soft-avoided in re-selection), resuming from the receiver's
    current watermark."""

    def __init__(self, msg: str, node: Optional[int] = None, object_id: str = ""):
        super().__init__(msg)
        self.node = node
        self.object_id = object_id


# Legacy default for the watermark-wait recheck period; the live value is
# ``FaultToleranceConfig.watermark_recheck_s`` threaded through the
# cluster (it bounds how long a reader sleeps before re-checking cluster
# membership -- it is normally woken long before this by the buffer's own
# condition or its ``fail()``).  Kept for backward compatibility.
_WATERMARK_RECHECK_S = 5.0

# A relay stream publishes its destination watermark at least this many
# times per object, so downstream receivers chasing it overlap with the
# inbound leg instead of seeing one 0 -> complete jump (store-and-forward).
# Per-hop lag is ~1/PIPELINE_MIN_WINDOWS of the object's transfer time.
PIPELINE_MIN_WINDOWS = 16


class AllreduceResult(str):
    """Return value of ``LocalCluster.allreduce``: the target object id,
    enriched with the participation outcome of a bounded-time run.

    A ``str`` subclass so every existing caller that treats the return
    as an object id (Get it, delete it, pass it on) works unchanged;
    bounded-time callers additionally read:

      * ``participants`` / ``dropped`` -- source ids folded in / cut off
      * ``mask`` -- tuple of bools over the ORIGINAL source order
        (``mask[i]`` iff ``source_ids[i]`` contributed)
      * ``cut`` -- True when the straggler cut-off actually fired

    The partial fold is the exact ``op``-fold of the participating
    contributions only -- it is NOT rescaled; see
    ``collectives.partial_fold_scale`` for the unbiased-mean correction.
    """

    def __new__(cls, target_id: str, participants=(), dropped=(), mask=(),
                cut: bool = False):
        self = super().__new__(cls, target_id)
        self.participants = tuple(participants)
        self.dropped = tuple(dropped)
        self.mask = tuple(mask)
        self.cut = cut
        return self


class _ChainHandle:
    """Registry entry for one in-flight reduce chain (``_active_chains``).

    Bridges the public member-change splice API
    (``LocalCluster.splice_contribution``) and the chain's single-threaded
    coordinator loop: accepted *tail* splices land in ``extra_pending``
    (drained by ``_run_chain`` under ``lock``, so the coordinator's
    ``pending`` set stays single-threaded), accepted late *side*
    contributions in ``late`` (folded by ``_finalize_chain`` as extra
    operands of the finalization fold).  ``fold_frontier`` flips positive
    the moment the finalization fold freezes its input set: from then on
    the target's prefix bytes are immutable (broadcast chasers may already
    hold copies of them) and new contributions are rejected."""

    __slots__ = ("chain", "node", "lock", "wake", "extra_pending", "late",
                 "chain_active", "fold_frontier", "closed")

    def __init__(self, chain: ChainState, node: int):
        self.chain = chain
        self.node = node
        self.lock = threading.Lock()
        self.wake: Optional[threading.Event] = None  # coordinator loop's event
        self.extra_pending: List[str] = []  # accepted tail splices, not yet admitted
        self.late: List[str] = []  # accepted side-contributions for finalization
        self.chain_active = True  # coordinator loop still consuming sources
        self.fold_frontier = 0  # >0 once the finalization fold's inputs froze
        self.closed = False  # chain finished/failed: no splice can ever land


class LocalCluster:
    """An in-process Hoplite deployment."""

    def __init__(
        self,
        num_nodes: int,
        *,
        chunk_size: Optional[int] = None,
        link: LinkSpec = EC2_LINK,
        directory_replicas: int = 1,
        pace: float = 0.0,  # optional seconds of sleep per chunk (tests)
        store_capacity: Optional[int] = None,
        max_out_degree: Optional[int] = None,  # None -> broadcast policy
        stall_timeout: Optional[float] = None,  # overrides fault_tolerance
        trace: bool = False,
        fault_tolerance: Optional[FaultToleranceConfig] = None,
        faults=None,  # FaultPlan or FaultInjector (noise only; call
        #               injector.start(cluster) to arm kills/restarts)
        comm_backend: Optional[str] = None,  # "inproc" | "socket";
        #               None -> $REPRO_COMM -> "inproc"
        device=None,  # where every store's buffers live; None -> "cuda"
    ):
        # The card unless the caller asks for the CPU; no CUDA -> raise.
        self.device = resolve_device(device)
        # ``chunk_size=None`` autotunes per object via the Appendix-A cost
        # model (CollectiveConfig.chunks_for, whose step overhead is 0 in
        # the port); an explicit value pins it.
        self._explicit_chunk_size = chunk_size
        self.chunk_size = chunk_size if chunk_size is not None else DEFAULT_CHUNK_SIZE
        self._autotune = CollectiveConfig(link=link) if chunk_size is None else None
        self.link = link
        self.pace = pace
        self.store_capacity = store_capacity
        self.max_out_degree = max_out_degree
        # One config object for every recovery budget and default timeout
        # (stall budget, watermark recheck, get/reduce/join deadlines);
        # the legacy ``stall_timeout`` kwarg overrides just that field.
        ft = fault_tolerance or FaultToleranceConfig()
        if stall_timeout is not None:
            ft = dataclasses.replace(ft, stall_timeout=stall_timeout)
        self.ft = ft
        self.stall_timeout = ft.stall_timeout  # back-compat alias
        if faults is not None and isinstance(faults, FaultPlan):
            faults = FaultInjector(faults)
        self.faults: Optional[FaultInjector] = faults
        self.directory = ReplicatedDirectory(num_replicas=directory_replicas)
        self._stats = DataPlaneStats()
        # Flight recorder (core/trace): always constructed so call sites
        # stay unconditional; a disabled recorder costs one bool check.
        # Replicas never get the recorder -- mirrored mutations must not
        # double-record directory events.
        self.trace = FlightRecorder(enabled=trace, device=self.device)
        self.directory.recorder = self.trace
        # Membership-safe store registry: node ids are first-class members
        # (join with ``add_node``, leave with ``drain_node``), not list
        # indices.  ``num_nodes`` is derived from it (see the property).
        self.stores = StoreRegistry(
            store_capacity, stats=self._stats, seed_ids=range(num_nodes),
            device=self.device, trace=self.trace,
        )
        self.meta: Dict[str, Tuple[torch.dtype, tuple]] = {}
        self.dead: set = set()
        # Nodes mid-drain: still alive (in-flight transfers finish; they
        # can serve as sole sources) but soft-avoided for new selections
        # and skipped for new placements until the drain completes.
        self.draining: set = set()
        # Monotonic membership epoch, bumped under the directory lock on
        # every member-set delta (join / drain / kill / restart).  An
        # in-flight chain snapshots it at creation (``ChainState.epoch``)
        # and advances its own copy per accepted member-change splice.
        self.membership_epoch = 0
        # target_id -> _ChainHandle for every in-flight reduce chain (2-D
        # group chains register under their sub-target ids as well);
        # ``splice_contribution`` routes member-change splices through it.
        self._active_chains: Dict[str, _ChainHandle] = {}
        # node id -> epoch at which it drained away (cleared when the id
        # re-joins).  Chain consumers use it to classify a tail rebuild as
        # a drain HANDOFF (``splices_drain`` + ``splice-drain`` instants)
        # rather than a failure re-splice -- ``resplices`` and the
        # ``resplice`` instants must keep matching exactly.
        self._drained: Dict[int, int] = {}
        # object id -> draining/drained holder: contributions mid-handoff.
        # Bounded-time allreduce waits these out against the hard deadline
        # instead of counting them as stragglers -- a drain is never a cut.
        self._drain_handoffs: Dict[str, int] = {}
        # Control-plane (directory) lock; exposed as ``lock`` for
        # compatibility.  The data plane does NOT take it per chunk.
        self._dir_lock = _DirectoryLock(self._stats, self.trace)
        self.lock = self._dir_lock
        # Events of threads blocked on directory state; set on membership
        # changes (fail/restart/failover) so waiters re-check promptly.
        self._membership_waiters: set = set()
        # (node, object_id) fetches currently streaming: a sibling get of
        # the same object on the same node waits for the in-flight one
        # instead of opening a duplicate inbound stream.
        self._fetching: set = set()
        self._threads: List[threading.Thread] = []
        # instrumentation
        self._stats_lock = threading.Lock()
        self.bytes_sent_per_node = [0] * num_nodes
        self.transfers: List[Tuple[int, int, str]] = []  # (src, dst, oid)
        # Comm transport: every byte-moving leg (_stream_copy, the
        # remote feeds of _stream_fold) goes through this backend.  The
        # default "inproc" backend is today's direct-buffer plane; the
        # "socket" backend moves real bytes over localhost endpoints.
        # Per-link stream ordinals key the injector's deterministic
        # connection-reset draws.
        self._stream_seq: Dict[Tuple[int, int], int] = collections.defaultdict(int)
        self._comm = create_backend(comm_backend)
        self.comm_backend = self._comm.name
        self._comm.attach(self)

    # -- helpers -------------------------------------------------------------

    @property
    def num_nodes(self) -> int:
        """Live membership count (joins and drains move it); dead-but-
        not-drained members still count -- they may restart."""
        return len(self.stores)

    @property
    def stats(self) -> Dict[str, object]:
        """Data-plane contention counters (see store.DataPlaneStats),
        including critical-path ``stage_seconds`` attribution."""
        return self._stats.as_dict()

    def reset_stats(self) -> Dict[str, object]:
        """Snapshot-then-zero the counters (benchmark scenario hygiene:
        per-scenario deltas must not bleed across a cluster's lifetime).
        Returns the pre-reset snapshot."""
        snap = self._stats.snapshot()
        self._stats.reset()
        return snap

    def dump_trace(self, path: str) -> int:
        """Write the flight recorder's events as Chrome-trace JSON
        (openable in chrome://tracing or https://ui.perfetto.dev).
        Returns the number of exported events."""
        return self.trace.dump_chrome_trace(path)

    def chunk_size_for(self, nbytes: int) -> int:
        """Chunk size for one object: the explicit override when given,
        else the Appendix-A autotuned count (more chunks for bigger
        objects / longer chains), rounded up to a 64-byte multiple so
        typed reduce windows stay element-aligned."""
        if self._explicit_chunk_size is not None or self._autotune is None:
            return self.chunk_size
        if nbytes <= 0:
            return self.chunk_size
        c = self._autotune.chunks_for(self.num_nodes, nbytes)
        chunk = -(-nbytes // c)
        return max(64, chunk + (-chunk) % 64)

    def broadcast_out_degree(self, nbytes: int) -> int:
        """Per-node concurrent-outbound cap for an object of this size --
        the explicit override, or the shared simulator/LocalCluster
        broadcast-tree policy (t_pipelined_multicast vs
        t_binomial_store_forward)."""
        if self.max_out_degree is not None:
            return self.max_out_degree
        policy = broadcast_policy(
            max(1, self.num_nodes - 1),
            self.link,
            nbytes,
            chunk=float(self.chunk_size_for(nbytes)),
            # Threaded streams pace independently (no shared egress pipe).
            egress_sharing=False,
        )
        return policy.max_out_degree

    def _spawn(self, fn, *args) -> threading.Thread:
        t = threading.Thread(target=fn, args=args, daemon=True)
        t.start()
        self._threads.append(t)
        return t

    def _check_alive(self, node: int):
        if node in self.dead:
            raise DeadNode(str(node))

    def join(self, timeout: Optional[float] = None):
        timeout = self.ft.join_timeout if timeout is None else timeout
        deadline = time.time() + timeout
        for t in self._threads:
            t.join(max(0.0, deadline - time.time()))

    def _await_directory(
        self,
        object_ids: Sequence[str],
        attempt: Callable[[], Optional[object]],
        deadline: float,
        what: str = "",
    ):
        """Event-driven directory wait: run ``attempt()`` under the
        directory lock until it returns non-None, re-trying whenever one
        of ``object_ids`` is (re)published/deleted or cluster membership
        changes.  ``attempt`` may raise (ObjectLost, DeadNode) to abort.

        Replaces the old cluster-global condition variable: only threads
        interested in these object ids are woken by their events.
        """
        ids = list(dict.fromkeys(object_ids))
        ev = threading.Event()

        def cb(_oid):
            ev.set()

        with self._dir_lock:
            result = attempt()
            if result is not None:
                return result
            for oid in ids:
                self.directory.subscribe(oid, cb)
            self._membership_waiters.add(ev)
        try:
            while True:
                remaining = deadline - time.time()
                if remaining <= 0 or not ev.wait(timeout=remaining):
                    raise TimeoutError(what or f"directory wait on {ids[:3]}")
                ev.clear()
                with self._dir_lock:
                    result = attempt()
                    if result is not None:
                        return result
        finally:
            with self._dir_lock:
                for oid in ids:
                    self.directory.unsubscribe(oid, cb)
                self._membership_waiters.discard(ev)

    def _wake_membership_waiters(self) -> None:
        """Caller must hold the directory lock."""
        for ev in self._membership_waiters:
            ev.set()

    def _bump_epoch(self) -> int:
        """Advance the membership epoch -- one transition per member-set
        delta (join, drain, kill, restart).  Caller holds the directory
        lock.  In-flight chains carry the epoch they last spliced under,
        so the trace can attribute every divergence from a chain's
        start-time member set to a specific transition."""
        self.membership_epoch += 1
        return self.membership_epoch

    def _is_drain_handoff(self, cause_node: Optional[int]) -> bool:
        """True when a chain tail rebuild was caused by a *drained* member
        (planned departure: its chain position is handed off and counted
        in ``splices_drain``) rather than a failure (``resplices``).  The
        split keeps the failure-re-splice invariant exact: trace
        ``resplice`` instants == ``stats["resplices"]``."""
        return cause_node is not None and cause_node in self._drained

    def _drain_protected(self, object_id: str) -> bool:
        """True when ``object_id``'s arrival is gated on a planned drain
        handoff rather than a straggler: a live copy sits at a draining
        member, or its holder drained after handing the bytes off
        (``_drain_handoffs``).  Bounded-time allreduce waits these out
        against the hard deadline instead of counting them in
        ``AllreduceResult.dropped`` -- a drain is never a cut."""
        with self._dir_lock:
            if object_id in self._drain_handoffs:
                return True
            return any(
                l.node in self.draining
                for l in self.directory.locations(object_id)
            )

    def _object_lost(self, object_id: str) -> bool:
        """True when the object WAS created (meta or tombstone exists) but
        no copy, in-flight transfer, or inline entry survives.  An object
        that merely has not been Put yet is NOT lost -- reduce sources may
        legitimately arrive later.  Caller holds the directory lock."""
        if self.directory.is_available(object_id):
            return False
        return object_id in self.meta or self.directory.is_deleted(object_id)

    # -- Put -------------------------------------------------------------------

    def put(self, node: int, object_id: str, value) -> str:
        """Synchronous Put (the executor->store copy is instant in-process;
        the *pipelining* this copy needs on a real deployment is exercised
        in the simulator).  ``value`` is a tensor or a numpy array; its bytes
        are copied onto the cluster's device (``api.as_tensor``)."""
        value = as_tensor(value, self.device)
        with self._dir_lock:
            # Aliveness must be decided under the directory lock: checked
            # outside it, a concurrent fail_node can wipe this node between
            # the check and the publish, leaving a permanent stale COMPLETE
            # location at a dead node (waiters filter it but see the object
            # as "available" -- the serving-tail stall).
            self._check_alive(node)
            self.directory.revive(object_id)  # explicit re-Put clears tombstone
            self.meta[object_id] = (value.dtype, tuple(value.shape))
            buf = self.stores[node].put_array(
                object_id, value, self.chunk_size_for(value.nbytes)
            )
            if buf.size < SMALL_OBJECT_THRESHOLD:
                self.directory.publish_inline(object_id, value.clone(), buf.size)
            self.directory.publish_complete(object_id, node, buf.size)
        return object_id

    # -- Get -------------------------------------------------------------------

    def get(self, node: int, object_id: str, timeout: Optional[float] = None) -> torch.Tensor:
        """Blocking receiver-driven Get with relay through partial copies.
        ``timeout=None`` uses ``FaultToleranceConfig.get_timeout``.  Returns
        a copy on the cluster's device, as the JAX package returns a copy:
        updating it in place leaves the object as it was."""
        timeout = self.ft.get_timeout if timeout is None else timeout
        self._check_alive(node)
        deadline = time.time() + timeout
        with self._dir_lock:
            inline = self.directory.get_inline(object_id)
            if inline is not None:
                return inline.clone()
            local = self.stores[node].get(object_id)
            if local is not None and local.complete:
                dtype, shape = self.meta[object_id]
                return local.to_array(dtype, shape).clone()
        buf = self._fetch(node, object_id, deadline)
        with self._dir_lock:
            meta = self.meta.get(object_id)
            if meta is None:  # deleted immediately after the transfer
                raise ObjectLost(object_id)
            dtype, shape = meta
            return buf.to_array(dtype, shape).clone()

    def _fetch(self, node: int, object_id: str, deadline: float) -> ChunkedBuffer:
        """Pull object into ``node``'s store: adaptive receiver-driven
        broadcast (paper section 4.2-4.3).

        Each planning round selects the *least-loaded* copy whose
        watermark leads our own progress -- complete or still in flight --
        charging the holder's outbound-load counter so no node exceeds
        the broadcast policy's out-degree; our own partial is registered
        as a candidate source before the first byte lands, which is what
        grows the pipelined multicast tree.  On sender failure, stale
        buffer, or stall we re-plan to another copy and RESUME from the
        destination watermark instead of restarting."""
        key = (node, object_id)
        owns_stream = [False]
        # Nodes this fetch already stalled on: soft-deprioritized in
        # re-selection (they lose ties but stay pickable when they hold
        # the only copy -- eviction must never wedge the fetch).
        avoid: set = set()
        # Critical-path attribution: this fetch partitions its own wall
        # time into stages.  After a failed leg, planning time and waits
        # classify as "replan" until the next leg starts streaming.
        sc = StageClock(self._stats, self.trace, node, object_id)
        replanning = [False]

        def wait_stage(stage: str) -> None:
            sc.switch(STAGE_REPLAN if replanning[0] else stage)

        def attempt():
            """Plan one transfer leg; None -> wait for a directory event
            (publication, watermark advance past ours, or a freed
            outbound slot).  Returns ("done", buf) when a sibling fetch
            completed our copy, else ("xfer", loc, size, src_buf, dst_buf)."""
            wait_stage(STAGE_PLAN)
            if node in self.dead:
                # The receiver itself was killed mid-protocol: abort
                # instead of re-advertising a partial at a dead node.
                raise DeadNode(str(node))
            while True:
                mine = self.stores[node].get(object_id)
                if mine is not None and mine.complete:
                    return ("done", mine)  # completed concurrently here
                if not owns_stream[0] and key in self._fetching:
                    # A sibling fetch is already streaming this object
                    # into this node: wait for it instead of opening a
                    # duplicate inbound stream (its completion, failure,
                    # or abandonment all fire directory events).
                    wait_stage(STAGE_PRODUCER_WAIT)
                    return None
                progress = mine.bytes_present if mine is not None else 0
                self._refresh_watermarks(object_id)
                size = self.directory.size_of(object_id)
                if size is None:
                    if not self.directory.available_elsewhere(object_id, node):
                        raise ObjectLost(object_id)
                    wait_stage(STAGE_PRODUCER_WAIT)
                    return None  # partial advertised without size yet
                loc = self.directory.select_source(
                    object_id,
                    exclude=node,
                    min_lead=progress,
                    max_out_degree=self.broadcast_out_degree(size),
                    dead=self.dead,
                    avoid=frozenset(avoid),
                )
                if loc is None:
                    if not self.directory.available_elsewhere(object_id, node):
                        # Only our own (incomplete) partial remains -- no
                        # sender can ever feed it: the object is lost.
                        raise ObjectLost(object_id)
                    # Stuck-cohort detection: in this plane a copy only
                    # completes by streaming from a complete copy or from
                    # a partial that leads it (Puts publish COMPLETE
                    # atomically).  If no complete/inline copy exists and
                    # we sit at the cohort's watermark frontier, nothing
                    # can ever feed us: the tail of the object died with
                    # its last complete holder.  Raise now -- our
                    # abandoned partial fails chasers over to the next
                    # frontier, which concludes the same, so the whole
                    # cohort collapses to ObjectLost (and lineage
                    # recovery) instead of riding its deadlines.
                    if self.directory.get_inline(object_id) is None:
                        locs = self.directory.locations(object_id)
                        if locs and all(
                            l.progress is not Progress.COMPLETE for l in locs
                        ):
                            # A *producing* partial at a live node (a
                            # reduce target mid-production) advances with
                            # no upstream feed: the cohort is not stuck,
                            # it is waiting on the producer.
                            if not any(
                                l.producing and l.node not in self.dead for l in locs
                            ):
                                frontier = max(l.bytes_present for l in locs)
                                if progress >= frontier:
                                    raise ObjectLost(object_id)
                    # Classify the wait: feasible-but-capped holders mean
                    # the cap is the bottleneck ("cap-blocked"); no copy
                    # leading our watermark means we wait on a producer.
                    feasible = any(
                        l.node != node
                        and l.node not in self.dead
                        and (
                            l.progress is Progress.COMPLETE
                            or l.bytes_present > progress
                        )
                        for l in self.directory.locations(object_id)
                    )
                    wait_stage(
                        STAGE_CAP_BLOCKED if feasible else STAGE_PRODUCER_WAIT
                    )
                    return None  # all feasible sources busy/behind: wait
                src_buf = self.stores[loc.node].get(object_id)
                if src_buf is None or src_buf.failed:
                    # Stale location: LRU-evicted under capacity pressure
                    # or abandoned after publication.  Invalidate, retry.
                    # (Charged and released under one continuous lock
                    # hold, so the current epoch is the charge's epoch.)
                    self.directory.release_source(
                        object_id, loc.node, self.directory.charge_epoch(loc.node)
                    )
                    self.directory.drop_location(object_id, loc.node)
                    continue
                dst_buf = mine
                if dst_buf is None:
                    dst_buf = self.stores[node].create(
                        object_id,
                        size,
                        pinned=False,
                        chunk_size=self.chunk_size_for(size),
                    )
                # Register as a candidate source NOW (tree formation),
                # and claim the (node, object) stream slot.
                self.directory.publish_partial(object_id, node, size)
                self._fetching.add(key)
                owns_stream[0] = True
                self._stats.note_outbound(
                    loc.node, self.directory.outbound_load(loc.node)
                )
                epoch = self.directory.charge_epoch(loc.node)
                if self.trace.enabled:
                    self.trace.instant(
                        CAT_FETCH,
                        "replan-leg" if replanning[0] else "plan-leg",
                        node, object_id, src=loc.node, resume_from=dst_buf.bytes_present,
                    )
                replanning[0] = False
                return ("xfer", loc, size, src_buf, dst_buf, epoch)

        try:
            while True:
                try:
                    result = self._await_directory(
                        [object_id], attempt, deadline, what=f"Get({object_id}) timed out"
                    )
                except (ObjectLost, TimeoutError):
                    # We may have published a partial that no sender will ever
                    # finish feeding: withdraw it and fail its buffer so every
                    # receiver chained off us observes the loss NOW (and can
                    # reconstruct) instead of riding its own deadline.
                    self._abandon_partial(node, object_id)
                    raise
                if result[0] == "done":
                    return result[1]
                _, loc, size, src_buf, dst_buf, epoch = result
                try:
                    self._stream_copy(
                        loc.node,
                        node,
                        src_buf,
                        dst_buf,
                        object_id,
                        start=dst_buf.bytes_present,
                        publish_progress=True,
                        stage=sc,
                    )
                except DeadNode as e:
                    replanning[0] = True
                    sc.switch(STAGE_REPLAN)
                    if self.trace.enabled:
                        self.trace.instant(
                            CAT_FETCH, "replan", node, object_id,
                            reason="dead-node", src=loc.node,
                        )
                    with self._dir_lock:
                        self.directory.release_source(object_id, loc.node, epoch)
                        if e.node_id != loc.node:
                            # The RECEIVER died, not the sender: failing
                            # loc.node would wipe a healthy node's
                            # directory entries.  Free the sender slot
                            # (or it stays charged forever) and abort.
                            raise
                        self.directory.fail_node(loc.node)
                        self._withdraw_empty_partial(node, object_id, dst_buf)
                    continue  # re-plan; resume from dst watermark
                except StaleBuffer:
                    # The sender's copy was abandoned/restarted away, but its
                    # node is alive: invalidate that single location and retry.
                    replanning[0] = True
                    sc.switch(STAGE_REPLAN)
                    if self.trace.enabled:
                        self.trace.instant(
                            CAT_FETCH, "replan", node, object_id,
                            reason="stale-buffer", src=loc.node,
                        )
                    with self._dir_lock:
                        self.directory.release_source(object_id, loc.node, epoch)
                        self.directory.drop_location(object_id, loc.node)
                        self._withdraw_empty_partial(node, object_id, dst_buf)
                    continue
                except SourceStalled:
                    # Source watermark wedged but other copies exist: free
                    # the slot and re-plan (resuming, not restarting).
                    # The stalled holder is soft-avoided from now on, so
                    # re-selection lands on a faster replica.
                    replanning[0] = True
                    avoid.add(loc.node)
                    self._stats.stall_replans += 1
                    sc.switch(STAGE_REPLAN)
                    if self.trace.enabled:
                        self.trace.instant(
                            CAT_FETCH, "replan", node, object_id,
                            reason="source-stalled", src=loc.node,
                        )
                    with self._dir_lock:
                        self.directory.release_source(object_id, loc.node, epoch)
                    continue
                with self._dir_lock:
                    self.directory.release_source(object_id, loc.node, epoch)
                    if self.directory.is_deleted(object_id) or object_id not in self.meta:
                        # Deleted mid-transfer: drop our copy instead of
                        # silently re-adding the object.
                        self.stores[node].delete(object_id)
                        self.directory.drop_location(object_id, node)
                        raise ObjectLost(object_id)
                    if node in self.dead:
                        # Receiver died between the last streamed window and
                        # completion: publishing would advertise a copy at a
                        # dead node forever.
                        raise DeadNode(str(node))
                    self.directory.publish_complete(object_id, node, size)
                return dst_buf
        finally:
            sc.close()
            if owns_stream[0]:
                with self._dir_lock:
                    self._fetching.discard(key)
                    # A sibling fetch may have re-checked between our last
                    # directory event and this discard, seen the key still
                    # claimed, and gone back to sleep: wake directory
                    # waiters so it re-plans (or observes the loss) now
                    # instead of riding its deadline.  Terminal exits are
                    # rare; the broadcast wakeup is once per fetch, never
                    # per window.
                    self._wake_membership_waiters()

    def _withdraw_empty_partial(self, node: int, object_id: str, dst_buf) -> None:
        """A stream leg failed before its first byte landed: withdraw our
        0-byte partial advertisement while we have no active source
        (attempt() re-publishes it with the next selected leg).  An empty
        partial is never a feasible source, but its *location* keeps
        ``available_elsewhere`` true for every other receiver -- when a
        broadcast origin dies before anyone has bytes, a ring of empty
        partials would otherwise keep the whole cohort hoping in each
        other until the deadline instead of observing ObjectLost now.
        Caller holds the directory lock."""
        if dst_buf.bytes_present == 0:
            self.directory.drop_location(object_id, node)

    def _refresh_watermarks(self, object_id: str) -> None:
        """Planner-side directory hygiene for one object (caller holds the
        directory lock): drop locations stranded at dead nodes -- so
        availability reflects reality and a fully-lost object raises
        ObjectLost promptly -- and refresh each live partial's watermark
        from its actual store buffer.  Streams publish only their
        0 -> positive transition; the authoritative byte count for
        *selection* is read here, at planning time."""
        for l in self.directory.locations(object_id):
            if l.node in self.dead:
                self.directory.drop_location(object_id, l.node)
            elif l.progress is not Progress.COMPLETE:
                buf = self.stores[l.node].get(object_id)
                if buf is not None and buf.bytes_present > l.bytes_present:
                    self.directory.update_progress(
                        object_id, l.node, buf.bytes_present
                    )

    def _abandon_partial(self, node: int, object_id: str, always_drop: bool = False) -> None:
        """A fetch gave up (object lost / deadline): if we hold only an
        incomplete partial, withdraw its directory advertisement and drop
        it.  NodeStore.delete fails the incomplete buffer, so downstream
        relays chained off it fail over or observe ObjectLost promptly.

        ``always_drop`` also withdraws an advertisement with NO buffer
        behind it yet -- a producing reduce target that failed before its
        first byte would otherwise keep chasers hoping forever."""
        with self._dir_lock:
            candidate = self.stores[node].get(object_id)
            if candidate is not None and not candidate.complete:
                self.stores[node].delete(object_id)  # fails the buffer
                self.directory.drop_location(object_id, node)  # notifies waiters
            elif candidate is None and always_drop:
                self.directory.drop_location(object_id, node)

    def _open_stream_with_retry(
        self,
        src: int,
        dst: int,
        object_id: str,
        src_buf: ChunkedBuffer,
        pos: int,
        reconnect: bool = False,
    ):
        """Open a comm stream from ``src``'s endpoint with capped
        exponential backoff: each failed attempt (endpoint down,
        connection refused, injected ConnFault drop/partition) sleeps
        ``connect_backoff_base_s * 2**attempt`` capped at
        ``connect_backoff_cap_s``, jittered deterministically via the
        fault plane's splitmix hash, up to ``connect_retries`` retries.
        Exhaustion raises ``SourceStalled`` so the caller's existing
        re-plan machinery picks another copy (soft-avoiding this one)
        and resumes from the receiver watermark.

        ``reconnect=True`` marks a mid-stream recovery: counted in
        ``stats.comm_reconnects`` with a matching ``reconnect`` trace
        instant.  Injected mid-stream resets (``ConnFault("reset")``)
        are armed here by wrapping the fresh stream, keyed by the
        per-link stream ordinal so the draw sequence replays."""
        seed = self.faults.plan.seed if self.faults is not None else 0
        retries = max(0, self.ft.connect_retries)
        for attempt in range(retries + 1):
            if src in self.dead:
                raise DeadNode(str(src))
            if dst in self.dead:
                raise DeadNode(str(dst))
            dropped = False
            if self.faults is not None:
                dropped, delay = self.faults.connect_fault(src, dst, attempt)
                if delay > 0.0:
                    time.sleep(delay)
            if not dropped:
                try:
                    stream = self._comm.open_stream(
                        src, dst, object_id, src_buf, pos
                    )
                except CommClosedError:
                    stream = None
                if stream is not None:
                    if self.faults is not None:
                        with self._stats_lock:
                            k = self._stream_seq[(src, dst)]
                            self._stream_seq[(src, dst)] = k + 1
                        reset_at = self.faults.reset_window(src, dst, k)
                        if reset_at is not None:
                            def _trip(src=src, dst=dst, oid=object_id):
                                if self.trace.enabled:
                                    self.trace.instant(
                                        CAT_COMM, "conn-reset", dst, oid, src=src
                                    )
                            stream = FaultableStream(stream, reset_at, on_trip=_trip)
                    if reconnect:
                        self._stats.comm_reconnects += 1
                        if self.trace.enabled:
                            self.trace.instant(
                                CAT_COMM, "reconnect", dst, object_id,
                                src=src, resume_from=pos, attempts=attempt,
                            )
                    return stream
            if attempt >= retries:
                break
            self._stats.connect_retries += 1
            if self.trace.enabled:
                self.trace.instant(
                    CAT_COMM, "connect-retry", dst, object_id,
                    src=src, attempt=attempt,
                )
            time.sleep(backoff_delay(
                seed, src, dst, attempt,
                self.ft.connect_backoff_base_s, self.ft.connect_backoff_cap_s,
            ))
        raise SourceStalled(
            f"{object_id}@{src}: connect retries exhausted",
            node=src, object_id=object_id,
        )

    def _stream_copy(
        self,
        src: int,
        dst: int,
        src_buf: ChunkedBuffer,
        dst_buf: ChunkedBuffer,
        object_id: str,
        start: int = 0,
        publish_progress: bool = False,
        stage: Optional[StageClock] = None,
    ):
        """Windowed zero-copy pipelined copy gated on source progress.

        Each iteration drains what the source has made available since the
        last one (one lock acquisition per *window*, not per chunk) and
        forwards it as a single zero-copy view; ``write_chunk`` advances
        the destination watermark, waking only its own waiters.  Windows
        are capped so every object yields >= PIPELINE_MIN_WINDOWS watermark
        advances -- downstream receivers chasing this copy overlap with
        the inbound leg instead of store-and-forwarding whole objects.
        With ``pace`` set, windows are capped at one chunk to preserve the
        chunk-granular interleaving the pipelining tests rely on.

        ``start`` resumes a re-planned transfer from the destination
        watermark (bytes below it are immutable and identical on every
        copy).  ``publish_progress`` advertises the destination watermark
        in the directory when the FIRST window lands -- the 0 -> positive
        transition that makes this in-flight copy a *feasible* source and
        wakes blocked receivers (tree formation).  Later watermark values
        are refreshed lazily by planners (``_refresh_watermarks``) at
        query time: taking the directory lock once per window from every
        concurrent stream measurably convoys the whole storm.

        Raises SourceStalled when the source watermark stops advancing
        for ``stall_timeout`` while the directory knows another copy.

        ``stage`` is the caller's critical-path clock: time blocked on the
        source watermark classifies as ``producer-wait``, time moving
        bytes as ``streaming``.  Each window's issue, from the source's
        window in hand to the destination's advance, is summed into
        ``stats["window_issue_seconds"]``.  With tracing enabled the whole
        leg is recorded as one ``copy-leg`` span, and each window inside it
        as a ``window`` span whose ``card_done`` (on the card) is when the
        card ran the window's copy.

        The bytes themselves ride the cluster's comm backend: windows
        arrive through a ``ChunkStream`` (a zero-copy buffer view on
        the inproc backend, reassembled socket frames on the socket
        backend).  A mid-stream connection loss reconnects with capped
        backoff and resumes from ``pos`` -- the frame offsets are the
        watermark protocol, so the result is byte-identical.
        """
        pos = start
        total = src_buf.size
        window_cap = max(src_buf.chunk_size, -(-total // PIPELINE_MIN_WINDOWS))
        window_cap += (-window_cap) % 64  # keep watermarks element-aligned
        last_advance = time.time()
        served = 0  # flushed to the shared counters once, in finally
        win_k = 0  # window ordinal (keys the injector's pure jitter draws)
        leg_t0 = self.trace.clock() if self.trace.enabled else None
        stream = self._open_stream_with_retry(src, dst, object_id, src_buf, pos)
        try:
            while pos < total:
                if stage is not None and src_buf.bytes_present <= pos:
                    stage.switch(STAGE_PRODUCER_WAIT)
                limit = src_buf.chunk_size if self.pace else window_cap
                try:
                    window = stream.recv(
                        pos, limit, timeout=self.ft.watermark_recheck_s
                    )
                except RemoteBufferFailed:
                    if src in self.dead:
                        raise DeadNode(str(src))
                    raise StaleBuffer(f"{object_id}@{src}")
                except CommClosedError:
                    # Connection died mid-stream (socket reset, injected
                    # ConnFault, endpoint bounce): reconnect with backoff
                    # and RESUME from the current watermark.  Bytes below
                    # ``pos`` are immutable and identical on every copy,
                    # so the spliced result is byte-identical.
                    if src in self.dead:
                        raise DeadNode(str(src))
                    stream.close()
                    stream = self._open_stream_with_retry(
                        src, dst, object_id, src_buf, pos, reconnect=True
                    )
                    continue
                t_win = time.perf_counter()
                if src in self.dead:
                    raise DeadNode(str(src))
                if window is None:
                    # Timed out with no progress: re-check membership; if
                    # the source has been wedged past the stall budget and
                    # another copy exists, re-plan rather than riding our
                    # own deadline.
                    if src_buf.failed:
                        raise StaleBuffer(f"{object_id}@{src}")
                    if time.time() - last_advance >= self.ft.stall_timeout:
                        with self._dir_lock:
                            elsewhere = any(
                                l.node not in (src, dst) and l.node not in self.dead
                                for l in self.directory.locations(object_id)
                            )
                        if elsewhere:
                            if self.trace.enabled:
                                self.trace.instant(
                                    CAT_STREAM, "watermark-stall", dst,
                                    object_id, src=src, at=pos,
                                )
                            raise SourceStalled(
                                f"{object_id}@{src}", node=src, object_id=object_id
                            )
                    continue
                last_advance = time.time()
                if stage is not None:
                    stage.switch(STAGE_STREAMING)
                avail = pos + window.numel()
                if self.pace:
                    time.sleep(self.pace)
                if self.faults is not None:
                    # Injected link jitter / bandwidth droop / straggler
                    # slowdown: stretch this window by the plan's penalty
                    # (pure in (seed, src, dst, k) -- replay-stable).
                    base = self.pace or (avail - pos) / self.link.bandwidth
                    extra = self.faults.window_penalty(src, dst, win_k, base)
                    if extra > 0.0:
                        time.sleep(extra)
                if dst in self.dead:
                    raise DeadNode(str(dst))
                dst_buf.write_chunk(pos, window)
                t_end = time.perf_counter()
                self._stats.note_window(t_end - t_win)
                if self.trace.enabled:
                    self.trace.span(
                        CAT_STREAM, SPAN_WINDOW, dst, t_win, t_end - t_win, object_id,
                        src=src, bytes=avail - pos, inputs=1, k=win_k,
                        card_done=self.trace.card_event(dst_buf.device),
                    )
                win_k += 1
                served += avail - pos
                first_window = pos == 0
                pos = avail
                if publish_progress and first_window and pos < total:
                    # 0 -> positive: we just became a feasible source for
                    # receivers with no progress; wake them.  One directory
                    # round trip per stream, never per window.
                    with self._dir_lock:
                        self.directory.update_progress(object_id, dst, pos)
        finally:
            stream.close()
            if served:
                with self._stats_lock:
                    self._stats.note_bytes_served(src, served)
                    while src >= len(self.bytes_sent_per_node):
                        self.bytes_sent_per_node.append(0)  # joined node
                    self.bytes_sent_per_node[src] += served
            if leg_t0 is not None:
                self.trace.span(
                    CAT_STREAM, "copy-leg", dst,
                    leg_t0, self.trace.clock() - leg_t0,
                    object_id, src=src, bytes=served, resume_from=start,
                )
        with self._stats_lock:
            self.transfers.append((src, dst, object_id))

    def get_async(self, node: int, object_id: str, timeout: Optional[float] = None) -> Future:
        timeout = self.ft.get_timeout if timeout is None else timeout
        fut: Future = Future()

        def run():
            try:
                fut.set_result(self.get(node, object_id, timeout))
            except BaseException as e:  # noqa: BLE001
                fut.set_exception(e)

        self._spawn(run)
        return fut

    def prefetch_async(self, node: int, object_id: str, timeout: Optional[float] = None) -> Future:
        """Land a complete local copy of ``object_id`` at ``node`` through
        the adaptive broadcast tree WITHOUT materializing an array (the
        serve fast path: weight pushes and fan-out inputs want bytes
        staged, not values returned).  Resolves to the number of bytes
        now local (0 for directory-inline small objects)."""
        timeout = self.ft.get_timeout if timeout is None else timeout
        fut: Future = Future()

        def run():
            try:
                deadline = time.time() + timeout
                with self._dir_lock:
                    self._check_alive(node)
                    if self.directory.get_inline(object_id) is not None:
                        fut.set_result(0)
                        return
                    local = self.stores[node].get(object_id)
                if local is not None and local.complete:
                    fut.set_result(local.size)
                    return
                buf = self._fetch(node, object_id, deadline)
                fut.set_result(buf.size)
            except BaseException as e:  # noqa: BLE001
                fut.set_exception(e)

        self._spawn(run)
        return fut

    # -- Reduce -----------------------------------------------------------------

    def reduce(
        self,
        node: int,
        target_id: str,
        source_ids: Sequence[str],
        op: ReduceOp = SUM,
        timeout: Optional[float] = None,
        _meta: Optional[Tuple] = None,
    ) -> str:
        """Blocking chained reduce (paper section 4.3), including the 2-D
        sqrt(n) decomposition when n*B*L > S.

        The whole path is one watermark-driven pipeline (README "Pipelined
        reduce and fused allreduce"): every chain target -- group partials
        included -- is advertised as a *producing* partial before its
        first byte, and the 2-D top chain admits a group the moment its
        watermark turns positive, streaming from the still-reducing
        partial instead of waiting behind a completion barrier."""
        timeout = self.ft.reduce_timeout if timeout is None else timeout
        self._check_alive(node)
        deadline = time.time() + timeout
        if _meta is None:
            # Wait for the first source to learn dtype/shape/size; every
            # chain below inherits it (one directory subscription round
            # trip per reduce, not one per chain level).
            first = self._wait_any_meta(source_ids, deadline)
            _meta = self.meta[first]
        dtype, shape = _meta
        size = math.prod(shape) * dtype.itemsize
        n = len(source_ids)
        if n > 3 and use_two_dimensional(n, self.link, size):
            groups = partition_groups(list(source_ids))
            sub_ids = []
            futs = []
            try:
                for gi, group in enumerate(groups):
                    sub_id = f"{target_id}/g{gi}"
                    coord = self._first_location(group, deadline, fallback=node)
                    sub_ids.append(sub_id)
                    fut = self._reduce_async(coord, sub_id, group, op, deadline, _meta)
                    # A group that fails BEFORE advertising its target (its
                    # coordinator died first) leaves no location, meta, or
                    # tombstone behind -- the top chain would wait for an
                    # event that is never coming.  Mark the sub-target lost
                    # on any group failure so the top chain observes it NOW.
                    fut.add_done_callback(
                        lambda f, sid=sub_id: f.exception() is not None
                        and self.delete(sid)
                    )
                    futs.append(fut)
                # NO barrier here: the top chain consumes the group
                # partials as streaming sources while they are still being
                # reduced.  A group failure surfaces through the directory
                # (its producing advertisement is withdrawn -> ObjectLost
                # in the top chain) and through the futures below.
                result = self._reduce_chain_blocking(
                    node, target_id, sub_ids, op, deadline, meta=_meta
                )
                for f in futs:
                    f.result(timeout=max(0.0, deadline - time.time()))
                return result
            finally:
                # Group partials are internal: reclaim them on success AND
                # on failure (they are pinned at their coordinators and
                # would leak one set per failed/retried reduce).  A sub-
                # reduce still running past a failure may re-create its
                # sub_id afterwards; its own failure paths bound that.
                for sid in sub_ids:
                    self.delete(sid)
        return self._reduce_chain_blocking(
            node, target_id, list(source_ids), op, deadline, meta=_meta
        )

    def splice_contribution(self, target_id: str, source_id: str) -> bool:
        """Member-change splice: offer ``source_id`` (typically a joiner's
        contribution Put after the collective started) to the in-flight
        reduce chain producing ``target_id``.

        The epoch-versioned chain contract is shared with the simulator
        through ``planner.splice_mode``: while the chain coordinator is
        still consuming sources the contribution is spliced into the chain
        *tail* (same ``op(a, b)`` association any start-time member would
        get); after the chain closed but before the finalization fold
        froze its input set, it folds as a late *side* contribution (exact
        by associativity/commutativity of the elementwise op); once the
        fold frontier moved, the target's prefix bytes are immutable
        (broadcast chasers may already hold them) and the offer is
        rejected.  The source must already be *available* (Put somewhere,
        or directory-inline) -- offer after the Put.

        Returns True iff the contribution WILL be folded into the target.
        Accepted splices are counted in ``splices_join`` and emit one
        ``splice-join`` trace instant each (reason ``member-change``), so
        the trace and the stat always agree."""
        with self._dir_lock:
            handle = self._active_chains.get(target_id)
            if handle is None:
                return False
            if not self.directory.is_available(source_id):
                return False  # nothing to splice yet: Put the bytes first
        with handle.lock:
            if handle.closed:
                return False
            mode = splice_mode(handle.chain_active, handle.fold_frontier, 0.0)
            if mode == SPLICE_REJECT:
                return False
            if mode == SPLICE_TAIL:
                handle.extra_pending.append(source_id)
                wake = handle.wake
            else:
                handle.late.append(source_id)
                wake = None
        if wake is not None:
            wake.set()  # coordinator loop admits the splice on next wakeup
        return True

    def allreduce(
        self,
        nodes: Sequence[int],
        target_id: str,
        source_ids: Sequence[str],
        op: ReduceOp = SUM,
        timeout: Optional[float] = None,
        deadline: Optional[float] = None,
        min_participants: Optional[int] = None,
    ) -> str:
        """Fused allreduce (paper 4.3-4.4 composed): reduce into
        ``nodes[0]`` while every other node broadcast-chases the producing
        target through the adaptive multicast tree, so completion is
        bounded by one pipeline fill past the reduce instead of two
        serialized collectives.  ``planner.allreduce_policy`` (shared with
        the simulator) decides when fusing wins; small inline-able objects
        fall back to reduce-then-fetch.

        **Bounded-time mode** (``deadline=`` and/or ``min_participants=``):
        the serve path's k-of-n quorum generalized to a training
        collective.  Wait up to ``deadline`` seconds for every source; at
        the cut-off, as soon as at least ``min_participants`` (default
        n-1, ``planner.bounded_time_participants``) sources are ready,
        drop the stragglers' unfused contributions and fold only the
        ready set -- so p99 tracks the k-th fastest participant, not the
        slowest.  Returns an :class:`AllreduceResult` (a ``str``)
        carrying the participation mask; the cut is recorded in stats
        (``straggler_cuts`` / ``dropped_contributions``, plus the
        ``straggler-cut`` stage) and as a ``straggler-cut`` trace
        instant.  With ``deadline=None`` the fold starts the moment the
        quorum is ready (no grace period for stragglers)."""
        timeout = self.ft.reduce_timeout if timeout is None else timeout
        hard_deadline = time.time() + timeout
        root = nodes[0]
        self._check_alive(root)
        if deadline is None and min_participants is None:
            return self._allreduce_full(
                nodes, target_id, list(source_ids), op, hard_deadline
            )
        return self._allreduce_bounded(
            nodes, target_id, list(source_ids), op, hard_deadline,
            deadline, min_participants,
        )

    def _allreduce_full(
        self,
        nodes: Sequence[int],
        target_id: str,
        source_ids: List[str],
        op: ReduceOp,
        deadline: float,
        skip_await: FrozenSet[int] = frozenset(),
    ) -> str:
        """The unbounded fused collective (every source folds in).
        ``skip_await`` nodes still get the result prefetched toward them,
        but their completion is not awaited -- bounded-time mode uses it
        so a cut straggler's slow inbound leg cannot hold the collective
        past the cut."""
        root = nodes[0]
        first = self._wait_any_meta(source_ids, deadline)
        meta = self.meta[first]
        dtype, shape = meta
        size = math.prod(shape) * dtype.itemsize
        policy = allreduce_policy(
            len(nodes),
            self.link,
            size,
            chunk=float(self.chunk_size_for(size)),
            egress_sharing=False,
        )

        def start_receivers():
            return [
                (n, self.prefetch_async(n, target_id, timeout=max(0.0, deadline - time.time())))
                for n in dict.fromkeys(nodes)
                if n != root
            ]

        futs = []
        if policy.fused:
            # Advertise the producing target BEFORE the receivers start:
            # their fetches subscribe to its feasibility transition
            # instead of racing the root's first publication.
            self._advertise_reduce_target(root, target_id, dtype, shape, size)
            # Start the receivers before the reduce: each ``Thread.start``
            # waits for this thread to be scheduled again, which a loaded
            # host can hold off for longer than the whole reduce takes, so
            # receivers started after it could only store and forward.
            futs = start_receivers()
        red: Future = Future()

        def run_reduce():
            try:
                red.set_result(
                    self.reduce(root, target_id, source_ids, op,
                                timeout=max(0.0, deadline - time.time()), _meta=meta)
                )
            except BaseException as e:  # noqa: BLE001
                red.set_exception(e)

        self._spawn(run_reduce)
        if not policy.fused:
            red.result(timeout=max(0.0, deadline - time.time()))
            futs = start_receivers()
        red.result(timeout=max(0.0, deadline - time.time()))
        for n, f in futs:
            if n in skip_await:
                # Cut straggler: its inbound copy keeps streaming in the
                # background (eventual delivery), but must not gate the
                # collective.  Swallow its eventual error, if any.
                f.add_done_callback(lambda fu: fu.exception())
                continue
            try:
                f.result(timeout=max(0.0, deadline - time.time()))
            except Exception:
                # A receiver that DRAINED mid-collective left on purpose
                # and no longer needs its inbound copy: drop it from the
                # await set instead of failing the collective.  Crashes
                # (kills) still raise -- only planned departures are
                # forgiven.
                with self._dir_lock:
                    left = n in self._drained or n in self.draining
                if not left:
                    raise
        # Full participation (still an ``AllreduceResult`` so callers can
        # uniformly read ``dropped``/``mask`` -- a streaming collective
        # that absorbed member churn reports dropped == () here).
        return AllreduceResult(
            target_id, participants=list(source_ids), dropped=(),
            mask=tuple(True for _ in source_ids), cut=False,
        )

    def _allreduce_bounded(
        self,
        nodes: Sequence[int],
        target_id: str,
        source_ids: List[str],
        op: ReduceOp,
        hard_deadline: float,
        deadline: Optional[float],
        min_participants: Optional[int],
    ) -> AllreduceResult:
        """Bounded-time allreduce: wait for all sources until the soft
        ``deadline``, then fold as soon as >= k are ready (see
        ``allreduce``).  Sources that can NEVER arrive (lost/failed) do
        not count toward the quorum; if fewer than k can ever arrive the
        collective raises ObjectLost rather than folding below quorum."""
        root = nodes[0]
        k = bounded_time_participants(len(source_ids), min_participants)
        cut_ts = hard_deadline if deadline is None else min(
            hard_deadline, time.time() + deadline
        )

        def ready_ids() -> List[str]:
            """Sources whose bytes are foldable NOW (inline entry or a
            COMPLETE copy at a live node).  Caller holds the dir lock."""
            ready = []
            for oid in source_ids:
                if self.directory.get_inline(oid) is not None:
                    ready.append(oid)
                    continue
                if any(
                    l.progress is Progress.COMPLETE and l.node not in self.dead
                    for l in self.directory.locations(oid)
                ):
                    ready.append(oid)
            return ready

        def check_quorum_reachable(ready: List[str]) -> None:
            arrivable = sum(
                1
                for oid in source_ids
                if oid in ready or not self._object_lost(oid)
            )
            if arrivable < k:
                raise ObjectLost(
                    f"allreduce {target_id}: only {arrivable}/{len(source_ids)}"
                    f" contributions can ever arrive (quorum k={k})"
                )

        def attempt_all():
            ready = ready_ids()
            if len(ready) == len(source_ids):
                return ready
            check_quorum_reachable(ready)
            return None

        def attempt_quorum():
            ready = ready_ids()
            if len(ready) >= k:
                return ready
            check_quorum_reachable(ready)
            return None

        sc = StageClock(self._stats, self.trace, root, target_id,
                        stage=STAGE_PRODUCER_WAIT)
        try:
            if deadline is None:
                # No grace period: fold the moment the quorum is ready.
                sc.switch(STAGE_STRAGGLER_CUT)
                ready = self._await_directory(
                    source_ids, attempt_quorum, cut_ts,
                    what=f"allreduce {target_id}: quorum of {k} never ready",
                )
            else:
                try:
                    ready = self._await_directory(
                        source_ids, attempt_all, cut_ts,
                        what=f"allreduce {target_id} soft deadline",
                    )
                except TimeoutError:
                    # Soft deadline hit with stragglers outstanding: now
                    # wait (only) for the k-of-n quorum, against the hard
                    # deadline.  Time spent here is the cut's cost and is
                    # attributed to the straggler-cut stage.
                    sc.switch(STAGE_STRAGGLER_CUT)
                    ready = self._await_directory(
                        source_ids, attempt_quorum, hard_deadline,
                        what=f"allreduce {target_id}: quorum of {k} never ready",
                    )
        finally:
            sc.close()

        ready_set = set(ready)
        protected = [
            oid for oid in source_ids
            if oid not in ready_set and self._drain_protected(oid)
        ]
        if protected:
            # An outstanding source is mid-handoff from a *draining*
            # member (planned departure, not a straggler): wait for its
            # evacuated copy against the hard deadline before cutting, so
            # a drain is never counted in ``dropped`` / ``straggler_cuts``.
            def attempt_handoffs():
                r = ready_ids()
                rs = set(r)
                if all(oid in rs or self._object_lost(oid) for oid in protected):
                    return r
                return None

            try:
                ready = self._await_directory(
                    source_ids, attempt_handoffs, hard_deadline,
                    what=f"allreduce {target_id}: drain handoff never landed",
                )
                ready_set = set(ready)
            except TimeoutError:
                pass  # hard deadline: fall back to the straggler cut

        chosen = [oid for oid in source_ids if oid in ready_set]
        dropped = [oid for oid in source_ids if oid not in ready_set]
        mask = tuple(oid in ready_set for oid in source_ids)
        if dropped:
            self._stats.straggler_cuts += 1
            self._stats.dropped_contributions += len(dropped)
            if self.trace.enabled:
                self.trace.instant(
                    CAT_CHAIN, "straggler-cut", root, target_id,
                    kept=len(chosen), dropped=list(dropped), k=k,
                )
        # When nodes pair 1:1 with sources (the SPMD layout), a dropped
        # source marks its node a straggler: the result still streams
        # toward it, but the collective stops waiting on it.
        skip: FrozenSet[int] = frozenset()
        if dropped and len(nodes) == len(source_ids):
            skip = frozenset(
                n
                for n, oid in zip(nodes, source_ids)
                if oid not in ready_set and n != root
            )
        self._allreduce_full(
            nodes, target_id, chosen, op, hard_deadline, skip_await=skip
        )
        return AllreduceResult(
            target_id, participants=chosen, dropped=dropped, mask=mask,
            cut=bool(dropped),
        )

    def _reduce_async(self, node, target_id, source_ids, op, deadline, meta=None) -> Future:
        fut: Future = Future()

        def run():
            try:
                fut.set_result(
                    self._reduce_chain_blocking(
                        node, target_id, source_ids, op, deadline, meta=meta
                    )
                )
            except BaseException as e:  # noqa: BLE001
                fut.set_exception(e)

        self._spawn(run)
        return fut

    def _advertise_reduce_target(self, node, target_id, dtype, shape, size) -> None:
        """Publish ``target_id`` as a *producing* partial at its receiver
        before the first reduced byte exists: fused-allreduce receivers
        (and a 2-D top chain) can subscribe to its watermark now, and the
        stuck-cohort detector knows this copy is generated locally rather
        than fed by another copy."""
        with self._dir_lock:
            self._check_alive(node)
            self.directory.revive(target_id)  # explicit re-reduce clears tombstone
            self.meta[target_id] = (dtype, tuple(shape))
            self.directory.publish_partial(target_id, node, size, producing=True)

    def _wait_any_meta(self, source_ids, deadline) -> str:
        def attempt():
            for oid in source_ids:
                if oid in self.meta:
                    return oid
            if all(self.directory.is_deleted(oid) for oid in source_ids):
                # Every source was created and deleted (request cancelled
                # mid-reduce): no metadata is ever coming.
                raise ObjectLost(f"reduce: all sources deleted: {list(source_ids)}")
            return None

        return self._await_directory(
            source_ids, attempt, deadline, what="reduce: no source metadata"
        )

    def _first_location(self, source_ids, deadline, fallback: Optional[int] = None) -> int:
        """Node of the first-ready source in a group (sub-coordinator).

        A source may exist only as a directory inline entry (its producing
        node died after a small-object Put); it has no location, so the
        group is coordinated at ``fallback`` instead of blocking until the
        deadline.

        Locations stranded at dead nodes (a kill that raced the directory
        cleanup, or a failover that resurrected a replica's stale view)
        are dropped on sight: they must not keep ``_object_lost`` false,
        or a group whose every candidate is stale/dead would spin hunting
        a coordinator until the deadline instead of raising ObjectLost."""

        def attempt():
            inline_ready = False
            all_lost = True
            for oid in source_ids:
                for l in self.directory.locations(oid):
                    if l.node in self.dead:
                        self.directory.drop_location(oid, l.node)
                        continue
                    if l.progress is Progress.COMPLETE:
                        return l.node
                inline_ready = inline_ready or self.directory.get_inline(oid) is not None
                all_lost = all_lost and self._object_lost(oid)
            if inline_ready and fallback is not None:
                return fallback
            if all_lost:
                # Every source in the group was created and then vanished
                # (failures/deletes): fail fast so the caller's recovery
                # runs, instead of hunting a coordinator until deadline.
                raise ObjectLost(f"reduce group lost all sources: {list(source_ids)}")
            return None

        return self._await_directory(
            source_ids, attempt, deadline, what="reduce: no group coordinator"
        )

    def _reduce_chain_blocking(
        self,
        node: int,
        target_id: str,
        source_ids: List[str],
        op: ReduceOp,
        deadline,
        meta: Optional[Tuple] = None,
    ) -> str:
        """Arrival-order 1-D chain driven by directory completion events.

        Each source id carries its own subscription; a publication pushes
        that id onto the ready queue, so the loop examines only the ids
        that actually changed -- O(events) total work instead of the old
        O(pending^2) full re-scan on every cluster-global wakeup."""
        chain = ChainState(node, tag=target_id, epoch=self.membership_epoch)
        handle = _ChainHandle(chain, node)
        hop_futures: List[Future] = []
        intermediates: List[str] = []  # chain-generated partials to reclaim
        if meta is None:
            first = self._wait_any_meta(source_ids, deadline)
            meta = self.meta[first]
        dtype, shape = meta
        size = math.prod(shape) * dtype.itemsize
        self._advertise_reduce_target(node, target_id, dtype, shape, size)
        with self._dir_lock:
            # Register the chain for member-change splices (2-D group
            # chains register under their sub-target ids: a joiner can be
            # spliced into whichever chain the caller names).
            self._active_chains[target_id] = handle
        try:
            return self._run_chain(
                chain, node, target_id, source_ids, op, deadline,
                dtype, shape, hop_futures, intermediates, handle,
            )
        except BaseException:
            # Withdraw the producing advertisement (and fail any partial
            # target buffer) so fused receivers chasing this target
            # observe the loss NOW instead of riding their deadlines.
            self._abandon_partial(node, target_id, always_drop=True)
            raise
        finally:
            with handle.lock:
                handle.closed = True  # no splice can land past this point
            with self._dir_lock:
                if self._active_chains.get(target_id) is handle:
                    del self._active_chains[target_id]
            # Reclaim chain partials on success AND failure (hop outputs
            # are pinned at their nodes; a failed reduce must not leak one
            # pinned set per retry).  Deleting an intermediate a still-
            # running hop consumes fails its buffer, waking that hop into
            # its own error path instead of its deadline.
            for iid in intermediates:
                self.delete(iid)

    def _run_chain(
        self, chain, node, target_id, source_ids, op, deadline,
        dtype, shape, hop_futures, intermediates, handle=None,
    ) -> str:
        pending = set(source_ids)
        ready_q: collections.deque = collections.deque()
        ev = threading.Event()
        spliced: set = set()  # member-change splices admitted to ``pending``

        def cb(oid):
            ready_q.append(oid)
            ev.set()

        ids = list(dict.fromkeys(source_ids))
        with self._dir_lock:
            for oid in ids:
                self.directory.subscribe(oid, cb)  # fires now if already published
            self._membership_waiters.add(ev)
            # Seed every id once: a source lost BEFORE we subscribed has no
            # locations left to fire an event, but must still be examined
            # (and fail the reduce) on the first pass.
            ready_q.extend(ids)
            ev.set()
        if handle is not None:
            with handle.lock:
                handle.wake = ev  # splice_contribution wakes the loop

        def admit_splices() -> None:
            """Move accepted member-change tail splices (a joiner's late
            contribution) into the pending set.  Runs on the coordinator
            thread only, so ``pending`` stays single-threaded --
            ``splice_contribution`` merely queues ids under the handle
            lock and sets ``ev``."""
            if handle is None:
                return
            with handle.lock:
                extra = [o for o in handle.extra_pending
                         if o not in pending and o not in spliced]
                handle.extra_pending.clear()
            if not extra:
                return
            with self._dir_lock:
                for oid in extra:
                    self.directory.subscribe(oid, cb)
                ready_q.extend(extra)
                ev.set()
            spliced.update(extra)
            ids.extend(o for o in extra if o not in ids)  # finally-unsubscribe
            pending.update(extra)

        try:
            while True:
                admit_splices()
                if not pending:
                    if handle is None:
                        break
                    # Close the tail-splice window race-free: a splice
                    # accepted after admit_splices() above would be
                    # stranded, so only flip the chain inactive while the
                    # handle lock shows the splice queue empty.
                    with handle.lock:
                        if not handle.extra_pending:
                            handle.chain_active = False
                            break
                    continue
                remaining = deadline - time.time()
                if remaining <= 0 or not ev.wait(timeout=remaining):
                    raise TimeoutError(f"reduce: sources never ready: {pending}")
                ev.clear()
                # The receiver itself may have been killed mid-chain
                # (membership events wake us): fail fast, the reduce can
                # never complete into a dead node.
                self._check_alive(node)
                while ready_q:
                    oid = ready_q.popleft()
                    if oid not in pending:
                        continue
                    with self._dir_lock:
                        live = [
                            l
                            for l in self.directory.locations(oid)
                            if l.node not in self.dead
                        ]
                        complete = [
                            l for l in live if l.progress is Progress.COMPLETE
                        ]
                        # Streaming admission: a *producing* partial (a
                        # reduce target still being reduced into) joins the
                        # chain as soon as its watermark turns positive --
                        # its bytes below the watermark are final.  This is
                        # what lets the 2-D top chain start before any
                        # group completes.
                        producing = []
                        if not complete:
                            for l in live:
                                if not l.producing:
                                    continue
                                buf = self.stores[l.node].get(oid)
                                if buf is not None and buf.bytes_present > 0:
                                    producing.append(l)
                        has_inline = self.directory.get_inline(oid) is not None
                        lost = (
                            not complete
                            and not producing
                            and not has_inline
                            and not any(l.producing for l in live)
                            and self._object_lost(oid)
                        )
                    if lost:
                        # This source was created and then lost for good
                        # (delete / failure drop): fail the reduce now, the
                        # framework's recovery owns it (section 7).
                        raise ObjectLost(oid)
                    if not complete and not producing and not has_inline:
                        continue  # partial publication; progress will re-fire
                    if complete:
                        src = complete[0].node
                    elif producing:
                        src = producing[0].node
                    else:
                        src = node
                    pending.discard(oid)
                    if oid in spliced:
                        # Epoch-versioned member-change splice: the joiner
                        # becomes the new chain tail -- same ``op(a, b)``
                        # association as any start-time member, but
                        # counted/logged separately from failure
                        # re-splices (``resplices`` stays exact).
                        hop = chain.splice_source(src, oid, self.membership_epoch)
                        self._stats.splices_join += 1
                        if self.trace.enabled:
                            self.trace.instant(
                                CAT_CHAIN, "splice-join", node, target_id,
                                reason=RESPLICE_MEMBER_CHANGE, source=oid,
                                mode="tail", epoch=chain.epoch,
                            )
                    else:
                        hop = chain.on_ready(src, oid)
                    if hop is not None:
                        intermediates.append(hop.out_object)
                        hop_futures.append(
                            self._exec_hop_async(
                                hop, dtype, shape, op, deadline, chain.lineage
                            )
                        )
        finally:
            if handle is not None:
                with handle.lock:
                    handle.chain_active = False
                    handle.wake = None
            with self._dir_lock:
                for oid in ids:
                    self.directory.unsubscribe(oid, cb)
                self._membership_waiters.discard(ev)
        return self._finalize_chain(
            chain, node, target_id, op, deadline, dtype, shape, hop_futures,
            handle,
        )

    def _finalize_chain(
        self, chain, node, target_id, op, deadline, dtype, shape, hop_futures,
        handle=None,
    ) -> str:
        """Stream the chain tail + receiver-local sources into the pinned
        target buffer window-by-window, gated on every input's watermark.

        This replaces the old materialize-then-Put finalization: the
        target's watermark (and its directory progress) now advances
        WHILE the chain is still producing, which is what fused-allreduce
        receivers and a 2-D top chain chase.  If the tail's node dies
        mid-stream, the chain is re-spliced: the lost partial is re-folded
        from still-live copies (``_rebuild_partial``) and the fold resumes
        from the target's own watermark -- prefix bytes are never
        recomputed."""
        size = math.prod(shape) * dtype.itemsize
        final = chain.final_hop(target_id + "#in")
        sc = StageClock(self._stats, self.trace, node, target_id)
        with self._dir_lock:
            self._check_alive(node)
            if self.directory.is_deleted(target_id):
                raise ObjectLost(target_id)
            existing = self.stores[node].get(target_id)
            if existing is not None and existing.complete:
                # Objects are immutable once complete: re-reducing into an
                # existing id must fail LOUDLY (the old put_array path
                # raised here), not silently re-publish the stale bytes.
                raise ObjectAlreadyExists(target_id)
            out = self.stores[node].create(
                target_id, size, pinned=True, chunk_size=self.chunk_size_for(size)
            )
            self.directory.publish_partial(target_id, node, size, producing=True)
            locals_in: List[Tuple[ChunkedBuffer, str, Optional[int]]] = []
            for oid in chain.local_objects:
                buf = self.stores[node].get(oid)
                if buf is None:
                    inline = self.directory.get_inline(oid)
                    if inline is None:
                        raise ObjectLost(oid)
                    buf = ChunkedBuffer.from_array(
                        inline, chunk_size=self.chunk_size_for(size)
                    )
                locals_in.append((buf, oid, None))
        assert final is not None or locals_in, "empty reduce"

        if final is not None:
            src_node, src_buf = self._resolve_tail(final, node, chain.lineage,
                                                   dtype, shape, op, deadline,
                                                   stage=sc, chain=chain)
        else:
            src_node, src_buf = None, None
        # Freeze the fold's input set: accepted late *side* splices join
        # as extra operands now; later offers are rejected (the first
        # window makes the target's prefix bytes immutable).
        late_inputs = self._drain_side_splices(handle, chain, node, target_id)
        need_rebuild = False
        cause: Optional[int] = None  # node whose loss forced the rebuild
        rebuild_avoid: FrozenSet[int] = frozenset()
        while True:
            if need_rebuild:
                if final is not None:
                    # Tail died / was abandoned / stalled mid-stream:
                    # re-splice -- fold resumes from the target's own
                    # watermark below, with a replacement rebuilt from
                    # still-live copies (stalled holders soft-avoided).
                    # A *drained* tail holder is a planned handoff, not a
                    # failure: it counts in ``splices_drain`` (and its
                    # own instant), never in ``resplices``.
                    sc.switch(STAGE_RESPLICE)
                    if self._is_drain_handoff(cause):
                        self._stats.splices_drain += 1
                        chain.note_drain_handoff(
                            final.src_object, self.membership_epoch
                        )
                        if self.trace.enabled:
                            self.trace.instant(
                                CAT_CHAIN, "splice-drain", node, target_id,
                                reason=RESPLICE_MEMBER_CHANGE,
                                rebuilt=final.src_object,
                                at=out.bytes_present, drained=cause,
                            )
                    else:
                        self._stats.resplices += 1
                        if self.trace.enabled:
                            self.trace.instant(
                                CAT_CHAIN, "resplice", node, target_id,
                                rebuilt=final.src_object, at=out.bytes_present,
                            )
                    src_node, src_buf = node, self._rebuild_partial(
                        node, final.src_object, chain.lineage, dtype, shape, op,
                        deadline, avoid=rebuild_avoid,
                    )
                # Re-resolve side-splice inputs whose holder left
                # (drained/died) mid-fold: another live copy or the
                # directory inline entry takes over.
                for i, (b_i, oid_i, src_i) in enumerate(late_inputs):
                    if b_i.failed or (src_i is not None and src_i in self.dead):
                        late_inputs[i] = self._side_input(node, oid_i)
                need_rebuild = False
                cause = None
            inputs: List[Tuple[ChunkedBuffer, str, Optional[int]]] = []
            if src_buf is not None:
                inputs.append(
                    (src_buf, final.src_object, src_node if src_node != node else None)
                )
            inputs.extend(locals_in)
            inputs.extend(late_inputs)
            epoch = None
            if src_node is not None and src_node != node:
                with self._dir_lock:
                    epoch = self.directory.charge_source(final.src_object, src_node)
                    self._stats.note_outbound(
                        src_node, self.directory.outbound_load(src_node)
                    )
            try:
                self._stream_fold(
                    node, inputs, out, dtype, op, deadline,
                    object_id=target_id, start=out.bytes_present,
                    publish_progress=True, stage=sc,
                    stall_rebuildable=(
                        final is not None
                        and chain.lineage.get(final.src_object) is not None
                    ),
                )
                break
            except DeadNode as e:
                if e.node_id == node or (final is None and not late_inputs):
                    raise
                need_rebuild = True
                cause = e.node_id
            except StaleBuffer:
                if final is None and not late_inputs:
                    raise ObjectLost(target_id)
                need_rebuild = True
                cause = src_node if src_node != node else None
            except SourceStalled as e:
                # The tail wedged (not died) past the stall budget: evict
                # it and re-splice from lineage / a live copy elsewhere,
                # resuming from the target watermark.
                if final is None and not late_inputs:
                    raise ObjectLost(target_id)
                self._stats.stall_replans += 1
                if self.trace.enabled:
                    self.trace.instant(
                        CAT_CHAIN, "replan", node, target_id,
                        reason="source-stalled", src=e.node,
                    )
                need_rebuild = True
                if e.node is not None:
                    rebuild_avoid = frozenset({e.node})
            finally:
                if epoch is not None:
                    with self._dir_lock:
                        self.directory.release_source(final.src_object, src_node, epoch)
        sc.close()
        # Hop futures are reaped leniently: the target's bytes are already
        # complete and correct, and a hop we re-spliced around legitimately
        # errored.  Genuine source loss surfaced through the fold above.
        for f in hop_futures:
            try:
                f.result(timeout=max(0.0, deadline - time.time()))
            except Exception:  # noqa: BLE001
                pass
        with self._dir_lock:
            if node in self.dead:
                raise DeadNode(str(node))
            if self.directory.is_deleted(target_id) or target_id not in self.meta:
                self.stores[node].delete(target_id)
                self.directory.drop_location(target_id, node)
                raise ObjectLost(target_id)
            if size < SMALL_OBJECT_THRESHOLD:
                self.directory.publish_inline(
                    target_id, out.to_array(dtype, shape).clone(), size
                )
            self.directory.publish_complete(target_id, node, size)
        return target_id

    def _drain_side_splices(
        self, handle, chain, node, target_id
    ) -> List[Tuple[ChunkedBuffer, str, Optional[int]]]:
        """Freeze the finalization fold's input set and admit accepted
        late *side* contributions (member-change splices that arrived
        after the chain coordinator closed).  Flipping ``fold_frontier``
        positive under the handle lock is what makes the freeze race-free:
        ``splice_contribution`` holds the same lock for its tail/side/
        reject decision, so an offer either lands in ``late`` before the
        freeze or is rejected after it.  Returns the extra
        ``_stream_fold`` inputs -- exact by associativity/commutativity of
        the elementwise op."""
        if handle is None:
            return []
        with handle.lock:
            late_ids = list(handle.late)
            handle.late.clear()
            handle.fold_frontier = 1  # inputs frozen: reject from now on
        inputs: List[Tuple[ChunkedBuffer, str, Optional[int]]] = []
        for oid in late_ids:
            entry = self._side_input(node, oid)
            chain.splice_side(oid, self.membership_epoch)
            self._stats.splices_join += 1
            if self.trace.enabled:
                self.trace.instant(
                    CAT_CHAIN, "splice-join", node, target_id,
                    reason=RESPLICE_MEMBER_CHANGE, source=oid,
                    mode="side", epoch=chain.epoch,
                )
            inputs.append(entry)
        return inputs

    def _side_input(
        self, node: int, oid: str
    ) -> Tuple[ChunkedBuffer, str, Optional[int]]:
        """Fold input (buffer, oid, src_node) for a member-change side
        contribution: a live COMPLETE/producing copy anywhere (streamed,
        gated on its watermark like any fold input), else the directory
        inline entry.  Raises ObjectLost when no copy survives."""
        with self._dir_lock:
            for l in self.directory.locations(oid):
                if l.node in self.dead:
                    continue
                b = self.stores[l.node].get(oid)
                if b is None or b.failed:
                    continue
                if l.progress is Progress.COMPLETE or l.producing:
                    return (b, oid, l.node if l.node != node else None)
            inline = self.directory.get_inline(oid)
        if inline is not None:
            return (
                ChunkedBuffer.from_array(inline, stats=self._stats),
                oid,
                None,
            )
        raise ObjectLost(oid)

    def _resolve_tail(self, final, node, lineage, dtype, shape, op, deadline,
                      stage: Optional[StageClock] = None, chain=None):
        """Locate the chain tail's buffer for the final fold, waiting for
        the producing hop thread to create it (the hop-start race), or
        rebuilding it locally when its node already died."""

        def attempt():
            if node in self.dead:
                raise DeadNode(str(node))
            if final.src_node in self.dead:
                return ("rebuild",)
            src_buf = self.stores[final.src_node].get(final.src_object)
            if src_buf is None or src_buf.failed:
                if self._object_lost(final.src_object):
                    return ("rebuild",)
                if stage is not None:
                    stage.switch(STAGE_PRODUCER_WAIT)
                return None  # upstream hop has not created its output yet
            return ("ok", src_buf)

        got = self._await_directory(
            [final.src_object], attempt, deadline,
            what=f"reduce: tail {final.src_object} never appeared",
        )
        if got[0] == "rebuild":
            if stage is not None:
                stage.switch(STAGE_RESPLICE)
            if self._is_drain_handoff(final.src_node):
                # Planned departure of the tail holder: a handoff, never a
                # failure re-splice (``resplices`` must stay exact).
                self._stats.splices_drain += 1
                if chain is not None:
                    chain.note_drain_handoff(
                        final.src_object, self.membership_epoch
                    )
                if self.trace.enabled:
                    self.trace.instant(
                        CAT_CHAIN, "splice-drain", node, final.src_object,
                        reason=RESPLICE_MEMBER_CHANGE,
                        rebuilt=final.src_object, at=0,
                        drained=final.src_node,
                    )
            else:
                self._stats.resplices += 1
                if self.trace.enabled:
                    self.trace.instant(
                        CAT_CHAIN, "resplice", node, final.src_object,
                        rebuilt=final.src_object, at=0,
                    )
            return node, self._rebuild_partial(
                node, final.src_object, lineage, dtype, shape, op, deadline
            )
        return final.src_node, got[1]

    def _exec_hop_async(self, hop, dtype, shape, op, deadline, lineage) -> Future:
        """Run one chain hop: dst streams src's partial result in and
        reduces it with its local object window-by-window.  If the
        upstream node dies (or its buffer is abandoned) mid-stream, the
        hop RE-SPLICES: the lost partial is re-folded from still-live
        copies via the chain lineage and the fold resumes from this hop's
        own output watermark -- no subtree restart, prefix bytes kept."""
        fut: Future = Future()

        def run():
            size = math.prod(shape) * dtype.itemsize
            try:

                def attempt():
                    """The upstream hop's thread may not have created its
                    output buffer yet: wait for its publish_partial event
                    instead of failing (or polling) -- the hop-start race."""
                    if hop.dst_node in self.dead:
                        raise ObjectLost(hop.out_object)
                    local_buf = self.stores[hop.dst_node].get(hop.dst_object)
                    if local_buf is None:
                        raise ObjectLost(hop.dst_object)
                    rebuild = False
                    src_buf = self.stores[hop.src_node].get(hop.src_object)
                    if hop.src_node in self.dead:
                        rebuild = True
                    elif src_buf is None or src_buf.failed:
                        if self._object_lost(hop.src_object):
                            # Deleted/lost upstream: never coming as-is --
                            # fall through to the lineage rebuild.
                            rebuild = True
                        else:
                            return None
                    self.meta[hop.out_object] = (dtype, tuple(shape))
                    out = self.stores[hop.dst_node].create(
                        hop.out_object, size, pinned=True,
                        chunk_size=self.chunk_size_for(size),
                    )
                    self.directory.publish_partial(
                        hop.out_object, hop.dst_node, size, producing=True
                    )
                    return src_buf, local_buf, out, rebuild

                src_buf, local_buf, out, need_rebuild = self._await_directory(
                    [hop.src_object],
                    attempt,
                    deadline,
                    what=f"reduce hop: source {hop.src_object} never appeared",
                )
                with self._stats_lock:
                    self._stats.note_reduce_hop(hop.dst_node)
                sc = StageClock(
                    self._stats, self.trace, hop.dst_node, hop.out_object
                )
                if self.trace.enabled:
                    self.trace.instant(
                        CAT_CHAIN, "hop-start", hop.dst_node, hop.out_object,
                        src=hop.src_node, src_object=hop.src_object,
                    )
                src_node = hop.src_node
                cause: Optional[int] = hop.src_node if need_rebuild else None
                rebuild_avoid: FrozenSet[int] = frozenset()
                while True:
                    if need_rebuild:
                        sc.switch(STAGE_RESPLICE)
                        if self._is_drain_handoff(cause):
                            # The upstream holder *drained*: its chain
                            # position hands off to this hop (the rebuild
                            # below resumes the fold byte-identically) --
                            # a ``splices_drain`` event, never a failure
                            # ``resplice``.
                            self._stats.splices_drain += 1
                            if self.trace.enabled:
                                self.trace.instant(
                                    CAT_CHAIN, "splice-drain", hop.dst_node,
                                    hop.out_object,
                                    reason=RESPLICE_MEMBER_CHANGE,
                                    rebuilt=hop.src_object,
                                    at=out.bytes_present, drained=cause,
                                )
                        else:
                            self._stats.resplices += 1
                            if self.trace.enabled:
                                self.trace.instant(
                                    CAT_CHAIN, "resplice", hop.dst_node,
                                    hop.out_object, rebuilt=hop.src_object,
                                    at=out.bytes_present,
                                )
                        src_buf = self._rebuild_partial(
                            hop.dst_node, hop.src_object, lineage,
                            dtype, shape, op, deadline, avoid=rebuild_avoid,
                        )
                        src_node = hop.dst_node
                        need_rebuild = False
                        cause = None
                    epoch = None
                    if src_node != hop.dst_node:
                        with self._dir_lock:
                            epoch = self.directory.charge_source(
                                hop.src_object, src_node
                            )
                            self._stats.note_outbound(
                                src_node, self.directory.outbound_load(src_node)
                            )
                    try:
                        self._stream_fold(
                            hop.dst_node,
                            [
                                (src_buf, hop.src_object,
                                 src_node if src_node != hop.dst_node else None),
                                (local_buf, hop.dst_object, None),
                            ],
                            out,
                            dtype,
                            op,
                            deadline,
                            object_id=hop.out_object,
                            start=out.bytes_present,
                            stage=sc,
                            stall_rebuildable=lineage.get(hop.src_object)
                            is not None,
                        )
                        break
                    except DeadNode as e:
                        if e.node_id == hop.dst_node:
                            raise ObjectLost(hop.out_object)
                        need_rebuild = True  # re-splice from out watermark
                        cause = e.node_id
                    except StaleBuffer:
                        need_rebuild = True
                        cause = src_node if src_node != hop.dst_node else None
                    except SourceStalled as e:
                        # Wedged upstream partial: evict, re-splice from
                        # lineage / another live copy, resume the fold
                        # from this hop's own output watermark.
                        self._stats.stall_replans += 1
                        if self.trace.enabled:
                            self.trace.instant(
                                CAT_CHAIN, "replan", hop.dst_node,
                                hop.out_object, reason="source-stalled",
                                src=e.node,
                            )
                        need_rebuild = True
                        if e.node is not None:
                            rebuild_avoid = frozenset({e.node})
                    finally:
                        if epoch is not None:
                            with self._dir_lock:
                                self.directory.release_source(
                                    hop.src_object, src_node, epoch
                                )
                sc.close()
                with self._dir_lock:
                    if hop.dst_node in self.dead:
                        raise ObjectLost(hop.out_object)
                    self.directory.publish_complete(hop.out_object, hop.dst_node, size)
                fut.set_result(hop.out_object)
            except BaseException as e:  # noqa: BLE001
                # Mark the output lost -- tombstone + notify + fail any
                # half-built buffer -- so downstream consumers wake NOW
                # and re-splice around this hop (or observe the loss)
                # instead of riding deadlines.  This must happen even when
                # the hop died BEFORE creating its buffer (e.g. its local
                # operand vanished): a consumer waiting for the output to
                # appear has no other event coming.
                self.delete(hop.out_object)
                fut.set_exception(e)

        self._spawn(run)
        return fut

    def _stream_fold(
        self,
        dst: int,
        inputs: List[Tuple[ChunkedBuffer, str, Optional[int]]],
        out: ChunkedBuffer,
        dtype,
        op,
        deadline,
        object_id: str = "",
        start: int = 0,
        publish_progress: bool = False,
        stage: Optional[StageClock] = None,
        stall_rebuildable: bool = False,
    ):
        """out[w] = fold(op, inputs[0][w], inputs[1][w], ...) window-by-
        window, gated on EVERY input's watermark -- the streaming add of a
        reduce hop and of the chain finalization, vectorized over all
        bytes available per wakeup.  Each window is timed from every
        input's watermark in hand to the output's advance, as in
        ``_stream_copy`` (``window_issue_seconds``, ``window`` spans inside
        the ``fold-leg`` span).

        ``inputs`` entries are (buffer, object_id, src_node): ``src_node``
        names the remote holder of a streamed input (bytes-served
        accounting, DeadNode on its death), None for a receiver-local
        buffer.  A failed remote input raises DeadNode/StaleBuffer (the
        caller re-splices); a failed local input raises ObjectLost.
        ``start`` resumes a re-spliced fold from the output watermark --
        bytes below it were folded from identical prefixes and are final.

        Raises SourceStalled when a REMOTE input's watermark stops
        advancing past the stall budget while recovery is possible:
        ``stall_rebuildable`` means the caller can re-splice that input
        from its chain lineage; otherwise a live copy of the input
        elsewhere must exist.  A stalled local-only fold just waits (its
        producer is this node; there is nothing to evict).

        On a relaying comm backend (socket) each remote input is staged
        into a local relay buffer fed by its own comm stream (with the
        same backoff-reconnect + watermark-resume recovery as
        ``_stream_copy``); the fold then reads relay watermarks, so the
        fold logic -- and its failure taxonomy -- is identical on both
        backends.  A relay whose connection cannot be re-established
        fails its buffer, surfacing here as ``StaleBuffer`` (re-splice).
        """
        relay_close = None
        if self._comm.relays:
            inputs, relay_close = self._relay_fold_inputs(dst, inputs, start)
        itemsize = dtype.itemsize
        pos = start
        total = out.size
        window_cap = max(out.chunk_size, -(-total // PIPELINE_MIN_WINDOWS))
        window_cap += (-window_cap) % 64
        assert window_cap % itemsize == 0
        served: Dict[int, int] = {}
        reduced = 0
        fold_ops = 0
        first_pub = pos == 0
        last_advance = time.time()
        win_k = 0  # window ordinal (keys the injector's pure jitter draws)
        leg_t0 = self.trace.clock() if self.trace.enabled else None
        try:
            while pos < total:
                if time.time() > deadline:
                    raise TimeoutError(f"reduce fold {object_id} timed out")
                if stage is not None and any(
                    buf.bytes_present <= pos for buf, _oid, _src in inputs
                ):
                    stage.switch(STAGE_PRODUCER_WAIT)
                avail = total
                for buf, oid, src in inputs:
                    got = buf.wait_for_bytes(
                        pos + itemsize, timeout=self.ft.watermark_recheck_s
                    )
                    if dst in self.dead:
                        raise DeadNode(str(dst))
                    if src is not None:
                        if src in self.dead:
                            raise DeadNode(str(src))
                        if buf.failed:
                            raise StaleBuffer(f"{oid}@{src}")
                    elif buf.failed:
                        raise ObjectLost(oid)
                    avail = min(avail, got)
                t_win = time.perf_counter()
                # Whole elements only: a dtype view of the buffer must
                # start and end on an element (watermarks are aligned).
                avail -= (avail - pos) % itemsize
                if avail <= pos:
                    # No input advanced: a remote upstream may be wedged
                    # (not dead).  Past the stall budget, evict it and let
                    # the caller re-splice -- today only death/staleness
                    # interrupt a fold, so a straggling upstream would
                    # otherwise hold this hop until the hard deadline.
                    if time.time() - last_advance >= self.ft.stall_timeout:
                        culprit = self._fold_stalled_input(
                            dst, inputs, pos, stall_rebuildable
                        )
                        if culprit is not None:
                            c_src, c_oid = culprit
                            if self.trace.enabled:
                                self.trace.instant(
                                    CAT_STREAM, "watermark-stall", dst,
                                    c_oid, src=c_src, at=pos,
                                )
                            raise SourceStalled(
                                f"{c_oid}@{c_src}", node=c_src, object_id=c_oid
                            )
                    continue
                last_advance = time.time()
                if stage is not None:
                    stage.switch(STAGE_STREAMING)
                if self.pace:
                    avail = min(avail, pos + out.chunk_size)
                    time.sleep(self.pace)
                else:
                    avail = min(avail, pos + window_cap)
                if self.faults is not None:
                    # Injected noise on the fold's inbound legs: take the
                    # WORST penalty across remote inputs (the fold cannot
                    # outrun its slowest feed); a local-only fold models
                    # the receiver's own compute slowdown via (dst, dst).
                    base = self.pace or (avail - pos) / self.link.bandwidth
                    extra = max(
                        self.faults.window_penalty(
                            src if src is not None else dst, dst, win_k, base
                        )
                        for _buf, _oid, src in inputs
                    )
                    if extra > 0.0:
                        time.sleep(extra)
                # Fold straight into the output's window above its
                # watermark (no reader looks there), then advance it.
                dst_win = out.view(pos, avail).view(dtype)
                acc = inputs[0][0].view(pos, avail).view(dtype)
                if len(inputs) == 1:
                    copy_bytes(dst_win, acc)
                for buf, _oid, _src in inputs[1:]:
                    _fold_into(op, acc, buf.view(pos, avail).view(dtype), dst_win)
                    acc = dst_win
                fold_ops += len(inputs) - 1
                out.write_chunk(pos, None, end=avail)
                t_end = time.perf_counter()
                self._stats.note_window(t_end - t_win)
                window = avail - pos
                if self.trace.enabled:
                    self.trace.span(
                        CAT_STREAM, SPAN_WINDOW, dst, t_win, t_end - t_win, object_id,
                        src=tuple(src for _buf, _oid, src in inputs if src is not None),
                        bytes=window, inputs=len(inputs), k=win_k,
                        card_done=self.trace.card_event(out.device),
                    )
                win_k += 1
                if len(inputs) > 1:
                    reduced += window
                for _buf, _oid, src in inputs:
                    if src is not None:
                        served[src] = served.get(src, 0) + window
                first_window = pos == start
                pos = avail
                if publish_progress and first_pub and first_window and pos < total:
                    # 0 -> positive: the producing target just became a
                    # feasible source for fused-allreduce receivers and
                    # downstream chains; wake them.  One directory round
                    # trip per fold, never per window.
                    with self._dir_lock:
                        self.directory.update_progress(object_id, dst, pos)
        finally:
            if relay_close is not None:
                relay_close()
            if reduced or served or fold_ops:
                with self._stats_lock:
                    self._stats.fold_ops += fold_ops
                    if reduced:
                        self._stats.note_bytes_reduced(dst, reduced)
                    for src, nbytes in served.items():
                        self._stats.note_bytes_served(src, nbytes)
                        while src >= len(self.bytes_sent_per_node):
                            self.bytes_sent_per_node.append(0)  # joined node
                        self.bytes_sent_per_node[src] += nbytes
                    for src in served:
                        self.transfers.append((src, dst, object_id))
            if leg_t0 is not None:
                self.trace.span(
                    CAT_CHAIN, "fold-leg", dst,
                    leg_t0, self.trace.clock() - leg_t0,
                    object_id, inputs=len(inputs), bytes_reduced=reduced,
                    resume_from=start,
                )

    def _fold_stalled_input(
        self, dst: int, inputs, pos: int, rebuildable: bool
    ) -> Optional[Tuple[int, str]]:
        """Identify which remote fold input is wedging the fold at ``pos``
        -- and only if evicting it can actually help: the caller either
        re-splices it from lineage (``rebuildable``) or another live copy
        of it exists.  Returns (src_node, object_id) or None (keep
        waiting)."""
        for buf, oid, src in inputs:
            if src is None or buf.bytes_present > pos or buf.complete:
                continue
            if rebuildable:
                return src, oid
            with self._dir_lock:
                if any(
                    l.node not in (src, dst) and l.node not in self.dead
                    for l in self.directory.locations(oid)
                ):
                    return src, oid
        return None

    def _relay_fold_inputs(
        self, dst: int, inputs, start: int
    ) -> Tuple[list, Callable[[], None]]:
        """Relaying backends only: replace each remote fold input with a
        local relay :class:`ChunkedBuffer` fed by a pump thread that
        streams [start, size) through the comm backend.  The fold's
        watermark gating, stall detection and failure taxonomy then work
        on the relays exactly as they did on direct remote views.
        Returns (wrapped inputs, closer); the closer stops the pumps
        (they also exit on their own when the stream completes)."""
        stops: List[threading.Event] = []
        wrapped = []
        for buf, oid, src in inputs:
            if src is None or src == dst:
                wrapped.append((buf, oid, src))
                continue
            relay = ChunkedBuffer(buf.size, chunk_size=buf.chunk_size, stats=self._stats,
                                  device=self.device, trace=self.trace, object_id=oid, node=dst)
            stop = threading.Event()
            threading.Thread(
                target=self._relay_pump,
                args=(src, dst, oid, buf, relay, start, stop),
                daemon=True,
            ).start()
            stops.append(stop)
            wrapped.append((relay, oid, src))

        def close():
            for s in stops:
                s.set()

        return wrapped, close

    def _relay_pump(self, src, dst, object_id, src_buf, relay, start, stop):
        """Pump one remote fold input into its relay buffer.  Connection
        loss reconnects with backoff and resumes from the relay
        watermark; unrecoverable loss (source dead, retries exhausted,
        remote buffer failed) FAILS the relay so the fold observes
        ``StaleBuffer``/``DeadNode`` promptly instead of stalling."""
        pos = start
        total = relay.size
        window_cap = max(relay.chunk_size, -(-total // PIPELINE_MIN_WINDOWS))
        window_cap += (-window_cap) % 64
        try:
            stream = self._open_stream_with_retry(src, dst, object_id, src_buf, pos)
        except (DeadNode, SourceStalled):
            relay.fail()
            return
        try:
            while pos < total and not stop.is_set():
                try:
                    window = stream.recv(pos, window_cap, timeout=0.05)
                except RemoteBufferFailed:
                    relay.fail()
                    return
                except CommClosedError:
                    stream.close()
                    if src in self.dead:
                        relay.fail()
                        return
                    try:
                        stream = self._open_stream_with_retry(
                            src, dst, object_id, src_buf, pos, reconnect=True
                        )
                    except (DeadNode, SourceStalled):
                        relay.fail()
                        return
                    continue
                if src in self.dead or src_buf.failed:
                    relay.fail()
                    return
                if window is None:
                    continue
                relay.write_chunk(pos, window)
                pos += window.numel()
        finally:
            stream.close()

    def _rebuild_partial(
        self, node, object_id, lineage, dtype, shape, op, deadline,
        avoid: FrozenSet[int] = frozenset(),
    ) -> ChunkedBuffer:
        """Re-splice support: reconstruct a lost chain partial at ``node``
        from still-live state, byte-identical to the original.

        Preference order per object: a live copy anywhere (complete, or a
        producing partial we can chase to completion) is streamed in;
        otherwise the partial's lineage pair (a, b) is rebuilt recursively
        and re-folded with the SAME ``op(a, b)`` association the original
        hop used -- so the replacement's bytes match the lost partial's
        exactly and the resumed fold stays consistent with the prefix
        already in the output.  Raises ObjectLost when a contribution's
        every copy died with its node (framework recovery owns that).

        ``avoid`` soft-deprioritizes copies at nodes the caller stalled
        on (SourceStalled eviction): any other live copy, inline entry,
        or lineage rebuild wins first, but a stalled copy is still used
        as the last resort -- a slow rebuild beats a lost object.  A copy
        that stalls DURING the rebuild stream joins the avoid set and the
        scan re-runs, so a replica published mid-rebuild gets picked up."""
        avoid_set = set(avoid)

        def rebuild(oid: str) -> ChunkedBuffer:
            while True:
                if time.time() > deadline:
                    raise TimeoutError(f"re-splice rebuild of {oid} timed out")
                src = None
                avoided = None
                with self._dir_lock:
                    for l in self.directory.locations(oid):
                        if l.node in self.dead:
                            continue
                        buf = self.stores[l.node].get(oid)
                        if buf is None or buf.failed:
                            continue
                        if l.progress is Progress.COMPLETE or l.producing:
                            if l.node in avoid_set:
                                if avoided is None:
                                    avoided = (l.node, buf)
                                continue
                            src = (l.node, buf)
                            break
                    inline = self.directory.get_inline(oid)
                if src is None and inline is None and lineage.get(oid) is None:
                    src = avoided  # stalled copy beats ObjectLost
                if src is not None:
                    src_node, src_buf = src
                    if src_node == node:
                        # A local copy may still be producing: rebuild()
                        # guarantees COMPLETE buffers (the lineage fold
                        # below calls to_array), so chase it to the end;
                        # if its producer fails, re-scan for another copy.
                        while not src_buf.complete and not src_buf.failed:
                            if time.time() > deadline:
                                raise TimeoutError(f"re-splice rebuild of {oid} timed out")
                            src_buf.wait_for_bytes(
                                src_buf.size, timeout=self.ft.watermark_recheck_s
                            )
                        if src_buf.failed:
                            continue
                        return src_buf
                    staging = ChunkedBuffer(
                        src_buf.size, src_buf.chunk_size, stats=self._stats,
                        device=self.device, trace=self.trace, object_id=oid, node=node,
                    )
                    try:
                        self._stream_copy(src_node, node, src_buf, staging, oid)
                    except (DeadNode, StaleBuffer):
                        continue  # that copy died too; re-scan / recurse
                    except SourceStalled:
                        # The rebuild source wedged as well: deprioritize
                        # it and re-scan -- a copy published since (or the
                        # lineage pair) takes over.
                        avoid_set.add(src_node)
                        self._stats.stall_replans += 1
                        continue
                    return staging
                if inline is not None:
                    return ChunkedBuffer.from_array(inline)
                pair = lineage.get(oid)
                if pair is None:
                    raise ObjectLost(oid)
                a, b = pair
                folded = op(
                    rebuild(a).to_array(dtype, shape), rebuild(b).to_array(dtype, shape)
                )
                with self._stats_lock:
                    self._stats.fold_ops += 1
                return ChunkedBuffer.from_array(folded, stats=self._stats)

        return rebuild(object_id)

    def _fetch_from(self, node, object_id, src_node, deadline) -> ChunkedBuffer:
        """Stream a specific remote object into ``node`` (final chain hop)."""

        def attempt():
            if node in self.dead:
                raise DeadNode(str(node))
            if src_node in self.dead:
                # The chain tail died with its node: fail fast so the
                # caller's recovery path runs instead of riding the
                # deadline (the request-tail stall).
                raise DeadNode(str(src_node))
            src_buf = self.stores[src_node].get(object_id)
            if src_buf is None:
                return None
            dst_buf = self.stores[node].create(
                object_id, src_buf.size, pinned=False, chunk_size=src_buf.chunk_size
            )
            return src_buf, dst_buf

        src_buf, dst_buf = self._await_directory(
            [object_id], attempt, deadline, what=f"fetch {object_id}"
        )
        try:
            self._stream_copy(src_node, node, src_buf, dst_buf, object_id)
        except StaleBuffer as e:
            # The tail's copy was abandoned/restarted away: to the caller
            # that is loss of the chain partial, a recoverable condition
            # (lineage / k-of-n quorum), not an internal transport state.
            raise ObjectLost(object_id) from e
        finally:
            if not dst_buf.complete:
                # Never-published staging copy of a failed final hop: drop
                # it unless a concurrent *published* fetch shares it.
                with self._dir_lock:
                    published_here = any(
                        l.node == node
                        for l in self.directory.locations(object_id)
                    )
                    if not published_here:
                        self.stores[node].delete(object_id)
        return dst_buf

    # -- Delete / failures --------------------------------------------------------

    def delete(self, object_id: str):
        with self._dir_lock:
            nodes = self.directory.delete(object_id)  # notifies subscribers
            for nid in nodes:
                # Non-creating registry lookup: the same guarded access
                # whether the id is in the seed range, a joiner, or stale.
                store = self.stores.get(nid)
                if store is not None:
                    store.delete(object_id)
            self.meta.pop(object_id, None)
            # A deleted id sheds its drain protection: a later re-Put
            # under the same id is an ordinary contribution again.
            self._drain_handoffs.pop(object_id, None)

    def fail_node(self, node: int) -> List[str]:
        """Kill a node: all its copies vanish; returns orphaned object ids
        (no surviving copy anywhere -- framework must recover, section 7).
        The node stays a *member* (it may restart)."""
        with self._dir_lock:
            self.dead.add(node)
            self.draining.discard(node)  # a dead node is no longer draining
            self._bump_epoch()
            old_store = self.stores.replace(node)
            orphaned = self.directory.fail_node(node)  # notifies subscribers
            self._wake_membership_waiters()
        # Wake readers gated on the dead node's watermarks (outside the
        # directory lock; buffer locks are innermost).
        old_store.fail_all_buffers()
        self._comm.on_node_down(node)
        return orphaned

    def restart_node(self, node: int):
        with self._dir_lock:
            self.dead.discard(node)
            self._bump_epoch()
            # A restarted id is a live member again: rebuilds of its lost
            # objects are failure re-splices, not drain handoffs.
            self._drained.pop(node, None)
            old_store = self.stores.replace(node)
            self.stores.add(node)  # re-establish membership (post-drain restarts)
            # Pre-restart streams are dead: zero the node's outbound load
            # and bump its charge epoch so their late releases cannot
            # free slots charged by post-restart streams.
            self.directory.reset_outbound(node)
            self._wake_membership_waiters()
        # Any transfer still reading the pre-restart store's buffers must
        # fail over (those copies are gone from the directory).
        old_store.fail_all_buffers()
        self._comm.on_node_up(node)

    # -- Elastic membership --------------------------------------------------

    def add_node(self, node: Optional[int] = None) -> int:
        """Join a fresh node to the cluster (mid-collective joins are
        absorbed: a joiner's ``get``/``prefetch_async`` becomes a leaf of
        the running broadcast tree, chasing producing partials like any
        other receiver -- no in-flight transfer restarts).  Returns the
        node id (next free id when ``node`` is None)."""
        with self._dir_lock:
            if node is None:
                node = max(self.stores.ids(), default=-1) + 1
            node = int(node)
            self.dead.discard(node)
            self.draining.discard(node)
            self.directory.set_draining(node, False)
            self.stores.add(node)
            # A joiner starts with a clean outbound ledger.
            self.directory.reset_outbound(node)
            epoch = self._bump_epoch()
            self._drained.pop(node, None)  # a re-joined id is a member again
            self._stats.joins += 1
            if self.trace.enabled:
                self.trace.instant(CAT_MEMBERSHIP, "joined", node, "", epoch=epoch)
            self._wake_membership_waiters()
        self._comm.on_node_up(node)
        return node

    def drain_node(self, node: int, deadline: Optional[float] = None) -> List[str]:
        """Planned departure with ZERO object loss.

        Three phases:

          1. *Wind down*: mark the node draining -- ``select_source``
             soft-avoids its copies and new placements skip it, while
             in-flight transfers it serves finish naturally.
          2. *Evacuate*: every object whose ONLY complete copy lives on
             this node is proactively re-replicated to a staying member
             through the ordinary broadcast plane (``prefetch_async``
             from the draining holder -- the same receiver-driven path
             as any other transfer).  Live *producing* chain partials
             (a reduce target or hop output still being generated here)
             are part of the work list too: the drain holds until they
             complete locally (bounded by the deadline), then evacuates
             them like any other sole copy -- the chain's accumulated
             state is handed off, never forfeited.  In-flight *receiver*
             partials are left to their own pipelines (their sources
             hold leading copies elsewhere by construction).
          3. *Leave*: the node departs membership; the directory drops
             its locations.  The orphan list from that drop is the
             zero-loss proof -- it is empty iff evacuation covered
             every sole copy.

        ``deadline`` (seconds, default ``FaultToleranceConfig.get_timeout``)
        bounds the evacuation phase; on expiry the node leaves anyway and
        any still-orphaned ids are returned by the directory drop exactly
        as ``fail_node`` would.  Returns the evacuated object ids.
        """
        deadline_s = self.ft.get_timeout if deadline is None else deadline
        until = time.time() + deadline_s
        with self._dir_lock:
            self._check_alive(node)
            if node not in self.stores:
                raise DeadNode(str(node))
            self.draining.add(node)
            self.directory.set_draining(node, True)
            epoch = self._bump_epoch()
            if self.trace.enabled:
                self.trace.instant(
                    CAT_MEMBERSHIP, "drain-start", node, "",
                    deadline=deadline_s, epoch=epoch,
                )
            self._wake_membership_waiters()
        evacuated: List[str] = []
        while time.time() < until:
            with self._dir_lock:
                store = self.stores[node]
                at_risk = []
                producing_wait = []
                for oid in self.directory.objects_at(node):
                    if not self.directory.sole_holder(oid, node):
                        continue
                    buf = store.get(oid)
                    if buf is not None and buf.failed:
                        continue
                    if self.directory.producing_at(oid, node) and (
                            buf is None or not buf.complete):
                        # Live producing chain partial: the chain's only
                        # accumulated state lives HERE (the old scan
                        # skipped it -- a drain racing a long reduce
                        # forfeited the contribution).  The buffer may
                        # not even exist yet (targets are advertised
                        # before their first byte).  Hold the drain until
                        # it completes locally, then evacuate it like any
                        # other sole copy; mark it mid-handoff so
                        # bounded-time allreduce never counts it as a
                        # straggler.
                        producing_wait.append(oid)
                        self._drain_handoffs.setdefault(oid, node)
                        continue
                    if buf is None or not buf.complete:
                        # In-flight receiver partial: its own pipeline
                        # (whose source leads it) owns recovery.
                        continue
                    at_risk.append(oid)
                    self._drain_handoffs.setdefault(oid, node)
                targets = [
                    i for i in self.stores.ids()
                    if i != node and i not in self.dead and i not in self.draining
                ]
            if not at_risk or not targets:
                if producing_wait and targets and time.time() < until:
                    # Producing partials outstanding: poll briefly
                    # (``wait_for_bytes`` would ride the producer's
                    # steady window signals past the drain deadline),
                    # then re-scan -- each becomes an ordinary sole
                    # COMPLETE copy to evacuate on completion.  If the
                    # deadline lands first, the partial hands off through
                    # its consumer's lineage rebuild instead.
                    time.sleep(min(0.01, max(0.001, until - time.time())))
                    continue
                break
            # Spread evacuations over the least-loaded staying members;
            # the transfers ride the ordinary receiver-driven broadcast
            # plane (prefetch_async), so they pipeline and fail over like
            # any other traffic.
            futs = []
            for k, oid in enumerate(at_risk):
                tgt = targets[k % len(targets)]
                futs.append((oid, self.prefetch_async(
                    tgt, oid, timeout=max(0.1, until - time.time())
                )))
            for oid, fut in futs:
                try:
                    fut.result(timeout=max(0.1, until - time.time()))
                    evacuated.append(oid)
                except BaseException:  # noqa: BLE001 -- re-scan decides
                    pass
            # Loop: re-scan for objects Put on the draining node while we
            # were evacuating (drain under load).
        with self._dir_lock:
            self.dead.add(node)
            # Record the planned departure: chain consumers that must now
            # rebuild a partial this node held classify the rebuild as a
            # drain HANDOFF (``splices_drain``), not a failure re-splice.
            self._drained[node] = self.membership_epoch
            # Producing chain partials that did not finish within the
            # deadline hand off through their consumers instead: the fold
            # resumes from the consumer's own watermark with a lineage
            # rebuild (byte-identical ``op(a, b)`` association), so they
            # are not *lost* -- exclude them from the orphan proof.  A
            # partial whose lineage cannot rebuild surfaces ObjectLost
            # through its own chain, not through the drain.
            producing_ids = {
                oid for oid in self.directory.objects_at(node)
                if self.directory.producing_at(oid, node)
            }
            old_store = self.stores.replace(node)
            self.stores.remove(node)  # departs membership (unlike fail_node)
            orphaned = self.directory.fail_node(node)  # also clears draining
            orphaned = [o for o in orphaned if o not in producing_ids]
            self.draining.discard(node)
            self._stats.drains += 1
            self._stats.evacuated_objects += len(evacuated)
            if self.trace.enabled:
                self.trace.instant(
                    CAT_MEMBERSHIP, "drain-complete", node, "",
                    evacuated=len(evacuated), orphaned=len(orphaned),
                )
            self._wake_membership_waiters()
        old_store.fail_all_buffers()
        self._comm.on_node_down(node)
        if orphaned:
            # Deadline expired with sole copies left: surface it loudly --
            # the zero-loss guarantee only holds within the deadline.
            raise ObjectLost(
                f"drain of node {node} orphaned {len(orphaned)} objects: "
                f"{sorted(orphaned)[:5]}"
            )
        return evacuated

    def fail_directory_primary(self):
        """Kill the primary directory; promote replica (paper section 7)."""
        with self._dir_lock:
            self.directory.fail_primary()
            self._wake_membership_waiters()

    def shutdown(self):
        """Release comm-backend resources (sockets, endpoint servers,
        heartbeat thread).  Idempotent; also runs automatically when the
        cluster is garbage-collected."""
        self._comm.stop()
