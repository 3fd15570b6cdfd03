"""Discrete-event cluster simulator for Hoplite and its baselines (port of
``repro.core.simulation``).

The paper's 16-node EC2 evaluation is reproduced with a chunk-granularity
discrete-event network simulator that runs the port's *actual* Hoplite
control plane (ObjectDirectory, checkout semantics, ChainState, planner,
fault injector, flight recorder) over a modeled data plane:

  * every node has a FIFO egress resource and a FIFO ingress resource of
    ``bandwidth`` bytes/s -- bandwidth sharing between concurrent flows
    emerges from chunk interleaving (Ray-style fan-out gets B/k per flow,
    Hoplite's one-outbound-transfer cap emerges from directory checkout);
  * each chunk pays the link ``latency`` once, overlapped across chunks
    (cut-through), so a pipelined relay chain costs S/B + hops * (L + c/B),
    matching the paper's Appendix A algebra;
  * executor<->store memory copies are modeled as per-node memory streams
    of ``mem_bandwidth`` bytes/s -- Hoplite overlaps them with the network
    (partial-object publication), Ray-style baselines serialize them;
  * the directory is the real ObjectDirectory; every directory RPC costs
    ``dir_latency`` (the paper measures ~170 us per op on EC2).

Baselines:
  * ``MPIStyle``  -- static store-and-forward binomial trees (rank-ordered)
    plus closed-form large-message algorithms (scatter+allgather /
    Rabenseifner), mirroring MPICH's size-dependent algorithm choice;
  * ``RayStyle``  -- producer-only fetches (no relay, no partial senders),
    memory copies serialized with the network, reduce = gather-then-add.

Buffers are *symbolic*: they carry (size, progress, contributor label set)
rather than real bytes, so protocol correctness (every reduce contains
every contribution exactly once; every broadcast delivers the root object)
is asserted on every run.  Real-byte correctness is covered by the
threaded cluster in core/local.py.

The simulator is pure Python and holds no tensor.  Its link is the paper's
``EC2_LINK``, so it needs no TPU link constant.  For the same arguments it
gives the JAX simulator's event times exactly: a difference would be a
difference between the two packages' control planes.
"""

from __future__ import annotations

import dataclasses
import heapq
import math
from typing import Callable, Dict, List, Optional, Sequence, Tuple

from repro_torch.core.api import SMALL_OBJECT_THRESHOLD, Progress
from repro_torch.core.directory import ObjectDirectory
from repro_torch.core.faults import FaultInjector, FaultPlan
from repro_torch.core.planner import (
    LinkSpec,
    EC2_LINK,
    SPLICE_REJECT,
    SPLICE_SIDE,
    allreduce_policy,
    broadcast_policy,
    splice_mode,
    use_two_dimensional,
)
from repro_torch.core.scheduler import ChainState, Hop, partition_groups
from repro_torch.core.trace import (
    CAT_CHAIN,
    CAT_MEMBERSHIP,
    CAT_STREAM,
    RESPLICE_MEMBER_CHANGE,
    FlightRecorder,
)

# ---------------------------------------------------------------------------
# Event kernel (miniature SimPy)
# ---------------------------------------------------------------------------


class Event:
    __slots__ = ("sim", "done", "value", "_waiters")

    def __init__(self, sim: "Simulator"):
        self.sim = sim
        self.done = False
        self.value = None
        self._waiters: List[Callable] = []

    def succeed(self, value=None):
        if self.done:
            return
        self.done = True
        self.value = value
        waiters, self._waiters = self._waiters, []
        for w in waiters:
            self.sim._post(w, self)

    def add_waiter(self, fn: Callable):
        if self.done:
            self.sim._post(fn, self)
        else:
            self._waiters.append(fn)


class Simulator:
    def __init__(self):
        self.now = 0.0
        self._heap: List[Tuple[float, int, Callable, tuple]] = []
        self._seq = 0

    def _post(self, fn: Callable, *args):
        self.schedule(0.0, fn, *args)

    def schedule(self, delay: float, fn: Callable, *args):
        self._seq += 1
        heapq.heappush(self._heap, (self.now + delay, self._seq, fn, args))

    def timeout(self, delay: float) -> Event:
        ev = Event(self)
        self.schedule(delay, ev.succeed)
        return ev

    def event(self) -> Event:
        return Event(self)

    def all_of(self, events: Sequence[Event]) -> Event:
        out = Event(self)
        remaining = [len(events)]
        if not events:
            out.succeed()
            return out

        def on_one(_ev):
            remaining[0] -= 1
            if remaining[0] == 0:
                out.succeed()

        for e in events:
            e.add_waiter(on_one)
        return out

    def process(self, gen) -> Event:
        """Drive a generator that yields Events; returns completion event
        carrying the generator's return value."""
        done = Event(self)

        def step(ev: Optional[Event]):
            try:
                nxt = gen.send(ev.value if ev is not None else None)
            except StopIteration as stop:
                done.succeed(getattr(stop, "value", None))
                return
            nxt.add_waiter(step)

        self._post(lambda _e: step(None), None)
        return done

    def run(self, until: Optional[float] = None) -> float:
        while self._heap:
            t, _seq, fn, args = heapq.heappop(self._heap)
            if until is not None and t > until:
                self.now = until
                return self.now
            self.now = t
            fn(*args)
        return self.now


class FIFOResource:
    """A serialized resource (egress NIC, ingress NIC, memory engine)."""

    __slots__ = ("sim", "busy_until", "busy_time")

    def __init__(self, sim: Simulator):
        self.sim = sim
        self.busy_until = 0.0
        self.busy_time = 0.0  # total occupancy, for utilization accounting

    def serve(self, service_time: float) -> Event:
        start = max(self.sim.now, self.busy_until)
        self.busy_until = start + service_time
        self.busy_time += service_time
        ev = Event(self.sim)
        self.sim.schedule(self.busy_until - self.sim.now, ev.succeed)
        return ev


# ---------------------------------------------------------------------------
# Symbolic buffers
# ---------------------------------------------------------------------------


class SimBuffer:
    """Size + monotonic progress + contributor label set (no real bytes)."""

    __slots__ = ("object_id", "size", "bytes_present", "content", "_waiters", "sim")

    def __init__(self, sim: Simulator, object_id: str, size: int, content=frozenset()):
        self.sim = sim
        self.object_id = object_id
        self.size = size
        self.bytes_present = 0
        self.content = frozenset(content)
        self._waiters: List[Tuple[int, Event]] = []

    @property
    def complete(self) -> bool:
        return self.bytes_present >= self.size

    def advance(self, new_bytes_present: int):
        self.bytes_present = max(self.bytes_present, min(self.size, new_bytes_present))
        fired = [(n, e) for (n, e) in self._waiters if self.bytes_present >= n]
        self._waiters = [(n, e) for (n, e) in self._waiters if self.bytes_present < n]
        for _n, e in fired:
            e.succeed()

    def fill(self, content=None):
        if content is not None:
            self.content = frozenset(content)
        self.advance(self.size)

    def merge_content(self, other: frozenset):
        self.content = self.content | other

    def wait_bytes(self, n: int) -> Event:
        ev = Event(self.sim)
        if self.bytes_present >= min(n, self.size):
            ev.succeed()
        else:
            self._waiters.append((min(n, self.size), ev))
        return ev


# ---------------------------------------------------------------------------
# Network / cluster substrate
# ---------------------------------------------------------------------------


@dataclasses.dataclass
class ClusterSpec:
    num_nodes: int = 16
    link: LinkSpec = EC2_LINK
    mem_bandwidth: float = 3.3e9  # executor<->store memcpy bytes/s
    mem_latency: float = 2e-6
    dir_latency: float = 170e-6  # paper: ~167-177 us per directory op
    chunk_size: int = 64 * 1024  # simulation granularity
    max_chunks: int = 256  # cap events per stream; chunk grows for big objects
    reduce_bandwidth: float = 6.6e9  # streaming add bytes/s

    def chunks_for(self, size: int) -> Tuple[int, int]:
        """(num_chunks, chunk_bytes) with an event-count cap."""
        if size <= 0:
            return 1, 1
        c = max(self.chunk_size, -(-size // self.max_chunks))
        n = max(1, -(-size // c))
        return n, c


class Node:
    def __init__(self, sim: Simulator, node_id: int):
        self.id = node_id
        self.egress = FIFOResource(sim)
        self.ingress = FIFOResource(sim)
        self.mem = FIFOResource(sim)
        self.buffers: Dict[str, SimBuffer] = {}
        self.failed = False


class SimCluster:
    """Substrate shared by Hoplite and the baselines."""

    def __init__(self, spec: ClusterSpec = ClusterSpec(), trace: bool = False,
                 faults=None):
        self.spec = spec
        self.sim = Simulator()
        # Membership-safe registry (dict keyed by node id, like the
        # threaded plane's StoreRegistry): every access is by id, so
        # joins (add_node) and drains (drain_node) after construction
        # never shift indices.
        self.nodes = {i: Node(self.sim, i) for i in range(spec.num_nodes)}
        self.directory = ObjectDirectory()
        self.bytes_on_wire = 0
        # Membership epoch (mirrors LocalCluster.membership_epoch): bumped
        # on every membership delta so in-flight chains can stamp their
        # member-change splices with the epoch that caused them.
        self.membership_epoch = 0
        # Fault-injection plane (core/faults): the SAME FaultPlan schema
        # the threaded cluster consumes, applied here per chunk -- link
        # jitter adds propagation latency, bandwidth degradation and
        # straggler slowdown stretch egress service.  Kills on the plan
        # timeline are armed via ``injector.apply_to_sim(self)``.
        if faults is not None and isinstance(faults, FaultPlan):
            faults = FaultInjector(faults)
        self.faults: Optional[FaultInjector] = faults
        # Same flight-recorder schema as the threaded plane, on simulated
        # time: spans/instants carry ``sim.now`` so a simulated transfer
        # storm opens in Perfetto exactly like a threaded one.
        self.trace = FlightRecorder(enabled=trace, clock=lambda: self.sim.now)
        self.directory.recorder = self.trace

    def dump_trace(self, path: str) -> int:
        """Write recorded events as Chrome-trace JSON (timestamps are
        simulated seconds).  Returns the number of exported events."""
        return self.trace.dump_chrome_trace(path)

    # -- data plane ----------------------------------------------------------

    def net_stream(
        self,
        src: int,
        dst: int,
        src_buf: SimBuffer,
        dst_buf: SimBuffer,
        *,
        on_progress: Optional[Callable] = None,
        reduce_into: bool = False,
        extra_gate: Optional[SimBuffer] = None,
    ) -> Event:
        """Stream src_buf -> dst_buf over the network, chunk-pipelined.

        Gated on src availability (partial senders never forward bytes they
        do not hold).  ``reduce_into`` adds a memory-engine service per
        chunk at the receiver (the streaming add of a reduce hop).
        ``extra_gate`` additionally gates each chunk on a second buffer's
        watermark -- a reduce hop whose LOCAL operand is itself still
        being produced (a fused 2-D group partial) must not fold bytes
        that do not exist yet."""
        spec = self.spec
        if self.nodes[src].failed or self.nodes[dst].failed:
            ev = self.sim.event()
            return ev  # never fires: transfer stalls on a dead endpoint
        size = dst_buf.size
        nchunks, csize = spec.chunks_for(size)
        self.bytes_on_wire += size
        done = self.sim.event()
        delivered = [0]
        t0 = self.sim.now

        def deliver(k: int, upto: int):
            def after_ingress(_ev):
                if reduce_into:
                    self.nodes[dst].mem.serve(
                        (upto - dst_buf.bytes_present) / spec.reduce_bandwidth
                    ).add_waiter(lambda _e: landed())
                else:
                    landed()

            def landed():
                dst_buf.advance(upto)
                if on_progress:
                    on_progress(dst_buf.bytes_present)
                delivered[0] += 1
                if delivered[0] == nchunks:
                    if self.trace.enabled:
                        self.trace.span(
                            CAT_STREAM,
                            "reduce-leg" if reduce_into else "copy-leg",
                            dst, t0, self.sim.now - t0,
                            dst_buf.object_id, src=src, bytes=size,
                        )
                    done.succeed()

            self.nodes[dst].ingress.serve(
                min(csize, size - k * csize) / spec.link.bandwidth
            ).add_waiter(after_ingress)

        def driver():
            for k in range(nchunks):
                upto = min(size, (k + 1) * csize)
                yield src_buf.wait_bytes(upto)
                if extra_gate is not None:
                    yield extra_gate.wait_bytes(upto)
                this = upto - k * csize
                svc = this / spec.link.bandwidth
                lat = spec.link.latency
                if self.faults is not None:
                    extra_lat, bw = self.faults.chunk_factors(
                        src, dst, k, now=self.sim.now
                    )
                    svc /= max(bw, 1e-9)
                    lat += extra_lat
                yield self.nodes[src].egress.serve(svc)
                # propagation: fire-and-forget so latency overlaps next chunk
                self.sim.schedule(lat, deliver, k, upto)

        self.sim.process(driver())
        return done

    def mem_stream(
        self,
        node: int,
        src_buf: SimBuffer,
        dst_buf: SimBuffer,
        *,
        on_progress: Optional[Callable] = None,
    ) -> Event:
        """Executor<->store copy on one node (chunked, pipelined)."""
        spec = self.spec
        size = dst_buf.size
        nchunks, csize = spec.chunks_for(size)
        done = self.sim.event()
        finished = [0]
        t0 = self.sim.now

        def driver():
            for k in range(nchunks):
                upto = min(size, (k + 1) * csize)
                yield src_buf.wait_bytes(upto)
                this = upto - k * csize
                yield self.nodes[node].mem.serve(this / spec.mem_bandwidth)
                dst_buf.advance(upto)
                if on_progress:
                    on_progress(dst_buf.bytes_present)
                finished[0] += 1
                if finished[0] == nchunks:
                    if self.trace.enabled:
                        self.trace.span(
                            CAT_STREAM, "mem-copy", node,
                            t0, self.sim.now - t0,
                            dst_buf.object_id, bytes=size,
                        )
                    done.succeed()

        self.sim.process(driver())
        return done

    def new_buffer(self, node: int, object_id: str, size: int, content=frozenset()) -> SimBuffer:
        buf = SimBuffer(self.sim, object_id, size, content)
        self.nodes[node].buffers[object_id] = buf
        return buf

    def fail_node(self, node: int) -> List[str]:
        self.membership_epoch += 1
        self.nodes[node].failed = True
        self.nodes[node].buffers.clear()
        return self.directory.fail_node(node)

    # -- elastic membership --------------------------------------------------

    def add_node(self, node: Optional[int] = None) -> int:
        """Join a fresh node at the current simulated time.  Collective
        *policies* (tree shape, chunk counts) keep using ``spec.num_nodes``
        -- the simulator models protocol timing for a planned fleet, and a
        joiner becomes an extra placement target, not a re-planned tree."""
        if node is None:
            node = max(self.nodes, default=-1) + 1
        node = int(node)
        self.membership_epoch += 1
        existing = self.nodes.get(node)
        if existing is not None:
            existing.failed = False
        else:
            self.nodes[node] = Node(self.sim, node)
        self.directory.set_draining(node, False)
        if self.trace.enabled:
            self.trace.instant(
                CAT_MEMBERSHIP, "joined", node, "",
                epoch=self.membership_epoch,
            )
        return node

    def drain_node(self, node: int, deadline: float = 0.0) -> List[str]:
        """Planned departure in simulated time.  The simulator models
        placement/timing, not byte-exact evacuation traffic (that is the
        threaded plane's job): the node is soft-avoided by
        ``select_source`` from now on, then leaves -- the returned list
        is whatever the directory drop orphaned."""
        self.membership_epoch += 1
        self.directory.set_draining(node, True)
        if self.trace.enabled:
            self.trace.instant(
                CAT_MEMBERSHIP, "drain-start", node, "",
                epoch=self.membership_epoch,
            )
        n = self.nodes.get(node)
        if n is not None:
            n.failed = True
            n.buffers.clear()
        orphaned = self.directory.fail_node(node)  # clears draining too
        self.nodes.pop(node, None)
        if self.trace.enabled:
            self.trace.instant(
                CAT_MEMBERSHIP, "drain-complete", node, "",
                orphaned=len(orphaned),
            )
        return orphaned


# ---------------------------------------------------------------------------
# Hoplite protocols
# ---------------------------------------------------------------------------


class Hoplite:
    """The paper's protocols running over the simulated substrate."""

    def __init__(self, cluster: SimCluster):
        self.c = cluster
        self.sim = cluster.sim
        self.spec = cluster.spec
        self.directory = cluster.directory
        # Member-change splice counters (mirror DataPlaneStats on the
        # threaded plane): every counted splice also emits a
        # ``splice-join`` trace instant, so instants == stats holds here
        # too.
        self.splices_join = 0
        self.splices_drain = 0
        self._active_chains: Dict[str, dict] = {}

    # -- elastic membership ---------------------------------------------------

    def splice_contribution(self, target_id: str, object_id: str, src_node: int) -> bool:
        """Admit a joiner's contribution into the in-flight reduce chain
        of ``target_id`` -- the simulator's half of the epoch-versioned
        chain contract, deciding through the SAME ``planner.splice_mode``
        the threaded plane uses.  Tail splices enter the chain's arrival
        feed (the joiner becomes the new tail); side splices fold as an
        extra operand of the receiver's finalization; once the fold
        frontier moved the splice is rejected and the caller should fall
        back to a follow-up reduce.  Returns True when admitted."""
        h = self._active_chains.get(target_id)
        if h is None:
            return False
        mode = splice_mode(h["chain_active"], h["fold_frontier"], 0.0)
        if mode == SPLICE_REJECT:
            return False
        if mode == SPLICE_SIDE:
            h["side"].append((object_id, src_node))
        else:
            h["spliced"].add(object_id)
            h["expected"][0] += 1
            h["push"](object_id, src_node)
        return True

    # -- Put -----------------------------------------------------------------

    def put(self, node: int, object_id: str, size: int, label=None) -> Event:
        """Executor creates an object: pipelined copy into the local store;
        partial location published immediately (section 4.2)."""
        content = frozenset([label if label is not None else object_id])

        def proc():
            if size < SMALL_OBJECT_THRESHOLD:
                # Small-object fast path: cache in the directory itself.
                yield self.sim.timeout(self.spec.dir_latency)
                store_buf = self.c.new_buffer(node, object_id, size, content)
                store_buf.fill(content)
                self.directory.publish_inline(object_id, content, size)
                self.directory.publish_complete(object_id, node, size)
                return

            exec_buf = SimBuffer(self.sim, object_id + "#exec", size, content)
            exec_buf.fill(content)
            store_buf = self.c.new_buffer(node, object_id, size, content)
            # Publish partial location BEFORE the copy completes; advance
            # its directory watermark as bytes land so the partial is a
            # *feasible* adaptive-broadcast source (section 4.2).
            yield self.sim.timeout(self.spec.dir_latency)
            self.directory.publish_partial(object_id, node, size)
            yield self.c.mem_stream(
                node,
                exec_buf,
                store_buf,
                on_progress=lambda b: self.directory.update_progress(object_id, node, b),
            )
            self.directory.publish_complete(object_id, node, size)

        return self.sim.process(proc())

    # -- Get (point-to-point and emergent broadcast) --------------------------

    def get(self, node: int, object_id: str, *, to_executor: bool = True) -> Event:
        """Receiver-driven fetch (sections 4.2-4.3)."""

        def proc():
            # Directory query (sync form: blocks until a location exists).
            yield self.sim.timeout(self.spec.dir_latency)
            size = self.directory.size_of(object_id)
            inline = self.directory.get_inline(object_id)
            if inline is not None:
                # Small object returned inline with the directory reply.
                buf = self.c.new_buffer(node, object_id, size, inline)
                buf.fill(inline)
                return buf
            local = self.c.nodes[node].buffers.get(object_id)
            if local is not None and local.complete:
                return local
            mine = self.c.nodes[node].buffers.get(object_id)
            while True:
                loc = None
                size = self.directory.size_of(object_id)
                if size is not None:
                    # Adaptive source selection: least-loaded copy whose
                    # watermark leads us, fan-out capped by the shared
                    # broadcast policy (the same code path as
                    # LocalCluster.broadcast_out_degree).
                    policy = broadcast_policy(
                        max(1, self.spec.num_nodes - 1),
                        self.spec.link,
                        size,
                        chunk=float(self.spec.chunks_for(size)[1]),
                    )
                    loc = self.directory.select_source(
                        object_id,
                        exclude=node,
                        min_lead=mine.bytes_present if mine is not None else 0,
                        max_out_degree=policy.max_out_degree,
                    )
                if loc is not None:
                    break
                ev = self.sim.event()
                cb = lambda _oid: ev.succeed()
                self.directory.subscribe(object_id, cb)
                yield ev
                self.directory.unsubscribe(object_id, cb)
                yield self.sim.timeout(self.spec.dir_latency)
            size = self.directory.size_of(object_id)
            src_buf = self.c.nodes[loc.node].buffers[object_id]
            dst_buf = self.c.nodes[node].buffers.get(object_id)
            if dst_buf is None:
                dst_buf = self.c.new_buffer(node, object_id, size, src_buf.content)
            # Publish own partial location so later receivers can chain off
            # us; watermark advances per delivered chunk make us feasible.
            self.directory.publish_partial(object_id, node, size)
            # Control message to the sender.
            yield self.sim.timeout(self.spec.link.latency)
            if to_executor:
                exec_buf = SimBuffer(self.sim, object_id + "#exec", size)
                copy_done = self.c.mem_stream(node, dst_buf, exec_buf)
            net_done = self.c.net_stream(
                loc.node,
                node,
                src_buf,
                dst_buf,
                on_progress=lambda b: self.directory.update_progress(object_id, node, b),
            )
            yield net_done
            dst_buf.merge_content(src_buf.content)
            self.directory.publish_complete(object_id, node, size)
            # Free the sender's outbound slot (section 4.3).
            self.directory.release_source(object_id, loc.node)
            if to_executor:
                yield copy_done
            return dst_buf

        return self.sim.process(proc())

    # -- Reduce ----------------------------------------------------------------

    def reduce(
        self,
        node: int,
        target_id: str,
        source_ids: Dict[str, int],
        size: int,
        ready_events: Optional[Dict[str, Event]] = None,
        _top: bool = True,
        _result_buf: Optional[SimBuffer] = None,
    ) -> Event:
        """Receiver-driven chained reduce (section 4.3).

        ``source_ids`` maps object id -> node where it is (or will be)
        created.  ``ready_events`` optionally gates each source on an
        application event (asynchronous arrival); otherwise sources are
        assumed Put elsewhere and discovered via directory subscription.
        """
        n = len(source_ids)
        two_d = n > 3 and use_two_dimensional(n, self.spec.link, size)
        if two_d:
            return self._reduce_2d(
                node, target_id, source_ids, size, ready_events, _result_buf
            )
        return self._reduce_chain(
            node, target_id, source_ids, size, ready_events, _top, _result_buf
        )

    def _arrival_feed(self, source_ids: Dict[str, int], ready_events):
        """(next_arrival, push): (oid, node) in readiness order via
        directory subscription; ``push`` injects an extra arrival (a
        member-change tail splice) into the same feed."""
        sim = self.sim
        queue: List[Tuple[str, int]] = []
        waiter: List[Optional[Event]] = [None]
        seen = set()

        def on_pub(oid, src_node):
            if oid in seen:
                return
            seen.add(oid)
            queue.append((oid, src_node))
            if waiter[0] is not None and not waiter[0].done:
                waiter[0].succeed()

        for oid, src_node in source_ids.items():
            if ready_events and oid in ready_events:
                ready_events[oid].add_waiter(
                    lambda _e, o=oid, s=src_node: on_pub(o, s)
                )
            else:
                self.directory.subscribe(
                    oid, lambda _o, o=oid, s=src_node: (on_pub(o, s))
                )

        def next_arrival():
            def proc():
                while not queue:
                    waiter[0] = sim.event()
                    yield waiter[0]
                    waiter[0] = None
                return queue.pop(0)

            return sim.process(proc())

        return next_arrival, on_pub

    def _reduce_chain(
        self, node, target_id, source_ids, size, ready_events, _top=True,
        result_buf: Optional[SimBuffer] = None,
    ) -> Event:
        """1-D arrival-order chain with streaming hops.

        The target is advertised as a *producing* partial up front and its
        directory watermark advances with the final fold, so broadcast
        receivers (fused allreduce) and a 2-D top chain stream from it
        while the chain is still producing."""

        def proc():
            yield self.sim.timeout(self.spec.dir_latency)
            result = result_buf or self.c.nodes[node].buffers.get(target_id)
            if result is None:
                result = self.c.new_buffer(node, target_id, size)
            self.directory.publish_partial(target_id, node, size, producing=True)
            chain = ChainState(
                node, tag=target_id, epoch=self.c.membership_epoch
            )
            next_arrival, push = self._arrival_feed(source_ids, ready_events)
            # Elastic-chain handle: splice_contribution consults it to
            # decide tail vs side vs reject (shared planner.splice_mode).
            handle = {
                "chain": chain,
                "push": push,
                "expected": [len(source_ids)],
                "chain_active": True,
                "fold_frontier": 0.0,
                "spliced": set(),
                "side": [],
            }
            self._active_chains[target_id] = handle
            hop_events: List[Event] = []
            arrived: List[SimBuffer] = []
            consumed = 0
            while consumed < handle["expected"][0]:
                oid, src_node = yield next_arrival()
                consumed += 1
                src_node_buf = self.c.nodes[src_node].buffers.get(oid)
                if src_node_buf is None:
                    src_node_buf = self.c.new_buffer(src_node, oid, size, frozenset([oid]))
                    src_node_buf.fill()
                arrived.append(src_node_buf)
                if oid in handle["spliced"]:
                    hop = chain.splice_source(
                        src_node, oid, self.c.membership_epoch
                    )
                    self.splices_join += 1
                    if self.c.trace.enabled:
                        self.c.trace.instant(
                            CAT_CHAIN, "splice-join", node, target_id,
                            reason=RESPLICE_MEMBER_CHANGE, source=oid,
                            mode="tail", epoch=chain.epoch,
                        )
                else:
                    hop = chain.on_ready(src_node, oid)
                if hop is not None:
                    hop_events.append(self._exec_hop(hop, size))
            handle["chain_active"] = False
            final = chain.final_hop(target_id)
            if final is not None:
                src_buf = self.c.nodes[final.src_node].buffers[final.src_object]
                yield self.sim.timeout(self.spec.link.latency)  # notify sender
                yield self.c.net_stream(
                    final.src_node, node, src_buf, result, reduce_into=True,
                    on_progress=lambda b: self.directory.update_progress(
                        target_id, node, b
                    ),
                )
                result.merge_content(src_buf.content)
            # Freeze the fold frontier: from here splice_contribution
            # rejects, and the side list is final (the sim is
            # single-threaded, so no event can append after this point).
            handle["fold_frontier"] = 1.0
            for s_oid, s_node in handle["side"]:
                chain.splice_side(s_oid, self.c.membership_epoch)
                self.splices_join += 1
                if self.c.trace.enabled:
                    self.c.trace.instant(
                        CAT_CHAIN, "splice-join", node, target_id,
                        reason=RESPLICE_MEMBER_CHANGE, source=s_oid,
                        mode="side", epoch=chain.epoch,
                    )
                sbuf = self.c.nodes[s_node].buffers.get(s_oid)
                if sbuf is None:
                    sbuf = self.c.new_buffer(s_node, s_oid, size, frozenset([s_oid]))
                    sbuf.fill()
                if s_node != node:
                    tmp = self.c.new_buffer(node, s_oid, size, sbuf.content)
                    yield self.sim.timeout(self.spec.link.latency)
                    yield self.c.net_stream(
                        s_node, node, sbuf, tmp, reduce_into=True
                    )
                else:
                    yield sbuf.wait_bytes(sbuf.size)
                    yield self.c.nodes[node].mem.serve(
                        size / self.spec.reduce_bandwidth
                    )
                result.merge_content(sbuf.content)
                arrived.append(sbuf)
            # Fold receiver-local source objects (streaming adds), gated on
            # each one's own completion -- a local source may itself be a
            # group partial still being produced (fused 2-D).
            for oid in chain.local_objects:
                lb = self.c.nodes[node].buffers[oid]
                yield lb.wait_bytes(lb.size)
                result.merge_content(lb.content)
                yield self.c.nodes[node].mem.serve(size / self.spec.reduce_bandwidth)
            result.advance(result.size)
            # Contributor check against the buffers' FINAL contents (a
            # fused sub-chain's content set is only complete once its own
            # final fold ran, which strictly precedes this point).
            all_content = frozenset().union(*(b.content for b in arrived)) if arrived else frozenset()
            assert result.content == all_content, (
                f"reduce dropped contributions: {all_content - result.content}"
            )
            self.directory.publish_complete(target_id, node, size)
            if self._active_chains.get(target_id) is handle:
                del self._active_chains[target_id]
            return result

        return self.sim.process(proc())

    def _exec_hop(self, hop: Hop, size: int) -> Event:
        """Stream the current partial result into the next chain node,
        reducing with its local object on the fly (section 4.3/4.2).

        The output buffer is created eagerly (synchronously) so that the
        next hop can immediately chain off it while this hop is still
        streaming -- that is precisely the paper's pipelining."""
        src_buf = self.c.nodes[hop.src_node].buffers[hop.src_object]
        local = self.c.nodes[hop.dst_node].buffers[hop.dst_object]
        out = self.c.new_buffer(
            hop.dst_node, hop.out_object, size, src_buf.content | local.content
        )
        if self.c.trace.enabled:
            self.c.trace.instant(
                CAT_CHAIN, "hop-start", hop.dst_node, hop.out_object,
                src=hop.src_node, src_object=hop.src_object,
            )

        def proc():
            yield self.sim.timeout(self.spec.link.latency)  # coordinator notify
            yield self.c.net_stream(
                hop.src_node, hop.dst_node, src_buf, out, reduce_into=True,
                # A fused 2-D group partial as the LOCAL operand: gate each
                # folded chunk on its production watermark too.
                extra_gate=local if not local.complete else None,
            )
            out.merge_content(src_buf.content | local.content)
            return out

        return self.sim.process(proc())

    def _reduce_2d(
        self, node, target_id, source_ids, size, ready_events,
        result_buf: Optional[SimBuffer] = None,
    ) -> Event:
        """2-D chain: sqrt(n) random groups, one sub-coordinator per group
        (the first-ready node of the group), then a top-level chain over
        the group results (section 4.3).

        FUSED (section 4.4 composition): the top chain admits a group at
        its FIRST reduced byte, not its completion -- group partials are
        created eagerly and stream into the top chain as producing
        sources, so the two levels overlap to one pipeline fill."""

        def proc():
            yield self.sim.timeout(self.spec.dir_latency)
            import random as _random

            groups = partition_groups(list(source_ids.items()), _random.Random(1234))
            sub_results: Dict[str, int] = {}
            sub_ready: Dict[str, Event] = {}
            for gi, group in enumerate(groups):
                sub_id = f"{target_id}/g{gi}"
                # Sub-coordinator: the node of the group's first listed
                # object (readiness order inside the group still drives the
                # sub-chain's own hop order).
                coord = group[0][1]
                sub_results[sub_id] = coord
                sub_buf = self.c.new_buffer(coord, sub_id, size)
                self.reduce(
                    coord, sub_id, dict(group), size, ready_events,
                    _top=False, _result_buf=sub_buf,
                )
                # Feasibility transition, not completion: one byte of the
                # group partial is enough for the top chain to chain off.
                sub_ready[sub_id] = sub_buf.wait_bytes(1)
            # Top-level chain over group results, ordered by first byte.
            result = yield self._reduce_chain(
                node, target_id, sub_results, size, sub_ready,
                result_buf=result_buf,
            )
            return result

        return self.sim.process(proc())

    # -- composed primitives ---------------------------------------------------

    def allreduce(
        self, nodes: Sequence[int], source_ids: Dict[str, int], target_id: str, size: int
    ) -> Event:
        """Fused allreduce: receivers chase the producing reduce target's
        watermark while the root is still reducing into it, so completion
        is the reduce plus one broadcast pipeline fill.  The fuse/serialize
        decision comes from ``planner.allreduce_policy`` -- the SAME policy
        the threaded ``LocalCluster.allreduce`` applies."""
        root = nodes[0]
        policy = allreduce_policy(
            len(nodes), self.spec.link, size,
            chunk=float(self.spec.chunks_for(size)[1]),
        )
        red = self.reduce(root, target_id, source_ids, size)
        if policy.fused:
            gets = [self.get(n, target_id, to_executor=False) for n in nodes if n != root]
            return self.sim.all_of([red] + gets)
        # Sequential composition (small/latency-bound objects): broadcast
        # only after the reduce completes.
        done = self.sim.event()

        def after(_e):
            gets = [self.get(n, target_id, to_executor=False) for n in nodes if n != root]
            self.sim.all_of(gets).add_waiter(lambda _e2: done.succeed())

        red.add_waiter(after)
        return done


# ---------------------------------------------------------------------------
# Baselines
# ---------------------------------------------------------------------------


class MPIStyle:
    """Static, rank-ordered, store-and-forward binomial schedules plus the
    closed-form large-message algorithms MPICH switches to.  No directory
    (locations are known a priori) -- that is MPI's structural advantage
    for small objects, per the paper."""

    def __init__(self, cluster: SimCluster):
        self.c = cluster
        self.sim = cluster.sim
        self.spec = cluster.spec

    # Binomial broadcast with per-node arrival times (Figure 7a).
    def bcast(self, root: int, ranks: Sequence[int], size: int, arrival: Optional[Dict[int, float]] = None) -> Event:
        arrival = arrival or {}
        order = [root] + [r for r in ranks if r != root]
        n = len(order)
        done_ev = self.sim.event()
        have: Dict[int, Event] = {}
        for idx, r in enumerate(order):
            have[idx] = self.sim.event()
        remaining = [n - 1]

        def ready_gate(idx):
            # a rank participates only once its process has arrived
            t = arrival.get(order[idx], 0.0)
            ev = self.sim.event()
            self.sim.schedule(max(0.0, t - self.sim.now), ev.succeed)
            return ev

        def run_rank(idx):
            def proc():
                yield ready_gate(idx)
                if idx != 0:
                    yield have[idx]
                    remaining[0] -= 1
                    if remaining[0] == 0:
                        done_ev.succeed()
                # binomial sends: idx sends to idx + 2^k for 2^k > idx
                k = 0
                while True:
                    peer = idx + (1 << k)
                    if (1 << k) <= idx:
                        k += 1
                        continue
                    if peer >= n:
                        break
                    src_buf = SimBuffer(self.sim, f"b{idx}", size)
                    src_buf.fill()
                    dst_buf = SimBuffer(self.sim, f"b{peer}", size)
                    yield ready_gate(peer)  # rendezvous: receiver must exist
                    yield self.c.net_stream(order[idx], order[peer], src_buf, dst_buf)
                    have[peer].succeed()
                    k += 1

            self.sim.process(proc())

        for idx in range(n):
            run_rank(idx)
        if n == 1:
            done_ev.succeed()
        return done_ev

    # Closed-form models for the synchronous case (algorithm switch).
    def bcast_time(self, n: int, size: int) -> float:
        link = self.spec.link
        binomial = math.ceil(math.log2(max(2, n))) * link.transfer_time(size)
        scatter_allgather = 2 * size / link.bandwidth * (n - 1) / n + (
            math.ceil(math.log2(max(2, n))) + n - 1
        ) * link.latency
        return min(binomial, scatter_allgather)

    def reduce_time(self, n: int, size: int) -> float:
        link = self.spec.link
        binomial = math.ceil(math.log2(max(2, n))) * (
            link.transfer_time(size) + size / self.spec.reduce_bandwidth
        )
        rabenseifner = 2 * size / link.bandwidth * (n - 1) / n + 2 * math.ceil(
            math.log2(max(2, n))
        ) * link.latency + size / self.spec.reduce_bandwidth
        return min(binomial, rabenseifner)

    def allreduce_time(self, n: int, size: int) -> float:
        link = self.spec.link
        rabenseifner = 2 * size / link.bandwidth * (n - 1) / n + 2 * math.ceil(
            math.log2(max(2, n))
        ) * link.latency + size / self.spec.reduce_bandwidth
        return min(self.reduce_time(n, size) + self.bcast_time(n, size), rabenseifner)

    def gather_time(self, n: int, size: int) -> float:
        link = self.spec.link
        return (n - 1) * size / link.bandwidth + link.latency

    def p2p_rtt(self, size: int) -> float:
        return 2 * self.spec.link.transfer_time(size)

    # Binomial reduce with arrivals (Figure 7b): store-and-forward up the tree.
    def reduce_sim(self, root: int, ranks: Sequence[int], size: int, arrival: Optional[Dict[int, float]] = None) -> Event:
        arrival = arrival or {}
        order = [root] + [r for r in ranks if r != root]
        n = len(order)
        rounds = math.ceil(math.log2(max(2, n)))
        ready: Dict[int, Event] = {}
        for idx, r in enumerate(order):
            ev = self.sim.event()
            self.sim.schedule(arrival.get(r, 0.0), ev.succeed)
            ready[idx] = ev

        def run(idx):
            def proc():
                yield ready[idx]
                # receive from children idx + 2^k (k ascending) that exist
                for k in range(rounds):
                    child = idx + (1 << k)
                    if idx % (1 << (k + 1)) != 0 or child >= n:
                        continue
                    yield recv_done[child]
                    yield self.c.nodes[order[idx]].mem.serve(
                        size / self.spec.reduce_bandwidth
                    )
                if idx != 0:
                    # send to parent
                    parent = idx - (idx & -idx)
                    yield ready[parent]
                    src = SimBuffer(self.sim, f"r{idx}", size)
                    src.fill()
                    dst = SimBuffer(self.sim, f"r{idx}@{parent}", size)
                    yield self.c.net_stream(order[idx], order[parent], src, dst)
                recv_done[idx].succeed()

            self.sim.process(proc())

        recv_done = {idx: self.sim.event() for idx in range(n)}
        for idx in range(n):
            run(idx)
        return recv_done[0]


class RayStyle:
    """Ray 0.8-style object transfer: fetch from the producer only, no
    relaying, no partial-object senders, memory copies serialized."""

    def __init__(self, cluster: SimCluster):
        self.c = cluster
        self.sim = cluster.sim
        self.spec = cluster.spec
        self.directory = cluster.directory
        # Ray's small-object path takes extra control hops (plasma seal +
        # raylet notification + fetch) vs Hoplite's inline directory reply.
        self.extra_ctrl_rtts = 2

    def put(self, node: int, object_id: str, size: int, label=None) -> Event:
        content = frozenset([label if label is not None else object_id])

        def proc():
            exec_buf = SimBuffer(self.sim, object_id + "#exec", size, content)
            exec_buf.fill(content)
            store_buf = self.c.new_buffer(node, object_id, size, content)
            yield self.c.mem_stream(node, exec_buf, store_buf)  # full copy FIRST
            store_buf.merge_content(content)
            yield self.sim.timeout(self.spec.dir_latency)
            self.directory.publish_complete(object_id, node, size)

        return self.sim.process(proc())

    def get(self, node: int, object_id: str, *, to_executor: bool = True) -> Event:
        def proc():
            yield self.sim.timeout(
                self.spec.dir_latency + self.extra_ctrl_rtts * self.spec.link.latency
            )
            while True:
                locs = [
                    l for l in self.directory.locations(object_id)
                    if l.progress is Progress.COMPLETE
                ]
                if locs:
                    break
                ev = self.sim.event()
                cb = lambda _o: ev.succeed()
                self.directory.subscribe(object_id, cb)
                yield ev
                self.directory.unsubscribe(object_id, cb)
            loc = locs[0]  # always the producer: no relay through receivers
            size = self.directory.size_of(object_id)
            if loc.node == node:
                return self.c.nodes[node].buffers[object_id]
            src_buf = self.c.nodes[loc.node].buffers[object_id]
            dst_buf = self.c.new_buffer(node, object_id, size, src_buf.content)
            yield self.sim.timeout(self.spec.link.latency)
            yield self.c.net_stream(loc.node, node, src_buf, dst_buf)
            dst_buf.merge_content(src_buf.content)
            if to_executor:
                exec_buf = SimBuffer(self.sim, object_id + "#exec", size)
                yield self.c.mem_stream(node, dst_buf, exec_buf)  # serialized copy
            return dst_buf

        return self.sim.process(proc())

    def reduce(self, node: int, target_id: str, source_ids: Dict[str, int], size: int) -> Event:
        """Ray has no Reduce: the consumer task gathers all inputs and adds
        them locally (exactly what apply_gradient does in Figure 1b)."""

        def proc():
            gets = [self.get(node, oid, to_executor=False) for oid in source_ids]
            yield self.sim.all_of(gets)
            content = frozenset()
            for oid in source_ids:
                buf = self.c.nodes[node].buffers.get(oid)
                content = content | (buf.content if buf else frozenset([oid]))
                yield self.c.nodes[node].mem.serve(size / self.spec.reduce_bandwidth)
            out = self.c.new_buffer(node, target_id, size, content)
            out.fill(content)
            self.directory.publish_complete(target_id, node, size)
            return out

        return self.sim.process(proc())


# ---------------------------------------------------------------------------
# Ensemble-serving scenario (paper section 5.3 workload)
# ---------------------------------------------------------------------------


def ensemble_serving(
    *,
    data_plane: str = "hoplite",
    num_replicas: int = 8,
    weight_bytes: int = 64 << 20,
    input_bytes: int = 256 << 10,
    reply_bytes: int = 256 << 10,
    num_requests: int = 30,
    arrival_rate: float = 50.0,
    service_time: float = 0.01,
    quorum: Optional[int] = None,
    seed: int = 0,
    spec: Optional[ClusterSpec] = None,
) -> Dict:
    """Serve an N-replica ensemble over a modeled data plane.

    Phase 1 (weight deployment): node 0 Puts the weight object once and
    every replica fetches it concurrently.  Hoplite's directory-checkout
    relaying turns the fan-out into a pipelined broadcast tree; the
    RayStyle baseline fetches from the producer only, serializing n
    transfers through one egress NIC -- the contrast behind the paper's
    3.3x ensemble-serving speedup.

    Phase 2 (open-loop traffic): Poisson arrivals at ``arrival_rate``;
    each request broadcasts an input object to all replicas, replicas
    reply after ``service_time``, and the first ``quorum`` replies are
    aggregated at the root (dynamic reduce for Hoplite, gather-then-add
    for RayStyle).  Latency is arrival -> aggregate complete, recorded in
    the same :class:`repro_torch.serve.metrics.LatencyHistogram` the threaded
    stack uses.
    """
    import random as _random

    from repro_torch.serve.metrics import LatencyHistogram

    if data_plane not in ("hoplite", "ray"):
        raise ValueError(f"unknown data plane {data_plane!r}")
    spec = spec or ClusterSpec(num_nodes=num_replicas + 1)
    assert spec.num_nodes >= num_replicas + 1
    c = SimCluster(spec)
    api = Hoplite(c) if data_plane == "hoplite" else RayStyle(c)
    root = 0
    replicas = list(range(1, num_replicas + 1))
    k = quorum if quorum is not None else max(1, num_replicas // 2 + 1)
    hist = LatencyHistogram()
    completed = [0]

    # -- phase 1: weight deployment broadcast --------------------------------
    put_ev = api.put(root, "weights-v1", weight_bytes)
    deploy_done = [0.0]

    def deploy():
        yield put_ev
        gets = [api.get(r, "weights-v1", to_executor=False) for r in replicas]
        yield c.sim.all_of(gets)
        deploy_done[0] = c.sim.now

    c.sim.process(deploy())
    c.sim.run()
    deploy_time = deploy_done[0]
    deploy_bytes = c.bytes_on_wire

    # -- phase 2: open-loop request stream -----------------------------------
    rng = _random.Random(seed)

    def start_request(i: int):
        t_arr = c.sim.now
        iid = f"in-{i}"
        pe = api.put(root, iid, input_bytes)
        replies: Dict[str, int] = {}
        fired = [False]

        def on_reply(rid: str, r: int):
            replies[rid] = r
            if len(replies) >= k and not fired[0]:
                fired[0] = True  # k-of-n cut-off: stragglers never block
                chosen = dict(list(replies.items())[:k])
                red = api.reduce(root, f"out-{i}", chosen, reply_bytes)

                def fin(_e):
                    hist.record(c.sim.now - t_arr)
                    completed[0] += 1

                red.add_waiter(fin)

        def replica_work(r: int):
            def proc():
                yield pe
                yield api.get(r, iid, to_executor=False)
                yield c.sim.timeout(service_time)
                rid = f"rep-{i}-r{r}"
                yield api.put(r, rid, reply_bytes)
                on_reply(rid, r)

            c.sim.process(proc())

        for r in replicas:
            replica_work(r)

    t = 0.0
    for i in range(num_requests):
        t += rng.expovariate(arrival_rate)
        c.sim.schedule(t, start_request, i)
    c.sim.run()

    return {
        "data_plane": data_plane,
        "num_replicas": num_replicas,
        "quorum": k,
        "deploy_time": deploy_time,
        "deploy_bytes_on_wire": deploy_bytes,
        "offered": num_requests,
        "completed": completed[0],
        "latency": hist.summary(),
        "bytes_on_wire": c.bytes_on_wire,
        "sim_time": c.sim.now,
    }
