"""Dynamic-task runtime over the Hoplite object store (port of
``repro.runtime.runtime``).

Task arguments and results are tensors on the cluster's device (the card
unless the caller asks for the CPU): an ObjectRef argument arrives as the
tensor ``LocalCluster.get`` returns, and a task's result, tensor or numpy
array, is Put onto the device.

Semantics follow the paper's framing of Ray:

  * ``runtime.remote(fn, *args)`` submits a task and immediately returns an
    ``ObjectRef`` future; the scheduler places it on an executor node.
  * ObjectRef arguments are resolved via Hoplite ``Get`` on the executing
    node -- when many tasks consume the same ref, the receiver-driven
    broadcast tree emerges with zero application involvement.
  * ``runtime.reduce(refs, op)`` is the annotated reduce of section 2.3
    (``@ray.remote(reduce=True)``): Hoplite chains the inputs dynamically.
  * ``runtime.wait(refs, num_returns=k)`` returns the first k finished refs
    -- the primitive that makes asynchronous PS / RL loops expressible.
  * Lineage-based recovery (section 7): every ref records its producing
    task; if all copies of an object are lost to node failures, the task
    re-executes (transitively re-fetching / re-creating its inputs).

Four recoveries go beyond the JAX runtime, which has them on no path: a
reduce whose source lost its last copy re-executes that source's task and
reduces again (the JAX ``reduce`` fails with ``ObjectLost``); a Get whose
own node was killed and restarted under it fetches again (the JAX ``get``
fails the task with ``DeadNode``); a task whose own node is dead when it
Puts its result, or Gets an argument, runs again on a live node (the JAX
task fails with ``DeadNode``); and ``put`` picks another node when the one
it picked died before the Put reached it (the JAX ``put`` raises
``DeadNode``), though never a node the caller named.  Above the inline
size a killed node takes its tasks' results with it, so without the first
a reduce over the first finishers fails whenever one of them ran there;
without the third it fails whenever one of them finished between a node's
kill and its restart.

Each task's wall time, from ``remote()`` to its ref being ready, is split
into consecutive stages (``core/trace.TASK_STAGES``): ``task-queued`` until
its thread holds an executor slot, ``task-args`` resolving its ObjectRef
arguments, ``task-run`` in ``fn``, ``task-put`` Putting the result.  They are
summed into ``cluster.stats["task_seconds"]`` always and, with the cluster's
recorder on, recorded as ``task`` spans under the task's ref id.
"""

from __future__ import annotations

import collections
import itertools
import threading
import time
from typing import Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np

from repro_torch.core.api import SUM, ObjectLost, ReduceOp, as_tensor
from repro_torch.core.local import DeadNode, LocalCluster
from repro_torch.core.trace import CAT_TASK, TASK_ARGS, TASK_PUT, TASK_QUEUED, TASK_RUN, StageClock


class TaskError(RuntimeError):
    pass


class ObjectRef:
    _ids = itertools.count()

    def __init__(self, runtime: "Runtime", object_id: Optional[str] = None):
        self.id = object_id or f"ref-{next(ObjectRef._ids)}"
        self._runtime = runtime
        self.ready = threading.Event()
        self.error: Optional[BaseException] = None
        # Placement: the node the producing task ran on (updated if the
        # task is re-executed elsewhere after a failure).
        self.node: Optional[int] = None
        self._callbacks: List[Callable] = []

    def add_done_callback(self, cb: Callable[["ObjectRef"], None]) -> None:
        """Run ``cb(ref)`` when the producing task finishes (success or
        error).  Fires immediately if already done.  Each registration
        fires exactly once: a callback registered before a lineage
        re-execution is consumed by the first completion, not replayed."""
        fire = False
        with self._runtime._lock:
            if self.ready.is_set():
                fire = True
            else:
                self._callbacks.append(cb)
        if fire:
            cb(self)

    def remove_done_callback(self, cb: Callable[["ObjectRef"], None]) -> None:
        """Deregister a not-yet-fired callback (no-op if already fired)."""
        with self._runtime._lock:
            try:
                self._callbacks.remove(cb)
            except ValueError:
                pass

    def __repr__(self):
        return f"ObjectRef({self.id}, ready={self.ready.is_set()}, node={self.node})"


class Runtime:
    """A pool of per-node executors + scheduler + lineage table."""

    def __init__(
        self,
        num_nodes: int = 4,
        executors_per_node: int = 2,
        cluster: Optional[LocalCluster] = None,
        seed: int = 0,
        fault_tolerance=None,  # core.faults.FaultToleranceConfig
        faults=None,  # core.faults.FaultPlan / FaultInjector
        comm_backend: Optional[str] = None,  # core.comm backend name
        device=None,  # the new cluster's device; None -> "cuda"
    ):
        self.cluster = cluster or LocalCluster(
            num_nodes,
            fault_tolerance=fault_tolerance,
            faults=faults,
            comm_backend=comm_backend,
            device=device,
        )
        self._executors_per_node = executors_per_node
        self._rng = np.random.RandomState(seed)
        self._rr = itertools.count()
        self._lineage: Dict[str, Tuple[Callable, tuple, dict, int]] = {}
        self._refs: Dict[str, ObjectRef] = {}
        self._lock = threading.RLock()
        # Per-node executor slots, keyed by node id: elastic membership
        # means nodes appear after construction, so a joiner gets its
        # semaphore lazily on first placement.
        self._sema = collections.defaultdict(
            lambda: threading.Semaphore(executors_per_node)
        )
        for i in self.cluster.stores.ids() if hasattr(self.cluster.stores, "ids") else range(self.cluster.num_nodes):
            self._sema[i]
        self.tasks_executed = 0
        self.tasks_reexecuted = 0
        # Failure hooks: cb(node, orphaned_object_ids) on every node kill.
        self._failure_listeners: List[Callable[[int, List[str]], None]] = []

    @property
    def num_nodes(self) -> int:
        """Live cluster membership (tracks joins/drains)."""
        return self.cluster.num_nodes

    # -- failure hooks ------------------------------------------------------

    def add_failure_listener(self, cb: Callable[[int, List[str]], None]) -> None:
        with self._lock:
            self._failure_listeners.append(cb)

    def remove_failure_listener(self, cb: Callable) -> None:
        with self._lock:
            if cb in self._failure_listeners:
                self._failure_listeners.remove(cb)

    def fail_node(self, node: int) -> List[str]:
        """Kill a node and notify failure listeners (serving control plane,
        tests).  Returns object ids that lost their last copy."""
        orphaned = self.cluster.fail_node(node)
        with self._lock:
            listeners = list(self._failure_listeners)
        for cb in listeners:
            cb(node, orphaned)
        return orphaned

    def restart_node(self, node: int) -> None:
        self.cluster.restart_node(node)

    def add_node(self, node: Optional[int] = None) -> int:
        """Join a fresh executor node (elastic scale-up); new task
        placements start landing on it immediately."""
        nid = self.cluster.add_node(node)
        with self._lock:
            self._sema[nid]  # materialize its executor slots
        return nid

    def drain_node(self, node: int, deadline: Optional[float] = None) -> List[str]:
        """Planned scale-down: stop placing new tasks on ``node`` (it is
        marked draining), evacuate sole object copies, then remove it
        from membership.  Returns the evacuated object ids."""
        return self.cluster.drain_node(node, deadline=deadline)

    @property
    def membership_epoch(self) -> int:
        """Monotonic member-set version: one transition per join / drain /
        kill / restart.  In-flight reduce chains carry the epoch they last
        spliced under (see ``splice_contribution``)."""
        return self.cluster.membership_epoch

    def splice_contribution(self, target_id: str, source) -> bool:
        """Offer a post-start contribution (a joiner's gradient) to the
        in-flight reduce/allreduce chain producing ``target_id``.
        ``source`` is an ObjectRef or a raw object id.  Returns True iff
        the contribution will be folded into the result (tail splice while
        the chain is consuming, late side-fold before finalization);
        False once the fold frontier has moved -- re-run or fold outside
        the collective then."""
        source_id = source.id if isinstance(source, ObjectRef) else str(source)
        return self.cluster.splice_contribution(str(target_id), source_id)

    def placement_of(self, ref: ObjectRef) -> Optional[int]:
        """The node the ref's producing task ran on (or None for an
        unplaced/errored ref)."""
        return ref.node

    # -- scheduling ---------------------------------------------------------

    def _pick_node(self, node: Optional[int]) -> int:
        if node is not None:
            return node
        cluster = self.cluster
        stores = cluster.stores
        members = stores.ids() if hasattr(stores, "ids") else range(cluster.num_nodes)
        alive = [i for i in members if i not in cluster.dead]
        # Prefer non-draining members: a draining node finishes what it
        # has but takes no new placements (unless it is all that's left).
        draining = getattr(cluster, "draining", ())
        pool = [i for i in alive if i not in draining] or alive
        return pool[next(self._rr) % len(pool)]

    # -- task submission ------------------------------------------------------

    def remote(
        self, fn: Callable, *args, node: Optional[int] = None, **kwargs
    ) -> ObjectRef:
        """Submit ``fn(*args)``; ObjectRef args are fetched via Hoplite."""
        ref = ObjectRef(self)
        node = self._pick_node(node)
        ref.node = node
        clock = self._task_clock(ref)
        with self._lock:
            self._lineage[ref.id] = (fn, args, kwargs, node)
            self._refs[ref.id] = ref
        t = threading.Thread(
            target=self._execute, args=(ref, fn, args, kwargs, node, clock), daemon=True
        )
        t.start()
        return ref

    def put(self, value, node: Optional[int] = None) -> ObjectRef:
        ref = ObjectRef(self)
        value = as_tensor(value, self.cluster.device)
        named = node
        for attempt in range(3):
            node = self._pick_node(named)
            try:
                self.cluster.put(node, ref.id, value)
                break
            except DeadNode as e:
                # The node this call picked died before the Put reached
                # it: pick again.  A node the caller named stays an error.
                if named is not None or str(e) != str(node) or attempt == 2:
                    raise
        ref.node = node
        with self._lock:
            self._refs[ref.id] = ref
            # Put lineage (section 7): the value is in hand, so losing the
            # last copy to a node kill is recoverable by re-putting it on
            # a surviving node -- without this, a broadcast origin dying
            # before any receiver completes loses the object for good
            # (tasks have re-execution lineage; puts deserve the same).
            self._lineage[ref.id] = (lambda v=value: v, (), {}, node)
        ref.ready.set()
        self._fire_callbacks(ref)
        return ref

    def _resolve(self, arg, node: int):
        if isinstance(arg, ObjectRef):
            return self.get(arg, node=node)
        return arg

    def _task_clock(self, ref: ObjectRef) -> StageClock:
        """The clock of a task's stages, started now in ``task-queued``."""
        c = self.cluster
        return StageClock(c._stats, c.trace, ref.node, ref.id, TASK_QUEUED, cat=CAT_TASK, field="task_seconds")

    def _execute(self, ref: ObjectRef, fn, args, kwargs, node: int, clock: Optional[StageClock] = None):
        clock = clock or self._task_clock(ref)
        try:
            for attempt in range(3):
                try:
                    clock.switch(TASK_QUEUED)
                    with self._sema[node]:
                        clock.switch(TASK_ARGS)
                        resolved = [self._resolve(a, node) for a in args]
                        rkw = {k: self._resolve(v, node) for k, v in kwargs.items()}
                        clock.switch(TASK_RUN)
                        out = fn(*resolved, **rkw)
                        clock.switch(TASK_PUT)
                        self.cluster.put(node, ref.id, out)
                    return
                except DeadNode as e:
                    if str(e) != str(node) or attempt == 2:
                        raise
                    # This task's own node was killed under it (its Put
                    # refused, or its Get's node still dead): run it again
                    # on a live node, as the task of a lost object is.
                    node = self._pick_node(None)
                    ref.node = node
                    self.tasks_reexecuted += 1
        except BaseException as e:  # noqa: BLE001
            ref.error = e
        finally:
            self.tasks_executed += 1
            clock.close()
            ref.ready.set()
            self._fire_callbacks(ref)

    def _fire_callbacks(self, ref: ObjectRef) -> None:
        with self._lock:
            cbs, ref._callbacks = ref._callbacks, []
        for cb in cbs:
            try:
                cb(ref)
            except Exception:  # noqa: BLE001 -- observer errors never kill tasks
                pass

    # -- data access ------------------------------------------------------------

    def get(self, ref: ObjectRef, node: int = 0, timeout: float = 60.0):
        """Hoplite Get with lineage reconstruction on ObjectLost."""
        deadline = time.time() + timeout
        ref.ready.wait(timeout=timeout)
        if ref.error is not None:
            raise TaskError(str(ref.error)) from ref.error
        for attempt in range(3):
            try:
                return self.cluster.get(
                    node, ref.id, timeout=max(0.1, deadline - time.time())
                )
            except (ObjectLost, TimeoutError):
                if not self._reconstruct(ref.id, node):
                    raise
            except DeadNode:
                if node in self.cluster.dead:
                    raise
                # this node was killed and restarted under the fetch
        raise TaskError(f"unable to reconstruct {ref.id}")

    def _lost(self, object_ids: Sequence[str]) -> List[str]:
        """The ids among ``object_ids`` whose every copy is gone."""
        with self.cluster.lock:
            return [oid for oid in object_ids if self.cluster._object_lost(oid)]

    def _reconstruct(self, object_id: str, node: int) -> bool:
        """Re-execute the producing task of a lost object (section 7)."""
        with self._lock:
            entry = self._lineage.get(object_id)
            ref = self._refs.get(object_id)
        if entry is None or ref is None:
            return False
        fn, args, kwargs, orig_node = entry
        exec_node = orig_node if orig_node not in self.cluster.dead else self._pick_node(None)
        self.tasks_reexecuted += 1
        ref.ready.clear()
        ref.node = exec_node
        self._execute(ref, fn, args, kwargs, exec_node)
        return ref.error is None

    # -- group communication -------------------------------------------------------

    def wait(
        self, refs: Sequence[ObjectRef], num_returns: int = 1, timeout: float = 60.0
    ) -> Tuple[List[ObjectRef], List[ObjectRef]]:
        """First-k-finishers (the dynamic-group primitive, Figure 1b).

        Event-driven: a done-callback on each unfinished ref wakes this
        waiter, instead of the old 1 ms busy-poll (which burned a core and
        added up to 1 ms of latency per completion on the serving path)."""
        deadline = time.time() + timeout
        ev = threading.Event()

        def on_done(_r):
            ev.set()

        for r in refs:
            r.add_done_callback(on_done)
        try:
            done: List[ObjectRef] = []
            rest = list(refs)
            while True:
                for r in list(rest):
                    if r.ready.is_set():
                        done.append(r)
                        rest.remove(r)
                        if len(done) >= num_returns:
                            return done, rest
                remaining = deadline - time.time()
                if remaining <= 0 or not ev.wait(timeout=remaining):
                    return done, rest
                ev.clear()
        finally:
            # Deregister unfired callbacks: repeated wait() calls on the
            # same refs must not accrete one closure+Event per call.
            for r in refs:
                r.remove_done_callback(on_done)

    def broadcast(
        self,
        ref: ObjectRef,
        nodes: Sequence[int],
        timeout: float = 60.0,
        block: bool = True,
    ) -> List:
        """Stage ``ref``'s object at every node in ``nodes`` through the
        adaptive receiver-driven broadcast tree (the serve fast path:
        weight hot-swap pushes and ensemble fan-out).

        Issues all prefetches concurrently -- the directory's load-aware
        source selection turns them into a pipelined multicast tree, the
        origin serving only its out-degree.  Bytes are landed in each
        node's store without materializing arrays.  With ``block=False``
        returns the in-flight futures (fire-and-forget prefetch that
        overlaps queueing delay); per-node failures are the node's
        problem -- it pulls on first use instead."""
        ref.ready.wait(timeout=timeout)
        if ref.error is not None:
            raise TaskError(str(ref.error)) from ref.error
        targets = dict.fromkeys(
            n for n in nodes if n not in self.cluster.dead
        )
        futs = [
            self.cluster.prefetch_async(n, ref.id, timeout=timeout) for n in targets
        ]
        if block:
            for f in futs:
                try:
                    f.result(timeout=timeout)
                except Exception:  # noqa: BLE001 -- a target died mid-stage
                    pass  # it will pull on first request instead
        return futs

    def reduce(
        self,
        refs: Sequence[ObjectRef],
        op: ReduceOp = SUM,
        node: Optional[int] = None,
        timeout: float = 60.0,
    ) -> ObjectRef:
        """Annotated reduce: Hoplite chains the sources dynamically.

        The chain is a *streaming barrier*: it starts the moment the
        call is placed and consumes refs in completion order, so late
        tasks feed the chain tail as they finish -- and the chain stays
        open while any source is outstanding, which is exactly the
        window ``splice_contribution`` needs to admit a post-start
        joiner (waiting for every ref up front would close the elastic
        splice window before it opened).  A source ref that errors
        fails the reduce promptly through its done-callback instead of
        riding out the chain timeout."""
        node = self._pick_node(node)
        out = ObjectRef(self)
        out.node = node
        with self._lock:
            self._refs[out.id] = out

        def finish(err: Optional[BaseException] = None):
            with self._lock:
                if out.ready.is_set():
                    return
                if err is not None and out.error is None:
                    out.error = err
                out.ready.set()
            self._fire_callbacks(out)

        def fail_fast(r):
            if r.error is not None:
                finish(TaskError(str(r.error)))

        for r in refs:
            r.add_done_callback(fail_fast)

        def run():
            ids = [r.id for r in refs]
            target = out.id
            try:
                for attempt in range(3):
                    try:
                        self.cluster.reduce(node, target, ids, op, timeout=timeout)
                        break
                    except ObjectLost:
                        # Sources lost to a node failure: re-execute them
                        # from lineage, then reduce again into a fresh id
                        # (a group of the failed chain may still finish
                        # under the old one).
                        lost = self._lost(ids)
                        if not lost or attempt == 2:
                            raise
                        for oid in lost:
                            if not self._reconstruct(oid, node):
                                raise
                        self.cluster.delete(target)
                        target = f"{out.id}#retry{attempt + 1}"
                if target != out.id:
                    self.cluster.put(node, out.id, self.cluster.get(node, target))
                    self.cluster.delete(target)
            except BaseException as e:  # noqa: BLE001
                finish(e)
            else:
                finish()

        threading.Thread(target=run, daemon=True).start()
        return out

    def delete(self, refs: Sequence[ObjectRef]):
        for r in refs:
            self.cluster.delete(r.id)
            with self._lock:
                self._lineage.pop(r.id, None)
                self._refs.pop(r.id, None)
