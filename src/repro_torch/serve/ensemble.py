"""Ensemble execution: broadcast fan-out, k-of-n aggregation, failure
cut-off (port of ``repro.serve.ensemble``).

One request = one input Put + N replica tasks + one annotated Reduce:

  * the input object is Put once onto the cluster's device; every replica
    task Gets it, so the receiver-driven broadcast tree (or the directory
    inline path for small inputs) distributes it with zero application
    involvement;
  * ``runtime.wait(k of n)`` (the paper's dynamic-group primitive,
    Figure 1b) collects the first k successful replica outputs; the
    annotated ``runtime.reduce`` chains exactly those k -- stragglers and
    dead replicas are cut off, never waited on;
  * if aggregation hits a lost object (a contributing node died between
    compute and reduce), the lineage path re-fetches each contribution
    through ``runtime.get`` (which re-executes producers, section 7) and
    folds locally -- a request is only lost if fewer than k replicas can
    produce an output at all.

Every argument a replica task receives is a tensor on the device, a copy
of the stored object (``LocalCluster.get``), as the JAX Get copies too: a
request on n replicas copies the weights n times.  ``model_fn`` runs on
the runtime's task threads; its device work, like every fold, goes on the
default stream.  With ``reduce_op=SUM`` each fold of f32, bf16 or f16
replies is the ``chunk_reduce`` kernel (``core.api.SUM``), in the chain's
fold windows and in the lineage fallback alike.
"""

from __future__ import annotations

import dataclasses
import threading
import time
from typing import Callable, Dict, List, Optional, Sequence

import torch

from repro_torch.core.api import SMALL_OBJECT_THRESHOLD, SUM, ObjectLost, ReduceOp, as_tensor
from repro_torch.runtime import Runtime, TaskError
from repro_torch.serve.deploy import WeightDeployment
from repro_torch.serve.metrics import ServeMetrics
from repro_torch.serve.router import Rejected, ReplicaQueue


class QuorumLost(RuntimeError):
    """Fewer than ``quorum`` replicas produced an output before timeout."""


@dataclasses.dataclass
class ReplicaHandle:
    replica_id: int
    node: int
    queue: ReplicaQueue
    alive: bool = True
    completed: int = 0


@dataclasses.dataclass
class EnsembleConfig:
    num_replicas: int = 8
    quorum: int = 5                 # k of n
    replica_queue_depth: int = 32   # per-replica burst headroom (open loop)
    request_timeout_s: float = 30.0
    aggregation_node: int = 0
    aggregate_mean: bool = True     # mean over the k contributions, else sum
    reduce_op: ReduceOp = SUM
    # Fire-and-forget input prefetch to all target replicas at admission
    # (runtime.broadcast, block=False): starts the fan-out stream while
    # tasks queue, so it pays off when executor queueing delay is real.
    # In-process executors start tasks immediately, so the extra prefetch
    # threads are pure scheduler contention there -- hence opt-in.  Off or
    # on, the tasks' own Gets ride the adaptive broadcast tree.
    prefetch_inputs: bool = False
    # Cap the per-request fan-out: with None every alive replica with a
    # free queue slot computes every request, so ADDING replicas never
    # adds throughput.  With max_fanout set, each request runs on the
    # max(quorum, max_fanout) least-loaded replicas -- capacity then
    # scales with the replica count, which is what makes autoscaling
    # (serve/autoscaler.py) able to absorb a load spike.
    max_fanout: Optional[int] = None


class EnsembleGroup:
    """N model replicas behind one k-of-n request path."""

    def __init__(
        self,
        runtime: Runtime,
        model_fn: Callable[[torch.Tensor, torch.Tensor], torch.Tensor],
        config: Optional[EnsembleConfig] = None,
        *,
        metrics: Optional[ServeMetrics] = None,
        nodes: Optional[Sequence[int]] = None,
    ):
        config = config if config is not None else EnsembleConfig()
        if config.quorum > config.num_replicas:
            raise ValueError("quorum cannot exceed num_replicas")
        self.runtime = runtime
        self.model_fn = model_fn
        self.config = config
        self.metrics = metrics or ServeMetrics()
        nodes = list(nodes) if nodes is not None else [
            i % runtime.num_nodes for i in range(config.num_replicas)
        ]
        self.replicas: List[ReplicaHandle] = [
            ReplicaHandle(i, nodes[i], ReplicaQueue(config.replica_queue_depth))
            for i in range(config.num_replicas)
        ]
        self.deployment = WeightDeployment(runtime, self.replicas)
        self._lock = threading.Lock()
        # Folds of the lineage fallback (``_aggregate``), which the cluster's
        # ``stats["fold_ops"]`` does not see.
        self.lineage_folds = 0
        runtime.add_failure_listener(self._on_node_failure)

    # -- membership ----------------------------------------------------------

    def _on_node_failure(self, node: int, _orphaned: List[str]) -> None:
        with self._lock:
            for r in self.replicas:
                if r.node == node:
                    r.alive = False

    def alive_replicas(self) -> List[ReplicaHandle]:
        with self._lock:
            return [r for r in self.replicas if r.alive]

    def kill_replica(self, replica_id: int) -> None:
        """Kill the NODE hosting this replica (test/benchmark hook)."""
        self.runtime.fail_node(self.replicas[replica_id].node)

    def queue_depths(self) -> Dict[int, int]:
        return {r.replica_id: r.queue.inflight for r in self.replicas}

    def add_replica(self, node: Optional[int] = None) -> ReplicaHandle:
        """Elastic scale-up: add a replica on ``node`` (a fresh runtime
        node when None) and stage the CURRENT weight version to it
        through the broadcast tree, so its first request needs no cold
        fetch from the origin.  The replica starts taking requests as
        soon as it is appended."""
        if node is None:
            node = self.runtime.add_node()
        with self._lock:
            replica_id = max((r.replica_id for r in self.replicas), default=-1) + 1
            handle = ReplicaHandle(
                replica_id, node, ReplicaQueue(self.config.replica_queue_depth)
            )
        _version, weights_ref = self.deployment.current()
        if weights_ref is not None:
            # Weight deployment rides the adaptive broadcast tree: the
            # joiner pulls from the least-loaded holder, not the origin.
            self.runtime.broadcast(
                weights_ref, [node], timeout=self.config.request_timeout_s
            )
        with self._lock:
            self.replicas.append(handle)
        return handle

    def retire_replica(self, replica_id: int) -> Optional[ReplicaHandle]:
        """Elastic scale-down, phase 1: stop routing NEW requests to the
        replica (``alive=False``); in-flight tasks finish and release
        their queue slots normally.  The caller drains the hosting node
        once ``handle.queue.inflight`` reaches zero (see
        ``QueueAutoscaler._scale_down``)."""
        with self._lock:
            for r in self.replicas:
                if r.replica_id == replica_id and r.alive:
                    r.alive = False
                    return r
        return None

    # -- deployment ----------------------------------------------------------

    def deploy(self, weights, **kwargs) -> int:
        return self.deployment.publish(weights, **kwargs)

    # -- request path ---------------------------------------------------------

    def handle_request(self, payload):
        cfg = self.config
        deadline = time.time() + cfg.request_timeout_s
        version, weights_ref = self.deployment.acquire()
        if weights_ref is None:
            raise RuntimeError("no weights deployed")

        candidates = self.alive_replicas()
        if cfg.max_fanout is not None:
            fanout = max(cfg.quorum, cfg.max_fanout)
            if len(candidates) > fanout:
                # Least-loaded subset (ties broken by replica id for
                # determinism): each request costs ``fanout`` tasks, so
                # capacity scales with the replica count.
                candidates = sorted(
                    candidates, key=lambda r: (r.queue.inflight, r.replica_id)
                )[:fanout]
        targets = []
        for r in candidates:
            if r.queue.try_acquire():
                targets.append(r)
        if len(targets) < cfg.quorum:
            for r in targets:
                r.queue.release()
            self.deployment.release(version)
            raise Rejected(
                f"only {len(targets)} replicas accept (quorum {cfg.quorum})"
            )

        payload = as_tensor(payload, self.runtime.cluster.device)
        in_ref = self.runtime.put(payload)
        if cfg.prefetch_inputs and payload.numel() * payload.element_size() >= SMALL_OBJECT_THRESHOLD:
            # Fan-out through the adaptive broadcast tree while tasks
            # queue; each task's own Get joins the in-flight copy (the
            # (node, object) stream slot dedupes) instead of opening a
            # fresh transfer.  Small payloads ride the directory-inline
            # path and need no staging.
            self.runtime.broadcast(
                in_ref,
                [r.node for r in targets],
                timeout=cfg.request_timeout_s,
                block=False,
            )
        by_ref_id = {}
        refs = []
        for r in targets:
            ref = self.runtime.remote(self.model_fn, weights_ref, in_ref, node=r.node)
            # release the replica slot when ITS task finishes (not when the
            # request finishes: stragglers keep their slot until done).
            ref.add_done_callback(lambda _ref, rep=r: rep.queue.release())
            by_ref_id[ref.id] = r
            refs.append(ref)

        try:
            done_ok = self._await_quorum(refs, cfg.quorum, deadline)
            value = self._aggregate(done_ok, deadline)
        finally:
            # Straggler/failure cut-off: drop the input object so replicas
            # that have not started their fetch abort instead of streaming
            # bytes nobody will aggregate.  Reclaim replica outputs too --
            # they are pinned in their node stores and, with lineage/ref
            # table entries, would otherwise leak one set per request
            # forever.  Finished tasks are reclaimed in one batch;
            # stragglers when they complete.
            finished = [r for r in refs if r.ready.is_set()]
            self.runtime.delete([in_ref] + finished)
            for ref in refs:
                if ref not in finished:
                    ref.add_done_callback(lambda r: self.runtime.delete([r]))
            self.deployment.release(version)
        for ref in (r for r in refs if r.ready.is_set() and r.error is None):
            rep = by_ref_id[ref.id]
            rep.completed += 1
            self.metrics.replica_completed(rep.replica_id)
        return value

    def _await_quorum(self, refs, k: int, deadline: float):
        ok: List = []
        pending = list(refs)
        while True:
            need = k - len(ok)
            if need <= 0:
                return ok
            if not pending:
                raise QuorumLost(f"{len(ok)}/{k} replica outputs")
            timeout = deadline - time.time()
            if timeout <= 0:
                raise QuorumLost(f"timeout with {len(ok)}/{k} replica outputs")
            done, pending = self.runtime.wait(
                pending, num_returns=min(need, len(pending)), timeout=timeout
            )
            if not done:
                raise QuorumLost(f"timeout with {len(ok)}/{k} replica outputs")
            ok.extend(r for r in done if r.error is None)

    def _aggregate(self, done_ok, deadline: float):
        cfg = self.config
        k = len(done_ok)
        remaining = max(0.1, deadline - time.time())
        # Aggregation-node failover: if the configured node died, any
        # alive node can chain the reduce.
        agg: Optional[int] = cfg.aggregation_node
        if agg in self.runtime.cluster.dead:
            agg = None
        out = None
        try:
            out = self.runtime.reduce(
                done_ok, cfg.reduce_op, node=agg, timeout=remaining
            )
            total = self.runtime.get(out, node=out.node, timeout=remaining)
        except (TaskError, ObjectLost, TimeoutError):
            # Lineage path: re-fetch each contribution; runtime.get
            # re-executes the producer if every copy died with a node.
            fetch_node = agg if agg is not None else self.runtime._pick_node(None)
            total = None
            for r in done_ok:
                v = self.runtime.get(
                    r, node=fetch_node,
                    timeout=max(0.1, deadline - time.time()),
                )
                if total is None:
                    total = v
                else:
                    total = cfg.reduce_op(total, v)
                    with self._lock:
                        self.lineage_folds += 1
        finally:
            if out is not None:  # reclaim the reduce result object
                out.add_done_callback(lambda r: self.runtime.delete([r]))
        return total / k if cfg.aggregate_mean else total
