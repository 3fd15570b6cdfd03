"""Closed-loop collectives on ``LocalCluster``: ``in_flight`` clients, each
with input objects of its own, issue one collective after another.

Traffic parameters (``traffic/<name>.json``):

  * ``op``: ``allreduce`` (``LocalCluster.allreduce`` over every node, SUM),
    ``reduce`` (``LocalCluster.reduce`` of one object a node into node 0,
    SUM) or ``broadcast`` (a Put at node 0, then every other node's
    ``prefetch_async``);
  * ``object_bytes``: the size of every object;
  * ``in_flight``: clients, each a thread; a client's inputs are disjoint
    from every other client's;
  * ``input_sets`` (1 if not given): sets of inputs a client holds, each of
    one object a node (one object for ``broadcast``); each collective takes,
    at every node, the object of a set drawn by the seed, so that
    collectives have different answers and a result left over from another
    collective reads wrong;
  * ``reservoir``: how many completed collectives keep their results for the
    judge, drawn uniformly from all of the window's by the seed
    (reservoir sampling); every other result is deleted once its
    completion is recorded.

A collective is complete when the call has returned and the card has run
everything enqueued before the return (a CUDA event recorded then and waited
on, the waiting thread asleep rather than spinning on a core), so its
latency counts the device's work.

Configuration (``configs/<name>.json``): ``nodes``, ``low`` and ``high``
(the integer values of the f32 objects).
"""

from __future__ import annotations

import bisect
import itertools
import random
import threading
import time

import torch

from hoplite_bench import inputs

REFERENCE = "collective"


class Driver:
    def __init__(self, config: dict, traffic: dict, seed: int, device: str, spans, log):
        self.nodes = int(config["nodes"])
        self.low, self.high = int(config["low"]), int(config["high"])
        self.op = traffic["op"]
        if self.op not in ("allreduce", "reduce", "broadcast"):
            raise ValueError(f"op is allreduce, reduce or broadcast, not {self.op!r}")
        self.nbytes = int(traffic["object_bytes"])
        self.clients = int(traffic["in_flight"])
        self.sets = int(traffic.get("input_sets", 1))
        self.reservoir_size = int(traffic["reservoir"])
        self.seed, self.device, self.spans, self.log = seed, torch.device(device), spans, log
        self.rng = random.Random(seed)
        self.choosers = [random.Random(f"{seed}.{client}") for client in range(self.clients)]
        self.lock = threading.Lock()
        self.ops = itertools.count()
        self.kept = []  # (client, choice, target id) of the results the judge reads
        self.seen = 0  # completed collectives offered to the reservoir
        self.records = []  # (client, target id, issue, completion) of every completed collective
        self.errors = []
        self.attempted = 0  # collectives issued in the window

    # -- the system and its inputs ---------------------------------------------------

    def input_id(self, client: int, s: int, node: int) -> str:
        return f"in{client}.{s}.{node}"

    def choose(self, client: int) -> tuple:
        """The set each node's input of the client's next collective comes from."""
        rng = self.choosers[client]
        return tuple(rng.randrange(self.sets) for _ in range(self.objects_per_client()))

    def objects_per_client(self) -> int:
        return 1 if self.op == "broadcast" else self.nodes

    def setup(self, step=lambda what: None) -> None:
        from repro_torch.core.local import LocalCluster

        step("imported the program")
        self.cluster = LocalCluster(self.nodes, device=self.device)
        step("cluster")
        per = self.objects_per_client()
        objects = inputs.integer_objects(self.seed, self.device, self.clients * self.sets * per, self.nbytes,
                                         self.low, self.high)
        self.sources = []  # broadcast: [client][set], each Put anew, under a fresh id, by every broadcast
        for client in range(self.clients):
            if self.op == "broadcast":
                self.sources.append([next(objects) for _ in range(self.sets)])
                continue
            for s in range(self.sets):
                for node in range(self.nodes):
                    self.cluster.put(node, self.input_id(client, s, node), next(objects))
        step("inputs")
        # Warm-up: one collective a client, all at once, as the window runs them.
        threads = [threading.Thread(target=self._warm, args=(c,)) for c in range(self.clients)]
        for t in threads:
            t.start()
        for t in threads:
            t.join()
        if self.errors:
            raise RuntimeError(f"warm-up failed: {self.errors[0]}")
        step("warm-up")

    def _warm(self, client: int) -> None:
        try:
            tid = f"warm{client}"
            self._collective(client, tid, self.choose(client))
            self.cluster.delete(tid)
        except Exception as e:  # noqa: BLE001 -- reported by setup
            self.errors.append(repr(e))

    def _collective(self, client: int, tid: str, choice: tuple) -> None:
        from repro_torch.core.api import SUM

        c = self.cluster
        sources = [self.input_id(client, s, node) for node, s in enumerate(choice)]
        if self.op == "allreduce":
            c.allreduce(list(range(self.nodes)), tid, sources, SUM)
        elif self.op == "reduce":
            c.reduce(0, tid, sources, SUM)
        else:
            c.put(0, tid, self.sources[client][choice[0]])
            for f in [c.prefetch_async(i, tid) for i in range(1, self.nodes)]:
                f.result(timeout=c.ft.get_timeout)
        if self.device.type == "cuda":
            done = torch.cuda.Event(blocking=True)
            done.record()
            done.synchronize()

    def result_nodes(self):
        return [0] if self.op == "reduce" else list(range(self.nodes))

    # -- the window ----------------------------------------------------------------------

    def _client(self, client: int, t_end: float) -> None:
        while True:
            t0 = time.perf_counter()
            if t0 >= t_end:
                return
            tid = f"t{client}.{next(self.ops)}"
            choice = self.choose(client)
            with self.lock:
                self.attempted += 1
            try:
                self._collective(client, tid, choice)
            except Exception as e:  # noqa: BLE001 -- counted as failed, judged not correct
                self.errors.append(f"{tid}: {e!r}")
                return
            t1 = time.perf_counter()
            self.spans.add(self.op, t0, t1)
            with self.lock:
                self.records.append((client, tid, t0, t1))
                drop = self._offer((client, choice, tid))
            if drop is not None:
                self.cluster.delete(drop)

    def _offer(self, entry: tuple):
        """Reservoir sampling: keep ``entry`` (client, choice, target id)
        with the chance that leaves every completed collective equally
        likely to be kept; returns the id to delete (the entry's own, one it
        displaced, or None)."""
        self.seen += 1
        if len(self.kept) < self.reservoir_size:
            self.kept.append(entry)
            return None
        j = self.rng.randrange(self.seen)
        if j < self.reservoir_size:
            old = self.kept[j][2]
            self.kept[j] = entry
            return old
        return entry[2]

    def run(self, t_start: float, t_end: float) -> dict:
        """Drive the clients until ``t_end``; return what the window saw.
        The clients finish the collectives they have issued in ``drain``."""
        stats0 = self.cluster.stats
        self.threads = [threading.Thread(target=self._client, args=(c, t_end)) for c in range(self.clients)]
        for t in self.threads:
            t.start()
        time.sleep(max(0.0, t_end - time.perf_counter()))
        close = time.perf_counter()
        stats1 = self.cluster.stats
        with self.lock:
            done = sorted((t1, t0) for _, _, t0, t1 in self.records if t1 <= close)
            attempted = self.attempted
        return {"start": t_start, "close": close, "completed": len(done),
                "samples_ms": [(t1 - t0) * 1e3 for t1, t0 in done], "attempted": attempted,
                "stats0": stats0, "stats1": stats1}

    def drain(self) -> dict:
        """Wait for the collectives issued in the window; returns the count
        of those that failed or never completed."""
        deadline = time.perf_counter() + self.cluster.ft.reduce_timeout + 60
        for t in self.threads:
            t.join(max(0.0, deadline - time.perf_counter()))
        hung = sum(t.is_alive() for t in self.threads)
        return {"failed": len(self.errors) + hung, "errors": list(self.errors)}

    def end_to_end(self, window, trace=None) -> dict:
        """``collective_device_ms``: the card's busy time in the window (the
        union of every kernel and copy in the profiler's trace) over the
        collectives completed in it; left out where the trace saw no device."""
        if not window.completed or trace is None or trace.busy_s <= 0:
            return {}
        return {"collective_device_ms": trace.busy_s * 1e3 / window.completed}

    def label_of(self, t: float) -> str:
        """What the host was doing at ``t``: how many collectives were in
        flight (read once the window has closed)."""
        if not hasattr(self, "_starts"):
            self._starts = sorted(a for _, a, _ in self.spans.items)
            self._ends = sorted(b for _, _, b in self.spans.items)
        n = bisect.bisect_right(self._starts, t) - bisect.bisect_right(self._ends, t)
        return f"{self.op} x{n} in flight"

    # -- the judge -------------------------------------------------------------------------

    def outputs(self):
        """Each kept collective's result, as the program left it in every
        node that should hold it: (client, choice, {node: buffer tensor or
        None})."""
        out = []
        for client, choice, tid in self.kept:
            bufs = {}
            for node in self.result_nodes():
                store = self.cluster.stores.get(node)
                buf = None if store is None else store.get(tid)
                bufs[node] = buf.data if buf is not None and buf.complete else None
            out.append((client, choice, bufs))
        return out

    def free_inputs(self) -> None:
        """Drop everything but the kept results: the program's inputs, and
        the harness's own copies of the broadcast sources."""
        if self.op != "broadcast":
            for client in range(self.clients):
                for s in range(self.sets):
                    for node in range(self.nodes):
                        self.cluster.delete(self.input_id(client, s, node))
        self.sources = []

    def judge(self, reference, limits: dict, control: bool = False) -> dict:
        """Hold every kept result to the plain reference: the exact sum (or
        the source's bytes) in every node that should hold it, in storage of
        the node's own.  With ``control``, the control's readings go to
        ``self.control``."""
        outputs = self.outputs()
        self.free_inputs()
        args = (self.seed, self.device, self.op, self.clients, self.sets, self.nodes, self.nbytes, self.low,
                self.high)
        readings = reference.judge(*args, outputs)
        del outputs
        for _, _, tid in self.kept:
            self.cluster.delete(tid)
        if control:
            kept = [(client, choice, self.result_nodes()) for client, choice, _ in self.kept]
            self.control = reference.controls(*args, kept)
        return {name: {"value": readings[name], "limit": limit} for name, limit in limits.items()}

    def close(self) -> None:
        self.cluster.shutdown()
        self.cluster = None
