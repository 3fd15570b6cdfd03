"""The asynchronous parameter server on ``Runtime`` (paper section 6.3,
Figure 1b), as a closed loop of rounds.

``workers`` workers each own a least-squares shard (``X``, ``y``) and
compute the gradient ``X^T (X w - y) / samples`` of it as a ``Runtime`` task
on their own node, from the parameters ``w`` the task was given.  Each task
first sleeps its delay, the time its worker would take to compute a
gradient on a machine of its own, which the one card the workers share
cannot give them; the delays are ``delay_values`` evenly spaced values in
``delay_ms`` (low, high), the same set for every seed, dealt out in an order
the seed draws, each value once in every pass through the set.  A round (the
structure of ``repro_torch/examples/async_parameter_server.py``'s loop):

  1. ``Runtime.wait`` for the first ``take`` of the gradient tasks in flight;
  2. ``Runtime.reduce`` of their results with SUM, and ``get`` of the sum;
  3. ``w = get(w_ref) + sum * (-lr / take)``, ``put`` as the new ``w_ref``;
  4. one new gradient task for each worker taken, on the new parameters.

The round ends once the card has run everything enqueued in it (a CUDA
event waited on, asleep).  The driver records which worker's gradient, on which
version of ``w``, each round reduced, and deletes every object once nothing
needs it.  It keeps the parameters of ``reservoir`` rounds of the window,
drawn uniformly by the seed, and those of the last round, for the judge.

Configuration: ``nodes``, ``executors_per_node``, ``workers``, ``dim``,
``samples``, ``take``, ``lr_scale`` (the learning rate is
``lr_scale * samples / dim``).  Traffic: ``warmup_rounds``, ``reservoir``,
``delay_ms``, ``delay_values``.
"""

from __future__ import annotations

import bisect
import random
import time
import torch

from hoplite_bench import inputs

REFERENCE = "parameter_server"


def learning_rate(config: dict) -> float:
    return float(config["lr_scale"]) * int(config["samples"]) / int(config["dim"])


class Driver:
    def __init__(self, config: dict, traffic: dict, seed: int, device: str, spans, log):
        self.nodes = int(config["nodes"])
        self.executors = int(config["executors_per_node"])
        self.workers = int(config["workers"])
        self.dim, self.samples, self.take = int(config["dim"]), int(config["samples"]), int(config["take"])
        self.lr = learning_rate(config)
        self.warmup_rounds = int(traffic["warmup_rounds"])
        self.reservoir_size = int(traffic["reservoir"])
        lo, hi = (float(v) / 1e3 for v in traffic["delay_ms"])
        n = int(traffic["delay_values"])
        self.delay_set = [lo + (hi - lo) * (i + 0.5) / n for i in range(n)]
        self.delays = []  # the rest of the current pass through the set
        self.seed, self.device, self.spans, self.log = seed, torch.device(device), spans, log
        self.rng = random.Random(seed)
        self.dealer = random.Random(f"{seed}.delays")
        self.membership = []  # per round: [(worker, version of w the gradient used)]
        self.task_of = {}  # ref id -> (worker, version)
        self.users = {}  # version -> gradient tasks given it and not yet reduced
        self.versions = {}  # version -> ObjectRef of w
        self.kept = []  # versions of the window kept for the judge
        self.seen = 0
        self.errors = []

    # -- the system and its inputs ---------------------------------------------------

    def setup(self, step=lambda what: None) -> None:
        from repro_torch.runtime import Runtime

        step("imported the program")
        torch.backends.cuda.matmul.allow_tf32 = False
        self.rt = Runtime(num_nodes=self.nodes, executors_per_node=self.executors, device=self.device)
        step("runtime")
        self.shards = inputs.least_squares_shards(self.seed, self.device, self.workers, self.samples, self.dim)
        self.version = 0
        step("shards")
        self.versions[0] = self.rt.put(torch.zeros(self.dim, dtype=torch.float32, device=self.device))
        self.inflight = [self._launch(w) for w in range(self.workers)]
        for _ in range(self.warmup_rounds):
            self._round()
        step("warm-up")

    def _gradient(self, w, worker, delay):
        X, y = self.shards[int(worker)]
        time.sleep(float(delay))
        resid = X @ w - y
        return X.T @ resid / len(y)

    def _delay(self) -> float:
        if not self.delays:
            self.delays = list(self.delay_set)
            self.dealer.shuffle(self.delays)
        return self.delays.pop()

    def _launch(self, worker: int):
        ref = self.rt.remote(self._gradient, self.versions[self.version], worker, self._delay(),
                             node=worker % self.nodes)
        self.task_of[ref.id] = (worker, self.version)
        self.users[self.version] = self.users.get(self.version, 0) + 1
        return ref

    def _round(self) -> None:
        from repro_torch.core.api import SUM

        rt, span = self.rt, self.spans.add
        t0 = time.perf_counter()
        done, self.inflight = rt.wait(self.inflight, num_returns=self.take, timeout=120)
        t1 = time.perf_counter()
        span("wait", t0, t1)
        if len(done) < self.take:
            raise TimeoutError(f"{len(done)} of {self.take} gradients in 120 s")
        gsum = rt.reduce(done, SUM)
        g = rt.get(gsum)
        t2 = time.perf_counter()
        span("reduce and get", t1, t2)
        w = g / self.take * (-self.lr) + rt.get(self.versions[self.version])
        t3 = time.perf_counter()
        span("get w and update", t2, t3)
        self.version += 1
        self.versions[self.version] = rt.put(w)
        t4 = time.perf_counter()
        span("put", t3, t4)
        self.membership.append([self.task_of[d.id] for d in done])
        self.inflight += [self._launch(self.task_of[d.id][0]) for d in done]
        t5 = time.perf_counter()
        span("launch", t4, t5)
        if self.device.type == "cuda":
            ev = torch.cuda.Event(blocking=True)
            ev.record()
            ev.synchronize()
        t6 = time.perf_counter()
        span("device", t5, t6)
        # What no task, no later round and the judge needs any more.
        rt.delete(done + [gsum])
        for d in done:
            v = self.task_of.pop(d.id)[1]
            self.users[v] -= 1
        self._release()
        span("delete", t6, time.perf_counter())

    def _release(self) -> None:
        kept = set(self.kept)
        for v in [v for v, n in self.users.items() if n == 0 and v != self.version and v not in kept]:
            del self.users[v]
            self.rt.delete([self.versions.pop(v)])

    def _offer(self, version: int) -> None:
        """Reservoir sampling of the window's versions (see collective.py)."""
        self.seen += 1
        if len(self.kept) < self.reservoir_size:
            self.kept.append(version)
            return
        j = self.rng.randrange(self.seen)
        if j < self.reservoir_size:
            old, self.kept[j] = self.kept[j], version
            if self.users.get(old, 0) == 0 and old != self.version:
                self.users.pop(old, None)
                self.rt.delete([self.versions.pop(old)])

    # -- the window ----------------------------------------------------------------------

    def run(self, t_start: float, t_end: float) -> dict:
        durations, attempted = [], 0
        stats0 = self.rt.cluster.stats
        close = t_start
        while time.perf_counter() < t_end:
            attempted += 1
            t0 = time.perf_counter()
            try:
                self._round()
            except Exception as e:  # noqa: BLE001 -- counted as failed, judged not correct
                self.errors.append(f"round {len(self.membership)}: {e!r}")
                break
            close = time.perf_counter()
            durations.append((close - t0) * 1e3)
            self._offer(self.version)
        return {"start": t_start, "close": close, "completed": len(durations), "samples_ms": durations,
                "attempted": attempted, "stats0": stats0, "stats1": self.rt.cluster.stats}

    def drain(self) -> dict:
        _, rest = self.rt.wait(self.inflight, num_returns=len(self.inflight), timeout=120)
        hung = len(rest)
        groups = {tuple(sorted(worker for worker, _ in m)) for m in self.membership}
        stale = {}
        for r, m in enumerate(self.membership):
            for _, v in m:
                stale[r - v] = stale.get(r - v, 0) + 1
        self.log(f"[hoplite_bench] {len(self.membership)} rounds reduced {len(groups)} distinct groups of workers; "
                 f"gradients by versions behind: {dict(sorted(stale.items()))}")
        return {"failed": len(self.errors) + hung, "errors": list(self.errors)}

    def end_to_end(self, window, trace=None) -> dict:
        return {"round_ms": window.seconds * 1e3 / window.completed} if window.completed else {}

    def label_of(self, t: float) -> str:
        """The step of the round the server was in at ``t`` (its spans follow
        one another; read once the window has closed)."""
        if not hasattr(self, "_sorted"):
            self._sorted = sorted((a, b, label) for label, a, b in self.spans.items)
            self._starts = [a for a, _, _ in self._sorted]
        i = bisect.bisect_right(self._starts, t) - 1
        if i >= 0 and t < self._sorted[i][1]:
            return self._sorted[i][2]
        return "between rounds"

    # -- the judge -------------------------------------------------------------------------

    def judge(self, reference, limits: dict, control: bool = False) -> dict:
        """Hold the kept versions of ``w`` (and the last) to the plain
        reference's, recomputed from the shards and each round's membership."""
        wanted = sorted(set(self.kept) | {self.version})
        got = {v: self.rt.get(self.versions[v]) for v in wanted if v in self.versions}
        self.rt.delete(list(self.versions.values()))
        self.rt.cluster.shutdown()
        self.rt, self.versions, self.inflight = None, {}, []
        if self.device.type == "cuda":
            torch.cuda.empty_cache()
        args = (self.shards, self.membership, self.lr, self.take, self.dim)
        readings = reference.judge(*args, got, wanted)
        del got
        if control:
            self.control = reference.controls(*args, wanted)
        return {name: {"value": readings[name], "limit": limit} for name, limit in limits.items()}

    def close(self) -> None:
        self.shards = None
