"""The benchmark's general part: it resolves a cell by name, drives it through
its traffic driver, reads its metrics and judges its outputs.

Everything that belongs to one cell lives in files of its own, found by name:

  * ``BENCHMARK.json`` (at the root of the checkout): the cell's configuration
    and traffic names, and which metrics it reports;
  * ``configs/<config>.json``: the deployment, its guarantees and the limits
    of the comparison that decides ``correct`` (the ``file`` of the entry);
  * ``traffic/<traffic>.json``: the traffic mix, naming its ``driver``;
  * ``traffic/<driver>.py``: a driver class (``Driver``) that builds the
    system under test, warms it up, drives the window, and hands the
    outputs and the inputs to the judge;
  * ``metrics/<metric>.py``: one reader (``read(reading)``) per per-layer
    metric, or ``metrics/<name>.py`` for the parts ``<name>.<part>`` of a
    metric split by the cells that report it; a reader that finds nothing to
    read returns ``None`` and the metric is left out of the line.

A run: set-up (the driver's ``setup``: the system, its inputs from the seed,
the cell's own operations warmed up), the window of ``seconds`` (traced by
``torch.profiler`` when ``trace`` is set or an end-to-end metric of the cell
is read from the device's trace), the drain of the operations still
in flight, the peak memory, the metrics, the program's state freed, and then
the judge, which compares the outputs against the plain reference in
``reference/``.
"""

from __future__ import annotations

import importlib.util
import json
import math
import sys
import time
from dataclasses import dataclass, field
from pathlib import Path
from types import ModuleType
from typing import Dict, List, Optional, Tuple

BENCH_DIR = Path(__file__).resolve().parent
FORBIDDEN_MODULES = ("jax", "jaxlib", "flax", "repro")


def phase(what: str, since: float) -> None:
    """Log a step of set-up with the seconds since ``since``."""
    print(f"[hoplite_bench] {what}: {time.perf_counter() - since:.3f} s", file=sys.stderr, flush=True)


def load_module(path: Path, name: str) -> ModuleType:
    """Import the file at ``path`` as a module named ``name``."""
    spec = importlib.util.spec_from_file_location(name, path)
    if spec is None or spec.loader is None:
        raise FileNotFoundError(path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def forbidden_modules(modules=None) -> List[str]:
    """Loaded modules whose top-level name (before the first dot) is one of
    ``FORBIDDEN_MODULES``, compared whole: ``repro_torch`` is not ``repro``."""
    names = sys.modules if modules is None else modules
    return sorted(n for n in names if n.split(".", 1)[0] in FORBIDDEN_MODULES)


@dataclass
class Cell:
    name: str
    config: dict
    traffic: dict
    chips: int
    end_to_end: List[dict]
    per_layer: List[dict]


class Bench:
    """``BENCHMARK.json`` and the files it names, resolved by name."""

    def __init__(self, root: Path):
        self.root = Path(root)
        self.spec = json.loads((self.root / "BENCHMARK.json").read_text())
        self.dir = self.root / self.spec["paths"][0]

    def config(self, name: str) -> dict:
        entry = next(c for c in self.spec["configs"] if c["name"] == name)
        return json.loads((self.root / entry["file"]).read_text())

    def traffic(self, name: str) -> dict:
        return json.loads((self.dir / "traffic" / f"{name}.json").read_text())

    def driver(self, name: str) -> ModuleType:
        return load_module(self.dir / "traffic" / f"{name}.py", f"hb_driver_{name}")

    def reader(self, metric: str) -> ModuleType:
        """``metrics/<metric>.py``; a metric split by the end-to-end metric
        it moves (``<name>.<part>``) without a file of its own is read by
        ``metrics/<name>.py``."""
        path = self.dir / "metrics" / f"{metric}.py"
        if not path.exists():
            path = self.dir / "metrics" / f"{metric.split('.', 1)[0]}.py"
        return load_module(path, "hb_metric_" + metric.replace(".", "_"))

    def reference(self, name: str) -> ModuleType:
        return load_module(self.dir / "reference" / f"{name}.py", f"hb_reference_{name}")

    @staticmethod
    def _reports(metric: dict, cell: str) -> bool:
        return "workloads" not in metric or cell in metric["workloads"]

    def cell(self, name: str) -> Cell:
        w = next((w for w in self.spec["workloads"] if w["name"] == name), None)
        if w is None:
            raise KeyError(f"no workload {name!r} in BENCHMARK.json")
        e2e = [m for m in self.spec["end_to_end"] if self._reports(m, name)]
        names = {m["name"] for m in e2e}
        per_layer = [m for m in self.spec["per_layer"] if self._reports(m, name) and m["moves"] in names]
        return Cell(name, self.config(w["config"]), self.traffic(w["traffic"]), w["chips"], e2e, per_layer)


class Spans:
    """Host spans the benchmark records around its calls into the program:
    (label, start, end) on ``time.perf_counter``.  Appends are atomic."""

    def __init__(self):
        self.items: List[Tuple[str, float, float]] = []

    def add(self, label: str, t0: float, t1: float) -> None:
        self.items.append((label, t0, t1))

    def within(self, label: str, t0: float, t1: float) -> List[Tuple[float, float]]:
        return [(a, b) for lab, a, b in self.items if lab == label and a >= t0 and b <= t1]


@dataclass
class Window:
    """What a driver's ``run`` reports about the measured window."""

    start: float
    close: float
    completed: int  # operations (collectives, rounds) completed in the window
    samples_ms: List[float]  # each completed operation's own latency
    attempted: int = 0
    failed: int = 0
    errors: List[str] = field(default_factory=list)
    stats0: Optional[dict] = None  # the program's counters at the start ...
    stats1: Optional[dict] = None  # ... and at the close

    @property
    def seconds(self) -> float:
        return self.close - self.start


@dataclass
class Trace:
    """Device activity of the traced window, read from the profiler."""

    window_s: float
    busy_s: float
    ops: Dict[str, Tuple[float, int]]  # device op name -> (seconds, count)
    idle: Dict[str, float]  # what the host was doing -> idle device seconds


@dataclass
class Reading:
    """Everything a metric reader may read."""

    cell: Cell
    window: Window
    spans: Spans
    trace: Optional[Trace]
    hbm_bytes_per_s: Optional[float]


# -- the device trace ----------------------------------------------------------


class Tracer:
    """``torch.profiler`` over the window.  CUPTI records every kernel and
    copy on the card, whichever host thread launched it; the CPU side records
    only this thread's marks, which place the host clock on the trace's."""

    MARK = "hoplite_bench.mark"

    def __init__(self, torch):
        from torch.profiler import ProfilerActivity, profile

        self.torch = torch
        self.cuda = torch.cuda.is_available()
        activities = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if self.cuda else [])
        self.prof = profile(activities=activities)
        self.marks: List[int] = []  # perf_counter_ns at each mark

    def start(self) -> None:
        self.prof.__enter__()

    def mark(self) -> None:
        from torch.profiler import record_function

        self.marks.append(time.perf_counter_ns())
        with record_function(self.MARK):
            pass

    def stop(self, label_of) -> Trace:
        """Stop, and reduce the trace to the device's busy time, its ops by
        name and its idle time by what the host was doing (``label_of(t)``
        names the host's activity at perf_counter time ``t``)."""
        from torch.autograd import DeviceType

        if self.cuda:
            self.torch.cuda.synchronize()
        self.prof.__exit__(None, None, None)
        events = self.prof.profiler.kineto_results.events()
        marks = sorted(e.start_ns() for e in events if e.name() == self.MARK)
        if len(marks) != 2 or len(self.marks) != 2:
            raise RuntimeError(f"the trace holds {len(marks)} window marks, not 2")
        offset = marks[0] - self.marks[0]  # trace ns minus perf_counter ns
        t0, t1 = marks
        dev = []
        for e in events:
            if e.device_type() != DeviceType.CUDA:
                continue
            s, d = e.start_ns(), e.duration_ns()
            a, b = max(s, t0), min(s + d, t1)
            if b > a:
                dev.append((a, b, e.name()))
        dev.sort()
        ops: Dict[str, Tuple[float, int]] = {}
        for a, b, name in dev:
            t, n = ops.get(name, (0.0, 0))
            ops[name] = (t + (b - a) / 1e9, n + 1)
        busy, idle, end = 0, {}, t0
        gaps = []
        for a, b, _ in dev:
            if a > end:
                gaps.append((end, a))
            if b > end:
                busy += b - max(a, end)
                end = b
        if t1 > end:
            gaps.append((end, t1))
        for a, b in gaps:
            label = label_of(((a + b) / 2 - offset) / 1e9)
            idle[label] = idle.get(label, 0.0) + (b - a) / 1e9
        return Trace(window_s=(t1 - t0) / 1e9, busy_s=busy / 1e9, ops=ops, idle=idle)


def top(items: Dict[str, float], n: int = 10) -> List[list]:
    return [[k, v] for k, v in sorted(items.items(), key=lambda kv: -kv[1])[:n]]


# -- one run ---------------------------------------------------------------------


def hbm_bytes_per_s(kind: str) -> Optional[float]:
    peaks = json.loads((BENCH_DIR / "peaks.json").read_text())["devices"]
    entry = peaks.get(kind)
    return None if entry is None else entry["hbm_bytes_per_s"]


def run_cell(root: Path, workload: str, seed: int, seconds: float, trace: bool, device: str = "cuda",
             t_process: Optional[float] = None, overrides: Optional[dict] = None, log=None,
             control: bool = False) -> dict:
    """Run ``workload`` once and return its result line as a dict (the keys
    ``correct``, ``attempted``, ``failed``, ``metrics``, ``device``, with
    ``--trace 1`` ``breakdown``, and last ``checks``).

    ``overrides`` replaces entries of the configuration and the traffic (the
    CPU tests run the cells at small sizes); ``t_process`` is the
    ``perf_counter`` reading at the process's start, from which ``setup_s``
    counts.  With ``control``, the line also holds ``control``: each
    control's readings (the reference in a precision below the
    configuration's, in the program's place), judged as the program's are."""
    import torch

    log = log or (lambda msg: print(msg, file=sys.stderr, flush=True))
    t_process = time.perf_counter() if t_process is None else t_process
    bench = Bench(root)
    cell = bench.cell(workload)
    for key, value in (overrides or {}).items():
        (cell.config if key in cell.config else cell.traffic)[key] = value
    spans = Spans()
    module = bench.driver(cell.traffic["driver"])
    driver = module.Driver(cell.config, cell.traffic, seed, device, spans, log)
    on_card = device != "cpu"

    def step(what: str) -> None:
        if on_card:
            torch.cuda.synchronize()
        phase(what, t_process)

    driver.setup(step)
    if on_card:
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
    # The profiler's own start is the benchmark's, not the system's set-up.
    setup_s = time.perf_counter() - t_process
    on_device = trace or any(m["source"] == "device_trace" for m in cell.end_to_end)
    tracer = Tracer(torch) if on_device else None
    if tracer:
        tracer.start()
        tracer.mark()
    t_start = time.perf_counter()
    window = Window(**driver.run(t_start, t_start + seconds))
    if tracer:
        tracer.mark()
    drained = driver.drain()
    window.failed, window.errors = drained["failed"], drained["errors"]
    for e in window.errors[:5]:
        log(f"[hoplite_bench] failed: {e}")
    result_trace = tracer.stop(driver.label_of) if tracer else None
    peak = torch.cuda.max_memory_allocated() if on_card else 0
    kind = torch.cuda.get_device_name() if on_card else "cpu"
    reading = Reading(cell, window, spans, result_trace, hbm_bytes_per_s(kind))
    metrics = {}
    if trace:
        for m in cell.per_layer:
            value = bench.reader(m["name"]).read(reading)
            if value is not None:
                metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    else:
        values = {"setup_s": setup_s}
        values.update(driver.end_to_end(window, result_trace))
        for m in cell.end_to_end:
            if m["name"] in values:
                metrics[m["name"]] = {"value": values[m["name"]], "unit": m["unit"]}
    log(f"[hoplite_bench] {workload} seed {seed}: setup {setup_s:.3f} s, window {window.seconds:.3f} s, "
        f"{window.completed} completed, {window.attempted} attempted, {window.failed} failed, "
        f"peak {peak} bytes on {kind}")
    checks = driver.judge(bench.reference(module.REFERENCE), cell.config["limits"], control)
    driver.close()
    found = forbidden_modules()
    if found:
        raise ForbiddenImport(found)
    correct = window.failed == 0 and all(c["value"] <= c["limit"] for c in checks.values())
    for name, c in checks.items():
        log(f"check {name} {c['value']!r} limit {c['limit']!r}")
    out = {"correct": correct, "attempted": window.attempted, "failed": window.failed, "metrics": metrics,
           "device": {"platform": "gpu" if on_card else "cpu", "kind": kind, "count": 1,
                      "memory_peak_bytes": peak}}
    if trace:
        out["device"]["busy_s"] = result_trace.busy_s
        out["device"]["window_s"] = result_trace.window_s
        out["breakdown"] = {"device_ops": top({k: t for k, (t, _) in result_trace.ops.items()}),
                            "idle_gaps": top(result_trace.idle)}
    if control:
        limits = cell.config["limits"]
        out["control"] = {c: {name: {"value": value, "limit": limits[name]}
                              for name, value in readings.items() if name in limits}
                          for c, readings in driver.control.items()}
    out["checks"] = checks
    return out


class ForbiddenImport(RuntimeError):
    def __init__(self, found):
        super().__init__("loaded after the window: " + ", ".join(found))
        self.found = found


def percentile(values: List[float], q: float) -> Optional[float]:
    """The nearest-rank ``q``-th percentile (the smallest value with at
    least ``q`` percent of the values at or below it); ``None`` when fewer
    than ten values lie beyond it."""
    n = len(values)
    rank = math.ceil(q / 100 * n)
    if n - rank < 10:
        return None
    return sorted(values)[rank - 1]
