"""The benchmark's general machinery: a cell's files, its pool of
instances, the closed loop, the graph spans and the profiled stretch.

Everything that belongs to one configuration, traffic mix or metric lives
in a file of its own, found by the name that ``BENCHMARK.json`` gives:

- ``configs/<file>.json``: the deployment (its problem ``family``, sizes,
  dtype and solver options); ``families/<family>.py`` makes its instances
  on the device from a ``torch.Generator`` and names its plain reference;
- ``traffic/<traffic>.json``: the entry called (``conic_ip`` or
  ``solve_batch``), the instances per call (``batch``) and how many calls'
  worth of distinct instances the pool holds (``pool``);
- ``limits/<workload>.json``: each number the correctness check compares,
  with its limit (``check.py``);
- ``endtoend/<metric>.py`` and ``metrics/<metric>.py``: one reader per
  metric, ``read(ctx)``, returning a number or None (nothing to read);
- ``roofline/<kernel>.py``: a kernel's work, by formula.

The program under test is ``conicip_tpu_torch``; it is imported inside the
functions that drive it, after ``run.py`` has fixed the cache directories.
"""

from __future__ import annotations

import gc
import importlib
import json
import os
import tempfile
import time
from collections import Counter
from dataclasses import dataclass, field
from pathlib import Path
from types import SimpleNamespace

import torch

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent

# the harness's own span around the profiled stretch of hits, and the
# fewest calls it holds
STRETCH = "portbench::stretch"
STRETCH_CALLS = 3


@dataclass
class Cell:
    name: str
    config: dict
    traffic: dict
    chips: int
    limits: dict
    end_to_end: list
    per_layer: list


def _json(path: Path):
    with open(path) as f:
        return json.load(f)


def load_cell(name: str, bench: dict | None = None) -> Cell:
    """The workload ``name`` of ``BENCHMARK.json`` with its configuration,
    traffic, limits and metrics (raises KeyError for an unknown name)."""
    bench = bench if bench is not None else _json(ROOT / "BENCHMARK.json")
    work = {w["name"]: w for w in bench["workloads"]}[name]
    conf = {c["name"]: c for c in bench["configs"]}[work["config"]]

    def mine(metric):
        return name in metric.get("workloads", [name])

    return Cell(
        name=name,
        config=_json(ROOT / conf["file"]),
        traffic=_json(HERE / "traffic" / f"{work['traffic']}.json"),
        chips=int(work["chips"]),
        limits=_json(HERE / "limits" / f"{name}.json"),
        end_to_end=[m for m in bench["end_to_end"] if mine(m)],
        per_layer=[m for m in bench["per_layer"] if mine(m)],
    )


def family(config: dict):
    return importlib.import_module(f"portbench.families.{config['family']}")


def sync(device) -> None:
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize()


class Pool:
    """The cell's distinct instances, made on ``device`` from ``seed`` at
    set-up: ``traffic["pool"]`` calls' worth of ``traffic["batch"]``
    instances each; call i takes slot i mod pool. The family names every
    operand by the entry's keyword: ``each`` (a leading instance axis),
    ``shared`` (one tensor for every instance; a stack gets it stacked
    once) and ``cone_dims``."""

    def __init__(self, config, traffic, seed, device):
        self.batch = int(traffic["batch"])
        self.slots = int(traffic["pool"])
        self.stacked = traffic["entry"] == "solve_batch"
        gen = torch.Generator(device=device)
        gen.manual_seed(int(seed))
        made = family(config).instances(
            config, self.batch * self.slots, gen, device)
        self.each, self.shared = made["each"], made["shared"]
        self.cone_dims = made["cone_dims"]
        self._shared = self.shared
        if self.stacked:
            self._shared = {k: x.expand(self.batch, *x.shape).clone()
                            for k, x in self.shared.items()}

    def rows(self, slot) -> slice:
        return slice(slot * self.batch, (slot + 1) * self.batch)

    def stack(self, rows: slice) -> dict:
        """Every operand of the instances ``rows`` with a leading instance
        axis (shared ones expanded, not copied), and ``cone_dims``."""
        k = rows.stop - rows.start
        out = {name: x[rows] for name, x in self.each.items()}
        out.update({name: x.expand(k, *x.shape)
                    for name, x in self.shared.items()})
        out["cone_dims"] = self.cone_dims
        return out

    def operands(self, slot) -> dict:
        """The keyword operands of the entry for call slot ``slot``."""
        pick = self.rows(slot) if self.stacked else slot
        out = {name: x[pick] for name, x in self.each.items()}
        out.update(self._shared)
        out["cone_dims"] = self.cone_dims
        return out


@dataclass
class Answer:
    """What one call returned: per instance y, w, v, the status name and
    the iterations, and the program's record of its interior-point runs."""

    y: torch.Tensor  # (batch, n)
    w: torch.Tensor  # (batch, p)
    v: torch.Tensor  # (batch, m)
    status: list
    iters: object  # list of ints, or a tensor on the device
    runs: list


def make_call(program, traffic, options, device):
    """The timed path: one call of the traffic's entry on a slot's
    keyword operands (``Pool.operands``), ending with its result on the
    host (statuses read, the stream drained)."""
    if traffic["entry"] == "conic_ip":
        def call(ops):
            sol = program.conic_ip(**ops, device=device, **options)
            sync(device)
            return Answer(sol.y[None], sol.w[None], sol.v[None],
                          [sol.status], [sol.Iter],
                          list(program.solver.runs))
    elif traffic["entry"] == "solve_batch":
        def call(ops):
            sol = program.solve_batch(**ops, device=device, **options)
            status = sol.statuses
            sync(device)
            return Answer(sol.y, sol.w, sol.v, status, sol.Iter,
                          list(program.parallel.batch.runs))
    else:
        raise ValueError(f"unknown entry {traffic['entry']!r}")
    return call


@dataclass
class Record:
    slot: int
    start: float  # s from the window's start, host clock
    answer: Answer
    wall: float  # s, the call's start to its result on the host
    spans: list = field(default_factory=list)  # CUDA event pairs
    device_ms: float = 0.0  # the spans' device time


class GraphSpans:
    """CUDA events around every replay of the program's captured graphs,
    by wrapping ``solver/graph.py:_play`` (the method of the program's
    ``trace.graph_device_ms``, copied): the device time of each call's
    replays, with no profiler."""

    def __init__(self, graph_module):
        self.graph = graph_module
        self.spans = []

    def _timed(self, g, deltas):
        t0 = torch.cuda.Event(enable_timing=True)
        t1 = torch.cuda.Event(enable_timing=True)
        t0.record()
        self._real(g, deltas)
        t1.record()
        self.spans.append((t0, t1))

    def take(self) -> list:
        out, self.spans = self.spans, []
        return out

    def __enter__(self):
        self._real = self.graph._play
        self.graph._play = self._timed
        return self

    def __exit__(self, *exc):
        self.graph._play = self._real


def closed_loop(call, pool, seconds, device, spans=None):
    """One client, closed loop: calls back to back over the pool's slots
    until ``seconds`` have passed on the host's clock since the first
    began; the call running then finishes. Each call is timed on the
    host's clock from its start to its result on the host. Returns the
    records and the window's length in s, from the first call's start to
    the last one's result."""
    records = []
    start = time.perf_counter()
    i = 0
    while True:
        t0 = time.perf_counter()
        if records and t0 - start >= seconds:
            break
        slot = i % pool.slots
        answer = call(pool.operands(slot))
        records.append(Record(slot, t0 - start, answer,
                              time.perf_counter() - t0,
                              spans.take() if spans else []))
        i += 1
    window = records[-1].start + records[-1].wall
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize()
    for r in records:
        r.device_ms = sum(a.elapsed_time(b) for a, b in r.spans)
        r.spans = []
    return records, window


def _counters(program) -> dict:
    """The program's launch counters that metrics read."""
    from conicip_tpu_torch.ops import jacobi_kernel
    return dict(jacobi=Counter(jacobi_kernel.jacobi_launches))


def profiled_stretch(program, call, pool, stretch_s):
    """The traced phase: empty the program's graph cache, start the
    profiler, warm the cell's shape again inside the session (its graphs
    captured there, so that the profiler records their bodies whole), then
    time a stretch of hits of at least ``stretch_s`` and
    :data:`STRETCH_CALLS` inside the harness's span :data:`STRETCH`.
    Returns a namespace: the stretch's answers, the chrome-trace events
    and the counters' growth over the stretch."""
    from torch.profiler import ProfilerActivity, profile, record_function

    program.solver.graph.clear()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        call(pool.operands(0))  # the miss: captured in the session
        call(pool.operands(1 % pool.slots))
        torch.cuda.synchronize()
        before = _counters(program)
        answers = []
        with record_function(STRETCH):
            t = time.perf_counter()
            i = 2
            while (time.perf_counter() - t < stretch_s
                   or len(answers) < STRETCH_CALLS):
                answers.append(call(pool.operands(i % pool.slots)))
                i += 1
            torch.cuda.synchronize()
        after = _counters(program)
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "trace.json")
        prof.export_chrome_trace(path)
        events = _json(Path(path))["traceEvents"]
    del prof
    gc.collect()
    return SimpleNamespace(
        answers=answers, events=events,
        counters={k: after[k] - before[k] for k in after})


def read_metrics(specs, pkg, ctx) -> dict:
    """Each metric of ``specs`` whose reader ``portbench/<pkg>/<name>.py``
    finds something to read: {name: {"value", "unit"}}."""
    out = {}
    for spec in specs:
        reader = importlib.import_module(f"portbench.{pkg}.{spec['name']}")
        value = reader.read(ctx)
        if value is not None:
            out[spec["name"]] = {"value": value, "unit": spec["unit"]}
    return out
