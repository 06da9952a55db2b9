"""The port's spans and phase clocks (``conicip_tpu_torch.telemetry``).

On the CPU: each call of an entry leaves one tree of spans that every run
record of the call points to, opens no profiler range unless a profiler
runs, takes under a profiler alone the entry captured without telemetry,
and times the device loop's phases on the host's clock. The tests marked
``cuda`` hold the card's phase clock: an entry captured with telemetry
off carries no stamp, one captured with it on does, every graph replay
still goes through ``solver/graph.py:_play``, and ``watch(replays=True)``
times the replays of either.
"""

import functools

import numpy as np
import pytest
import torch

import conicip_tpu_torch as pt
from conicip_tpu_torch import solver, telemetry, trace
from conicip_tpu_torch.models import batched_small_sdp, box_qp_dense
from conicip_tpu_torch.parallel import batch as parallel_batch
from conicip_tpu_torch.solver import graph

T = telemetry


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU; the phase clock's stamp kernel "
                    "has no CPU mode")
    return torch.device("cuda")


@pytest.fixture(autouse=True)
def telemetry_off():
    telemetry.disable()
    yield
    telemetry.disable()


def box(n=12, seed=0):
    P = box_qp_dense(n=n, seed=seed)
    return (P.Q, P.c, P.A, P.b, P.cone_dims)


def wide_diag_qp(n=30):
    """A separable QP with a wide diagonal spread and one equality: at
    optTol=1e-10 the f32 tiers of the eliminated problem stall, and
    ``conic_ip``'s ladder climbs to the f64 tier (tests/test_torch_ladder.py)."""
    rng = np.random.default_rng(1)
    Q = np.diag(np.logspace(0, -6, n))
    c = rng.standard_normal(n) * np.logspace(0, -3, n)
    A = np.vstack([np.eye(n), -np.eye(n)])
    return (Q, c, A, -np.ones(2 * n), [("R", 2 * n)], np.ones((1, n)),
            np.array([0.3]))


def call_conic_ip():
    pt.conic_ip(*box(), device="cpu")
    return list(solver.runs)


def call_solve_batch():
    pt.solve_batch(*batched_small_sdp(3, k=3), device="cpu")
    return list(parallel_batch.runs)


def call_ladder():
    pt.conic_ip(*wide_diag_qp(), factor_dtype=torch.float32, optTol=1e-10,
                maxIters=40, device="cpu")
    runs = list(solver.runs)
    assert len(runs) == 3  # the f32 run and both rescue tiers
    return runs


def call_backstop():
    # a caller's f32 Schur solver on S cones: the main run stalls and the
    # backstop re-solves the stack on the eager loop
    pt.solve_batch(*batched_small_sdp(4, k=4), factor_dtype=torch.float32,
                   device="cpu", kktsolver=functools.partial(
                       pt.kktsolver_schur, factor_dtype=torch.float32))
    runs = list(parallel_batch.runs)
    assert [r.loop for r in runs] == ["chunks", "eager"]
    return runs


CALLS = {"conic_ip": call_conic_ip, "solve_batch": call_solve_batch,
         "ladder": call_ladder, "backstop": call_backstop}


def inside(s, outer) -> bool:
    return outer.start_ns <= s.start_ns and s.end_ns <= outer.end_ns


def check_tree(record):
    roots = [s for s in record.spans if s.parent is None]
    assert len(roots) == 1 and roots[0] is record.root
    root = record.root
    assert root.name == T.CALL
    assert {s.call for s in record.spans} == {record.id}
    for s in record.spans:
        assert s.end_ns is not None and s.start_ns <= s.end_ns
        assert inside(s, root)
        if s is root:
            continue
        # the innermost span around it that opened before it is its parent
        around = [p for p in record.spans if p is not s and inside(s, p)
                  and p.start_ns <= s.start_ns
                  and record.spans.index(p) < record.spans.index(s)]
        assert around and max(around, key=lambda p: p.start_ns).name == (
            s.parent), s
    prepare = record.named(T.PREPARE)
    assert len(prepare) == 1 and prepare[0] is record.spans[1]
    later = [s for s in record.spans[2:] if s.parent == T.CALL]
    assert later and all(prepare[0].end_ns <= s.start_ns for s in later)


@pytest.mark.parametrize("entry", sorted(CALLS))
def test_each_call_leaves_one_tree_of_spans_in_its_runs(entry):
    with telemetry.watch() as calls:
        runs = CALLS[entry]()
    (record,) = calls
    assert all(r.spans is record for r in runs)
    check_tree(record)
    waits, finishes = record.named(T.WAIT), record.named(T.FINISH)
    # one finish per run, and at least the final read of each
    assert len(finishes) == len(runs) and len(waits) >= len(runs)
    for s in waits + finishes:
        assert inside(s, record.root)
    device_loop = [r for r in runs if r.loop != "eager"]
    assert len(record.named(T.LOOP)) == len(device_loop)
    assert len(record.named(T.COPY_IN)) == len(device_loop)
    for loop in record.named(T.LOOP):
        assert loop.parent == T.CALL


def test_calls_get_ids_of_their_own():
    with telemetry.watch() as calls:
        first = call_conic_ip()
        second = call_conic_ip()
    assert [c.id for c in calls] == [first[0].spans.id, second[0].spans.id]
    assert calls[0].id != calls[1].id
    assert telemetry.current() is None


def test_spans_outside_a_call_record_nothing():
    with telemetry.span(T.LOOP):
        assert telemetry.current() is None
    with telemetry.call():
        record = telemetry.current()
        with telemetry.span(T.WAIT), telemetry.call():  # a call in a call
            pass
    assert [(s.name, s.parent) for s in record.spans] == [
        (T.CALL, None), (T.WAIT, T.CALL), (T.CALL, T.WAIT)]


def test_no_profiler_range_opens_without_a_profiler(monkeypatch):
    opened = []

    def counted(name):
        opened.append(name)
        return torch.profiler.record_function(name)

    monkeypatch.setattr(telemetry, "record_function", counted)
    call_conic_ip()
    call_solve_batch()
    assert opened == []
    assert not graph.cache_info()[-1][-3]  # telemetry off at the key


def test_a_profiler_sees_each_span_as_a_range():
    from torch.profiler import ProfilerActivity, profile

    call_conic_ip()
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        assert telemetry.on()
        runs = call_conic_ip()
    names = [e.name for e in prof.events() if e.name.startswith("conicip::")]
    assert sorted(set(names)) == sorted({s.name for s in runs[0].spans.spans})
    assert names.count(T.CALL) == 1
    assert not telemetry.on()


@pytest.mark.parametrize("entry", ["conic_ip", "solve_batch", "ladder"])
def test_cpu_phases_are_host_time_inside_the_loop(entry):
    runs = CALLS[entry]()
    loops = runs[0].spans.named(T.LOOP)
    assert len(loops) == len(runs)
    for run, loop in zip(runs, loops):
        assert run.loop == "chunks" and set(run.phases) == set(T.PHASES)
        assert all(v >= 0 for v in run.phases.values())
        assert sum(run.phases.values()) <= loop.ns
        # every unit builds, steps and evaluates
        assert run.units == 0 or min(run.phases.values()) > 0


def test_the_eager_loop_reports_no_phases():
    runs = call_backstop()
    assert runs[0].phases is not None and runs[1].phases is None
    assert runs[1].units == 0


def test_a_host_clock_counts_only_between_stamps():
    clock = telemetry.HostClock()
    with telemetry.clocked(clock):
        telemetry.reset()
        telemetry.phase(T.KKT_BUILD)
        telemetry.mark()
        telemetry.phase(T.STEP)
        telemetry.phase(T.EVALUATE)
    ns = clock.read()
    assert list(ns) == list(T.PHASES) and all(v >= 0 for v in ns.values())
    # outside the context no clock is installed
    telemetry.phase(T.STEP)
    assert clock.read() == ns


def test_a_profiler_alone_takes_the_entry_captured_without_telemetry():
    from torch.profiler import ProfilerActivity, profile

    graph.clear()
    try:
        call_conic_ip()  # captured with telemetry off
        with profile(activities=[ProfilerActivity.CPU]):
            assert telemetry.on() and not telemetry.enabled()
            assert call_conic_ip()[0].cache_hit
            telemetry.enable()  # asks for the phase clock: a new entry
            assert not call_conic_ip()[0].cache_hit
            telemetry.disable()
        assert [key[-3] for key in graph.cache_info()] == [False, True]
        graph.clear()
        # with no entry of telemetry off, a profiler captures one with it
        # on and takes that
        with profile(activities=[ProfilerActivity.CPU]):
            assert not call_conic_ip()[0].cache_hit
            assert call_conic_ip()[0].cache_hit
        assert [key[-3] for key in graph.cache_info()] == [True]
    finally:
        graph.clear()


@pytest.mark.parametrize("device", ["cpu", "cuda"])
def test_the_cache_key_carries_telemetry(device):
    if device == "cuda" and not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    graph.clear()
    try:
        pt.conic_ip(*box(), device=device)
        telemetry.enable()
        pt.conic_ip(*box(), device=device)
        assert not solver.runs[0].cache_hit
        telemetry.disable()
        pt.conic_ip(*box(), device=device)
        assert solver.runs[0].cache_hit
        # least recently used first: the entry captured with telemetry on
        on, off = graph.cache_info()
        assert (off[-3], on[-3]) == (False, True)
        assert off[:-3] == on[:-3] and off[-2:] == on[-2:]
    finally:
        graph.clear()


@pytest.mark.cuda
def test_telemetry_off_captures_no_stamp_and_every_replay_plays(
        cuda, monkeypatch):
    stamps, plays = [], []
    real_launch, real_play = telemetry.DeviceClock._launch, graph._play

    def launch(self, slot):
        stamps.append(slot)
        real_launch(self, slot)

    def play(g, deltas):
        plays.append(g)
        real_play(g, deltas)

    monkeypatch.setattr(telemetry.DeviceClock, "_launch", launch)
    monkeypatch.setattr(graph, "_play", play)
    graph.clear()
    try:
        for hit in (False, True):  # a miss, then a hit
            sol = pt.conic_ip(*box(), device=cuda)
            (run,) = solver.runs
            assert run.cache_hit == hit and sol.status == "Optimal"
            assert run.phases is None and not run.spans.replays
        assert stamps == []
        # each call plays the prologue's graph and the loop's
        assert len(plays) == 4 and plays[2:] == plays[:2]
        telemetry.enable()
        for hit in (False, True):
            sol = pt.conic_ip(*box(), device=cuda)
            (run,) = solver.runs
            assert run.cache_hit == hit and sol.status == "Optimal"
            assert set(run.phases) == set(T.PHASES)
            assert all(v > 0 for v in run.phases.values())
            record = run.spans
            assert len(record.replays) == 2
            if hit:
                # the stamps lie inside the graphs' replays (a miss also
                # clocks its eager first unit)
                assert sum(run.phases.values()) <= record.replay_ms() * 1e6
        assert stamps and len(plays) == 8
    finally:
        graph.clear()


@pytest.mark.cuda
def test_watch_with_replays_times_the_graphs_with_telemetry_off(cuda):
    graph.clear()
    try:
        pt.conic_ip(*box(), device=cuda)  # the miss, telemetry off
        with telemetry.watch(replays=True) as calls:
            pt.conic_ip(*box(), device=cuda)
        (run,) = solver.runs
        assert run.cache_hit and run.phases is None
        (record,) = calls
        assert record is run.spans and len(record.replays) == 2
        assert record.replay_ms() > 0
        # after the watch, no events
        pt.conic_ip(*box(), device=cuda)
        assert not solver.runs[0].spans.replays
        graphs_ms, whiles, per_unit = trace.graph_device_ms(
            lambda: pt.conic_ip(*box(), device=cuda), reps=3,
            runs=solver.runs)
        assert graphs_ms > 0 and whiles == 1 and per_unit is None
        assert [key[-3] for key in graph.cache_info()] == [False]
    finally:
        graph.clear()
