"""The metrics' arithmetic on synthetic windows and traces: a rate is all
the work over all the time, a tail is over every call, and the trace's
reduction counts each busy microsecond once."""

import time
from types import SimpleNamespace

import pytest

from portbench import tracefile
from portbench.endtoend import call_ms_p95, solves_per_s
from portbench.harness import Answer, Record, closed_loop
from portbench.metrics import device_idle_share, host_ms_per_call


def window(walls, batch=1):
    """Calls back to back, each certifying its whole batch."""
    records, t = [], 0.0
    for w in walls:
        records.append(Record(0, t, Answer(None, None, None,
                                           ["Optimal"] * batch, [7] * batch,
                                           []), wall=w))
        t += w
    return SimpleNamespace(records=records, window_s=t,
                           certified=batch * len(walls), traced=False)


def test_rate_is_all_work_over_all_time():
    ctx = window([0.010] * 100, batch=64)
    assert solves_per_s.read(ctx) == pytest.approx(6400.0)


def test_one_stall_moves_the_rate_and_the_tail():
    calm = window([0.010] * 100)
    # 10 of 100 calls stall: a p95 over every call sees them, a median of
    # chunks would not
    stalled = window([0.010] * 90 + [0.100] * 10)
    assert solves_per_s.read(stalled) < 0.55 * solves_per_s.read(calm)
    assert call_ms_p95.read(calm) == pytest.approx(10.0)
    assert call_ms_p95.read(stalled) == pytest.approx(100.0)
    # a single stall among 100 calls moves the rate by its length
    one = window([0.010] * 99 + [1.0])
    assert solves_per_s.read(one) == pytest.approx(100 / 1.99)


def test_the_closed_loop_times_every_call_on_the_host_clock():
    """A synthetic entry with one stall: the window holds every call's
    time, and the call's time is what the host waited for it."""
    sleeps = iter([0.002] * 5 + [0.060] + [0.002] * 1000)

    def call(ops):
        time.sleep(next(sleeps))
        return Answer(None, None, None, ["Optimal"], [7], [])

    pool = SimpleNamespace(slots=4, operands=lambda slot: {})
    records, window_s = closed_loop(call, pool, 0.2, "cpu")
    walls = [r.wall for r in records]
    assert [r.slot for r in records[:6]] == [0, 1, 2, 3, 0, 1]
    assert walls[5] >= 0.060 and max(walls[:5]) < 0.060
    assert window_s >= sum(walls) and window_s >= 0.2
    assert window_s == pytest.approx(records[-1].start + walls[-1])
    ctx = SimpleNamespace(records=records, window_s=window_s,
                          certified=len(records))
    assert solves_per_s.read(ctx) == pytest.approx(len(records) / window_s)


def test_host_ms_is_wall_minus_graph_time():
    ctx = window([0.010, 0.020])
    ctx.traced = True
    ctx.records[0].device_ms, ctx.records[1].device_ms = 8.0, 15.0
    assert host_ms_per_call.read(ctx) == pytest.approx(3.5)
    ctx.traced = False
    assert host_ms_per_call.read(ctx) is None


def ev(cat, name, ts, dur):
    return dict(cat=cat, name=name, ts=ts, dur=dur)


def test_busy_time_is_a_union_clipped_to_the_stretch():
    events = [ev("kernel", "a", 0, 10), ev("kernel", "b", 5, 10),
              ev("gpu_memcpy", "c", 30, 10), ev("kernel", "d", 95, 20)]
    assert tracefile.busy_us(events, 0, 100) == pytest.approx(15 + 10 + 5)
    ctx = SimpleNamespace(trace=SimpleNamespace(
        busy_s=30e-6, window_s=100e-6))
    assert device_idle_share.read(ctx) == pytest.approx(70.0)


def test_idle_gaps_are_put_down_to_the_host_event_running():
    device = [ev("kernel", "k", 0, 10), ev("kernel", "k", 50, 10)]
    host = [ev("cuda_runtime", "cudaGraphLaunch", 5, 20),
            ev("cpu_op", "aten::copy_", 30, 15),
            ev("user_annotation", "span", 0, 100)]
    gaps = dict(tracefile.idle_gaps(device + host, device, 0, 100,
                                    skip=("span",)))
    # gap 10-50 (middle 30: the copy), gap 60-100 (middle 80: nothing)
    assert gaps == pytest.approx({"host: aten::copy_": 40e-6,
                                  "host: untraced": 40e-6})
    ops = tracefile.device_ops(device)
    assert ops == [["k", pytest.approx(20e-6)]]


def test_stretch_is_the_harness_span():
    events = [ev("user_annotation", "portbench::stretch", 10, 90),
              ev("gpu_user_annotation", "portbench::stretch", 12, 80)]
    assert tracefile.stretch(events, "portbench::stretch") == (10, 100)


def test_the_result_line_is_strict_json():
    import json

    from portbench.run import finite

    out = {"check": {"dual_res": {"value": float("nan"), "limit": 1e-9}},
           "metrics": [1.5, float("inf")]}
    line = json.dumps(finite(out), allow_nan=False)
    assert json.loads(line)["check"]["dual_res"]["value"] == "nan"
