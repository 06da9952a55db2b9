"""The readers of the program's own spans and phase clocks, on synthetic
windows, stretches and traces: what each counts, and that each finds
nothing to read where the program records nothing (a program without
spans or phase clocks, an untraced run, an eager run)."""

from types import SimpleNamespace

import pytest

from portbench.harness import Answer, Record
from portbench.metrics import (evaluate_ms_per_iter, host_busy_ms_per_call,
                               host_idle_share, kkt_build_ms_per_iter,
                               step_ms_per_iter)


def span(name, parent, start_ms, end_ms):
    return SimpleNamespace(name=name, parent=parent,
                           start_ns=int(start_ms * 1e6),
                           end_ns=int(end_ms * 1e6))


def call_record(call_ms, waits_ms):
    """One call's span record: the root, then its waits, one after the
    other from 1 ms on."""
    spans = [span("conicip::call", None, 0, call_ms),
             span("conicip::prepare", "conicip::call", 0, 0.5)]
    t = 1.0
    for w in waits_ms:
        spans.append(span("conicip::wait", "conicip::call", t, t + w))
        t += w
    return SimpleNamespace(spans=spans)


def run(units=7, phases=None, spans=None):
    return SimpleNamespace(units=units, phases=phases, spans=spans)


def window(records, traced=True):
    out = [Record(i, 0.0, Answer(None, None, None, ["Optimal"], [7], runs),
                  wall=0.01) for i, runs in enumerate(records)]
    return SimpleNamespace(records=out, traced=traced)


def test_host_busy_is_the_call_less_its_waits_averaged_over_calls():
    a = call_record(10.0, [8.0])
    b = call_record(12.0, [6.0, 2.0])  # a ladder: two runs, two waits
    ctx = window([[run(spans=a)], [run(spans=b), run(spans=b)]])
    assert host_busy_ms_per_call.read(ctx) == pytest.approx((2.0 + 4.0) / 2)


def test_host_busy_reads_the_root_span_only():
    # a call made inside a call is a child span of the same name
    rec = call_record(10.0, [8.0])
    rec.spans.append(span("conicip::call", "conicip::loop", 2.0, 3.0))
    ctx = window([[run(spans=rec)]])
    assert host_busy_ms_per_call.read(ctx) == pytest.approx(2.0)


def test_host_busy_has_nothing_to_read_without_spans_or_a_trace():
    ctx = window([[run(spans=call_record(10.0, [8.0]))], [run()]])
    assert host_busy_ms_per_call.read(ctx) is None  # a run without spans
    # a program whose run records have no such field
    old = SimpleNamespace(units=7)
    assert host_busy_ms_per_call.read(window([[old]])) is None
    ctx = window([[run(spans=call_record(10.0, [8.0]))]], traced=False)
    assert host_busy_ms_per_call.read(ctx) is None


def ev(cat, name, ts, dur):
    return dict(cat=cat, name=name, ts=ts, dur=dur)


def stretch(events, lo=0, hi=100):
    device = [e for e in events if e["cat"] == "kernel"]
    return SimpleNamespace(
        trace=SimpleNamespace(lo=lo, hi=hi, device=device,
                              window_s=(hi - lo) * 1e-6),
        prof=SimpleNamespace(events=events, answers=[]))


def test_host_idle_splits_the_idle_time_at_the_wait_ranges():
    # busy 0-10 and 50-60; idle 10-50 and 60-100 (80 µs); the host waits
    # 30-55 (its range runs on over the busy interval 50-55): idle inside
    # it is 30-50, so 60 of the 80 idle µs lie outside every wait
    events = [ev("kernel", "k", 0, 10), ev("kernel", "k", 50, 10),
              ev("user_annotation", "conicip::wait", 30, 25),
              ev("gpu_user_annotation", "conicip::wait", 0, 100),
              ev("user_annotation", "conicip::call", 0, 100)]
    assert host_idle_share.read(stretch(events)) == pytest.approx(60.0)


def test_host_idle_counts_overlapping_waits_once_and_clips_to_the_stretch():
    events = [ev("kernel", "k", 0, 10),
              ev("user_annotation", "conicip::wait", 20, 20),
              ev("user_annotation", "conicip::wait", 30, 20),  # 20-50
              ev("user_annotation", "conicip::wait", 90, 50)]  # to 100
    # idle 10-100 = 90; inside waits 20-50 and 90-100 = 40
    assert host_idle_share.read(stretch(events)) == pytest.approx(50.0)


def test_host_idle_has_nothing_to_read_without_wait_ranges():
    events = [ev("kernel", "k", 0, 10),
              ev("user_annotation", "conicip::loop", 0, 100)]
    assert host_idle_share.read(stretch(events)) is None
    ctx = stretch(events)
    ctx.trace = None
    assert host_idle_share.read(ctx) is None


def phases(kkt, step, evaluate):
    return {"kkt_build": kkt, "step": step, "evaluate": evaluate}


def test_phase_readers_divide_the_stretch_phases_by_its_units():
    ctx = SimpleNamespace(prof=SimpleNamespace(answers=[
        Answer(None, None, None, [], [], [
            run(units=6, phases=phases(6e6, 3e6, 9e6))]),
        Answer(None, None, None, [], [], [
            run(units=7, phases=phases(7e6, 10e6, 4e6)),
            run(units=7, phases=phases(0, 0, 0))]),
    ]))
    assert kkt_build_ms_per_iter.read(ctx) == pytest.approx(13 / 20)
    assert step_ms_per_iter.read(ctx) == pytest.approx(13 / 20)
    assert evaluate_ms_per_iter.read(ctx) == pytest.approx(13 / 20)


@pytest.mark.parametrize("reader", [kkt_build_ms_per_iter, step_ms_per_iter,
                                    evaluate_ms_per_iter])
def test_phase_readers_have_nothing_to_read_without_a_clock(reader):
    clocked = run(units=6, phases=phases(1, 1, 1))
    eager = run(units=0, phases=None)
    for runs in ([clocked, eager], [SimpleNamespace(units=6)], [],
                 [run(units=0, phases=phases(1, 1, 1))]):
        ctx = SimpleNamespace(prof=SimpleNamespace(answers=[
            Answer(None, None, None, [], [], runs)]))
        assert reader.read(ctx) is None
    assert reader.read(SimpleNamespace(prof=None)) is None
