"""Spans of a call and phase clocks of the device loop.

One span API for the whole package. A call of an entry (``conic_ip``,
``solve_batch``) opens a root span, :data:`CALL`; every layer boundary
below it opens a child span, by name:

.. code-block:: text

    conicip::call       (root: from entry to return)
    ├─ conicip::prepare  (densify, ConeSpec, backend and tier choice:
    │                     everything before the first run's loop)
    ├─ conicip::loop     (per run: solver/graph.py's device loop)
    │  ├─ conicip::copy_in    (the data into the entry's buffers)
    │  └─ conicip::replay     (the prologue's and the loop's graph launches)
    ├─ conicip::wait     (per run: the first read after the replays; the
    │                     host is blocked on the card)
    └─ conicip::finish   (Solution.from_state or the statuses, the run
                          record)

A miss adds ``conicip::warmup``, ``conicip::probe``, ``conicip::capture``
and ``conicip::unit0`` inside the loop; the eager loop's every host read
is a ``conicip::wait``. Each span records its name, its parent's name, its
start and end from ``time.perf_counter_ns()`` and the id of its call;
a call's spans form one :class:`Record`, which every run record of the
call (``solver.runs``, ``parallel.batch.runs``) points to. Spans are always
recorded (a few clock reads a span). Only while a ``torch.profiler``
session is active does a span also open a ``record_function`` range of
its name, so that a profile shows the spans on the device trace's clock.

Telemetry is *on* while a profiler session is active or after
:func:`enable`. While it is on, or for the calls inside
``watch(replays=True)``, solver/graph.py records CUDA events around each
graph replay (:meth:`Record.replay_ms`). An entry captured while it is on
carries a phase clock (:class:`DeviceClock`): one-thread stamp kernels
(``csrc/graph_cond.cu``) at the unit's phase boundaries, each adding the
device time since the previous stamp to its phase's slot:

- ``kkt_build``: the KKT assembly and factor (``solve3x3gen``; in the
  prologue the set-up up to the initial point's factor),
- ``step``: ``take_step``, the back-solves, refinement trips and step
  lengths (in the prologue the initial point's solve),
- ``evaluate``: the scaling, products, residuals and status of the new
  iterate, and the loop's carry copy and predicate.

The run record reports them as device ns per phase (``Run.phases``).
The graph cache keys its entries by whether telemetry is on; under a
profiler alone (no :func:`enable`) a call takes the entry captured with
telemetry off where there is one, so that profiling a program replays the
graphs it runs unprofiled and captures nothing anew. On
the CPU, ``ipm.run_chunks`` times the same phases with the host clock
(:class:`HostClock`). This module imports nothing from ``solver/``.
"""

from __future__ import annotations

import contextlib
import ctypes
import functools
import itertools
import threading
import time
from typing import Optional

import torch
from torch.profiler import record_function

from .ops.build import load_library

__all__ = ["CALL", "PREPARE", "LOOP", "COPY_IN", "REPLAY", "WAIT", "FINISH",
           "PHASES", "KKT_BUILD", "STEP", "EVALUATE", "Span", "Record",
           "span", "call", "entry", "current", "watch", "enable",
           "disable", "enabled", "on", "replay_timer", "phase", "mark",
           "reset", "clocked", "HostClock", "DeviceClock"]

CALL, PREPARE = "conicip::call", "conicip::prepare"
LOOP, COPY_IN, REPLAY = "conicip::loop", "conicip::copy_in", "conicip::replay"
WAIT, FINISH = "conicip::wait", "conicip::finish"

# the unit's phases, in the order a unit runs them; a phase clock's slots
PHASES = ("kkt_build", "step", "evaluate")
KKT_BUILD, STEP, EVALUATE = range(len(PHASES))
# the stamp kernel's other modes (csrc/graph_cond.cu): zero the phases and
# start the clock; start the clock, counting nothing since the last stamp
_RESET, _MARK = -1, -2

_ids = itertools.count(1)
_enabled = False


class _State(threading.local):
    """Per thread: the open call's record, its open spans (innermost
    last), a prepare span that the next span closes, the phase clock
    stamps go to, the lists that collect finished calls, and how many of
    them ask for replay events."""

    def __init__(self):
        self.record = None
        self.stack = []
        self.pending = None
        self.clock = None
        self.watchers = []
        self.timed = 0


_state = _State()


class Span:
    """One span: name, parent's name (None for a root), the call's id, and
    start and end in ns of ``time.perf_counter_ns()``."""

    __slots__ = ("name", "parent", "call", "start_ns", "end_ns")

    def __init__(self, name, parent, call_id, start_ns):
        self.name, self.parent, self.call = name, parent, call_id
        self.start_ns, self.end_ns = start_ns, None

    @property
    def ns(self) -> int:
        return self.end_ns - self.start_ns

    def __repr__(self):
        return (f"Span({self.name!r}, parent={self.parent!r}, "
                f"call={self.call}, ns={self.end_ns and self.ns})")


class Record:
    """The spans of one call, in the order they opened (the root first),
    and the CUDA events around its graph replays (:class:`replay_timer`)."""

    __slots__ = ("id", "spans", "replays")

    def __init__(self, call_id):
        self.id = call_id
        self.spans = []
        self.replays = []

    def named(self, name) -> list:
        return [s for s in self.spans if s.name == name]

    @property
    def root(self) -> Span:
        return self.spans[0]

    def replay_ms(self) -> float:
        """The device ms of the call's graph replays, from their CUDA
        events (waits for the last of them)."""
        if self.replays:
            self.replays[-1][1].synchronize()
        return sum(a.elapsed_time(b) for a, b in self.replays)


def _range(name):
    """A profiler range ``name``, opened only while a profiler session is
    active."""
    if not torch.autograd._profiler_enabled():
        return None
    r = record_function(name)
    r.__enter__()
    return r


def _close(st, s, rng, end_ns=None) -> None:
    s.end_ns = time.perf_counter_ns() if end_ns is None else end_ns
    st.stack.remove(s)
    if rng is not None:
        rng.__exit__(None, None, None)


def _close_pending(st, end_ns=None) -> None:
    if st.pending is not None:
        s, rng = st.pending
        st.pending = None
        _close(st, s, rng, end_ns)


def _open(st, name, start_ns=None):
    """A span ``name`` in the open call, the child of the innermost open
    span; None outside a call."""
    rec = st.record
    if rec is None:
        return None
    parent = st.stack[-1].name if st.stack else None
    s = Span(name, parent, rec.id,
             time.perf_counter_ns() if start_ns is None else start_ns)
    rec.spans.append(s)
    st.stack.append(s)
    return s


class span:
    """``with span(name):`` records a span of the open call (nothing
    outside a call) and, under a profiler, a range of the same name. A
    prepare span still open (:func:`entry`) ends where this one starts."""

    __slots__ = ("_name", "_span", "_range")

    def __init__(self, name):
        self._name = name

    def __enter__(self):
        st = _state
        _close_pending(st)
        self._range = _range(self._name)
        self._span = _open(st, self._name)
        return self

    def __exit__(self, *exc):
        if self._span is not None:
            _close(_state, self._span, None)
        if self._range is not None:
            self._range.__exit__(*exc)


class call(span):
    """The root span of a call of an entry: opens the call's
    :class:`Record` and hands it, finished, to every :func:`watch` list. A
    call made inside another call is a child span of it."""

    __slots__ = ("_root",)

    def __init__(self):
        super().__init__(CALL)

    def __enter__(self):
        # the clock first and last: the span covers the entry's own work
        start = time.perf_counter_ns()
        st = _state
        self._root = st.record is None
        if self._root:
            st.record, st.stack, st.pending = Record(next(_ids)), [], None
        _close_pending(st, start)
        self._range = _range(self._name)
        self._span = _open(st, self._name, start)
        return self

    def __exit__(self, *exc):
        end = time.perf_counter_ns()
        st = _state
        _close_pending(st, end)
        if self._span is not None:
            _close(st, self._span, None, end)
        if self._range is not None:
            self._range.__exit__(*exc)
        if self._root:
            rec, st.record = st.record, None
            for out in st.watchers:
                out.append(rec)


def entry(fn):
    """Decorate an entry: each call of it is a :func:`call`, its start a
    prepare span (:data:`PREPARE`)."""

    @functools.wraps(fn)
    def wrapped(*args, **kwargs):
        with call():
            _begin(PREPARE)
            return fn(*args, **kwargs)

    return wrapped


def _begin(name) -> None:
    """Open a span ``name`` that ends where the next span starts (or its
    parent ends): the prepare span, whose end lies deep in the solver."""
    st = _state
    _close_pending(st)
    rng = _range(name)
    s = _open(st, name)
    if s is None:
        if rng is not None:
            rng.__exit__(None, None, None)
        return
    st.pending = (s, rng)


def current() -> Optional[Record]:
    """The open call's record, or None outside a call."""
    return _state.record


@contextlib.contextmanager
def watch(replays=False):
    """``with watch() as calls:`` collects the record of every call that
    ends inside, in order; with ``replays``, each with the CUDA events
    around its graph replays (:meth:`Record.replay_ms`), telemetry on or
    off."""
    out, st = [], _state
    st.watchers.append(out)
    st.timed += bool(replays)
    try:
        yield out
    finally:
        st.timed -= bool(replays)
        st.watchers.remove(out)


def enable() -> None:
    """Turn telemetry on without a profiler (module docstring)."""
    global _enabled
    _enabled = True


def disable() -> None:
    global _enabled
    _enabled = False


def enabled() -> bool:
    """Whether :func:`enable` holds telemetry on, profiler or not."""
    return _enabled


def on() -> bool:
    """Whether telemetry is on: after :func:`enable`, or while a profiler
    session is active."""
    return _enabled or torch.autograd._profiler_enabled()


class replay_timer:
    """``with replay_timer():`` around a CUDA graph replay: in a call,
    while telemetry is on or a ``watch(replays=True)`` is open, CUDA
    events before and after it on the current stream, kept in the call's
    record and resolved only when read."""

    __slots__ = ("_record", "_start")

    def __enter__(self):
        st = _state
        self._record = st.record
        if self._record is not None and (st.timed or on()):
            self._start = torch.cuda.Event(enable_timing=True)
            self._start.record()
        else:
            self._record = None
        return self

    def __exit__(self, *exc):
        if self._record is not None:
            end = torch.cuda.Event(enable_timing=True)
            end.record()
            self._record.replays.append((self._start, end))


# ── phase clocks ──

def phase(index) -> None:
    """The end of phase ``index`` (:data:`PHASES`): the installed clock
    adds the time since its previous stamp to the phase."""
    clock = _state.clock
    if clock is not None:
        clock.stamp(index)


def mark() -> None:
    """Start the installed clock again here: the time since its previous
    stamp counts to no phase."""
    clock = _state.clock
    if clock is not None:
        clock.mark()


def reset() -> None:
    """Zero the installed clock's phases and start it."""
    clock = _state.clock
    if clock is not None:
        clock.reset()


@contextlib.contextmanager
def clocked(clock):
    """Install ``clock`` (None: no clock) for :func:`phase`, :func:`mark`
    and :func:`reset` inside."""
    st = _state
    before, st.clock = st.clock, clock
    try:
        yield clock
    finally:
        st.clock = before


class HostClock:
    """The phases on the host's clock (the CPU's device loop)."""

    def __init__(self):
        self.ns = [0] * len(PHASES)
        self.last = time.perf_counter_ns()

    def stamp(self, index) -> None:
        now = time.perf_counter_ns()
        self.ns[index] += now - self.last
        self.last = now

    def mark(self) -> None:
        self.last = time.perf_counter_ns()

    def reset(self) -> None:
        self.ns = [0] * len(PHASES)
        self.mark()

    def read(self) -> dict:
        return dict(zip(PHASES, self.ns))


@functools.lru_cache(maxsize=None)
def _clock_library():
    lib = load_library("graph_cond")
    lib.conicip_stamp.argtypes = [ctypes.c_void_p, ctypes.c_void_p,
                                  ctypes.c_int, ctypes.c_int]
    lib.conicip_stamp.restype = ctypes.c_int
    return lib


class DeviceClock:
    """The phases on the card's ``%globaltimer``: an int64 buffer on the
    device, one slot per phase and the time of the last stamp, made
    before any capture; each stamp is one launch of a one-thread kernel
    on the current stream, captured into a graph like any other."""

    def __init__(self, device):
        self.buf = torch.zeros(len(PHASES) + 1, dtype=torch.int64,
                               device=device)
        self._lib = _clock_library()

    def _launch(self, slot) -> None:
        stream = torch.cuda.current_stream(self.buf.device).cuda_stream
        err = self._lib.conicip_stamp(stream, self.buf.data_ptr(), slot,
                                      len(PHASES))
        if err != 0:
            raise RuntimeError(f"phase clock stamp: CUDA error {err}")

    def stamp(self, index) -> None:
        self._launch(index)

    def mark(self) -> None:
        self._launch(_MARK)

    def reset(self) -> None:
        self._launch(_RESET)

    def slots(self) -> list:
        """The phases' slots, device int64 scalars, for the solve's one
        final copy."""
        return [self.buf[i] for i in range(len(PHASES))]

