"""The device loop, kept across calls: on CUDA as captured CUDA graphs.

Counterpart of ``_solve_jit`` and ``_solve_warm_jit``
(``conicip_tpu/solver/__init__.py``), which compile the whole solve once
per configuration, read nothing back until it ends, and keep the program
for the next call. :func:`solve` runs
:func:`~conicip_tpu_torch.solver.ipm.ipm_solve` with the device loop
through a cache of at most :data:`CACHE_SIZE` entries, least recently used
first out. Its key is what the captured work reads besides the data: the
device, the dtype, every operand's shape and strides, the ``ConeSpec``,
the KKT generator (one object per configuration: a ``kktsolver_schur_tp``
made once and reused hits, one made per call misses, as a new closure
recompiles ``jit`` in the reference), the ``IPMOptions``, whether
telemetry is on (``telemetry.on()``; under a profiler alone a call takes
the entry captured with telemetry off where there is one, :func:`_lookup`),
a cold or a warm start, and ``ipm.POLL``. An entry owns

- input buffers for Q, c, A, b, G, d and the warm start, into which each
  call copies its data: each operand in the caller's layout, which the
  reductions round by, so that the loop's arithmetic is the eager loop's
  bit for bit on the caller's tensors; an operand expanded over a stack
  (stride 0: a G or d shared by every instance) is kept once;
- on CUDA, two graphs captured in the entry's own ``torch.cuda.MemPool``:
  the *prologue* (``ipm.device_prologue``: the level-1 callback, whose
  tensors are derived from the input buffers, the initial point and its
  evaluation) and the *loop*: one conditional WHILE node
  (``csrc/graph_cond.cu``) whose body is a *chunk* of ``ipm.POLL`` units
  (step, then evaluate), then the loop's predicate (``ipm``'s ``more``:
  some instance still active, the units run at most ``maxIters``), which
  decides on the device whether the body runs again, as the reference's
  ``lax.while_loop`` decides its own; both write one buffer per carried
  tensor, and the units run, a device counter; and the launch counts of
  each capture; with telemetry on, the phase clock
  (``telemetry.DeviceClock``): its buffer, and a stamp at each phase
  boundary of the prologue and of each unit in both graphs. An entry
  captured with telemetry off is the same graph without them.

A call that misses builds its entry on the solve's stream: the prologue
runs eagerly (it builds the kernels and warms cuBLAS) and is captured, its
graph is replayed, the first unit runs eagerly and the loop is captured
while the card runs it, and then the loop's graph is replayed once. With a caller's own kktsolver (``control.callers_own``) a miss
runs the prologue and one unit eagerly once more after the warm-up,
every body masked (``ipm.masked``: the variant not reached and the
refinement trips too, and no predicate read inside a caller's
``control.cond``), calling the caller's callbacks under
``control.guarded``, before anything is captured and before an older
entry is evicted: a callback that reads the device (``.item()``,
``torch.linalg.cholesky``'s host check of ``info``, a pageable
host-to-device copy) raises ``control.ReadsDevice``, the entry is
dropped, and ``ipm_solve`` runs the eager loop from the initial point
(``Run.loop`` "eager", ``Run.reason`` naming the read; the callable is
remembered, so a later call decides before the solve). The one choice of
loop made during a call, and not a fallback that hides the device: that
run stays on the card. A caller's callable costs a miss that extra
prologue and unit. A call that hits
copies its data into the buffers and replays the prologue and the loop:
no eager work, no capture, no instantiation, and one host read, the
final copy of the loop's counts. Both return copies of the results, so a later call never
changes an earlier solution. On the CPU an entry holds the buffers and the
loop runs eagerly (``ipm.run_chunks``).

Stacks come here too: ``solve_batch`` sends its runs, whatever their
generator, through :func:`solve` (parallel/batch.py), as the reference
keeps one ``jit(vmap(ipm_solve))`` per configuration and stack shape. The
stack's shape is part of the key, and a shared G (expanded with stride 0) is a
configuration apart from a stacked one. What an entry holds on an H100
for the stacks of 64 of ``chip_smoke.py`` ``[batch_graph]`` (reserved
memory across a miss after :func:`clear`): ``batched_box_qp`` n=500
1.7 GB, ``batched_mixed_rq_eq`` n=200 0.23 GB, ``batched_mixed_rqs`` and
``batched_small_sdp`` under 0.07 GB.

What the reference decides by ``lax.cond`` inside its loop is, in a
captured unit, the body of a conditional IF node (``csrc/graph_cond.cu``)
nested in the WHILE node's body, that runs only while its predicate holds
on the device: each refinement
trip, run while some instance goes on, as the reference's ``while_loop``
and the eager loop stop; the mixed-residual recompute, run when it fires
(the reference's ``cond_once``); and, with a two-variant generator, each
variant's step (and, where the variants' S-cone decompositions differ,
its scaling), run while some instance is on it; and what a KKT generator
decides by ``control.cond`` (``kktsolver_schur_tp``'s ridge retry, its
NCCL collectives captured inside the body), in the prologue and in a
unit, run where its first factor failed. The trips and a retry nest
inside a variant's step, and the unit inside the WHILE node's body: each
level of nesting (:data:`NESTING`) is captured on a stream of its own,
and every body's allocations go to a second pool of the entry. Every capture, and every body, runs in ``thread_local`` mode
(:data:`CAPTURE_MODE`). The
first unit of a miss runs eagerly, each body only where its predicate
holds, as the eager loop runs it. A read inside a capture fails it, and a
capture, replay or conditional-node error raises: nothing runs the loop
eagerly in its place: what the guard does not catch (a read in a branch
the warm-up did not run, a conditional body of a variant not yet
reached) is refused by the capture, whose error is raised. With verbose
output (``IPMOptions.verbose``, part of the key) the entry keeps no WHILE
node: the reference prints each row from a ``jax.debug.callback`` inside
its loop, and a conditional body can hold no host node, so the chunk is
captured alone and replayed by the host. The captured prologue and chunk
write each unit's printed row beside the flag, and the host reads both
in one copy after each replay and prints the rows (``ipm.poll``), as the
eager first unit of a miss prints its own: the eager loop's text, row
for row, printed while the solve runs. An entry without verbose output
captures no row. An evicted entry, and every entry on :func:`clear`,
returns its pools' memory to CUDA.

The kernels' wrappers count a launch where they issue it. Under capture
the card runs nothing, so each capture's counts are taken back and added
once per replay: the counters say what the card ran. A conditional body
that launches a counted kernel (the WHILE node's chunk, a variant's
factors and decompositions, a refinement trip's R-cone kernels) also
counts its runs on the device,
in one of the entry's slots (:func:`counted_bodies`); the host reads
those counts with the loop's own, in the solve's one final copy, and
adds the body's captured launches once per run.
"""

from __future__ import annotations

import contextlib
import ctypes
import functools
from collections import Counter, OrderedDict
from dataclasses import fields, is_dataclass

import torch

from .. import telemetry
from ..ops import cholesky_kernel, control, jacobi_kernel, rcone_kernel
from ..ops.build import load_library
from . import ipm
from .state import SolState

__all__ = ["solve", "clear", "cache_info", "CACHE_SIZE", "LOOP", "REPLAY",
           "while_launches"]

# spans (telemetry; python -m conicip_tpu_torch.trace reads their profiler
# ranges): the whole loop, and its replays, in which the host issues no
# kernel
LOOP, REPLAY = telemetry.LOOP, telemetry.REPLAY

# Levels of conditional nodes: the loop's WHILE node, a variant's step
# inside its body, and the refinement trips inside the step.
NESTING = 3


def counted_bodies(opts) -> int:
    """Conditional bodies of a unit, or of the prologue, that launch
    counted kernels, at most: each variant's scaling and step, and inside
    each step the distributed factor's ridge retry (control.cond) and the
    refinement trips (the R cones' kernels, ops/rcone.py); and the loop's
    WHILE body, whose launches outside those count per run too."""
    return 2 * (3 + opts.maxRefinementSteps) + 1


# Launches of the loop's WHILE node (csrc/graph_cond.cu), by dtype of the
# solve: one per replay of a loop graph, each running the node's body
# while the solve goes on.
while_launches: Counter = Counter()


# Entries kept, least recently used first out. The reference's jit cache is
# unbounded; an entry's pool holds the loop's device memory (about 3.2 GB
# for an n=4096 Schur solve on the H100, 1.7 GB for a stack of 64 box QPs
# at n=500; PERF.md §6), so the port bounds it.
CACHE_SIZE = 4

_cache: OrderedDict = OrderedDict()
# Entries whose capture failed. A failed capture can leave PyTorch's
# allocator routing to the entry's pools, and freeing such a pool aborts
# the process; they are kept, so that the capture's own error is raised.
_stranded: list = []


def _counters():
    return (cholesky_kernel.cholesky_launches,
            cholesky_kernel.predicated_launches,
            jacobi_kernel.jacobi_launches,
            rcone_kernel.rcone_launches,
            cholesky_kernel.inverse_launches)


def _leaves(x) -> list:
    """The tensors of a carry (records and tuples of tensors, None where a
    configuration carries nothing), in order."""
    if x is None:
        return []
    if isinstance(x, torch.Tensor):
        return [x]
    if is_dataclass(x):
        return [t for f in fields(x) for t in _leaves(getattr(x, f.name))]
    if isinstance(x, tuple):
        return [t for v in x for t in _leaves(v)]
    raise TypeError(f"not a carry leaf: {type(x).__name__}")


def _rebuild(like, leaves):
    """``like`` with its tensors replaced, in order, from ``leaves``."""
    if like is None:
        return None
    if isinstance(like, torch.Tensor):
        return next(leaves)
    if is_dataclass(like):
        return type(like)(**{f.name: _rebuild(getattr(like, f.name), leaves)
                             for f in fields(like)})
    vals = [_rebuild(v, leaves) for v in like]
    return type(like)(*vals) if hasattr(like, "_fields") else tuple(vals)


def _copy(dst, src) -> None:
    for a, b in zip(_leaves(dst), _leaves(src)):
        a.copy_(b)


def _clone(x):
    return _rebuild(x, iter([t.clone() for t in _leaves(x)]))


def _shared(t) -> tuple:
    """The dimensions along which ``t`` repeats one slice (stride 0: a
    shared G or d expanded over a stack)."""
    if not t.numel():
        return ()
    return tuple(i for i, (n, s) in enumerate(zip(t.shape, t.stride()))
                 if s == 0 and n > 1)


def _base(t):
    """The one slice of ``t`` that its shared dimensions repeat."""
    for i in _shared(t):
        t = t.narrow(i, 0, 1)
    return t


def _key(args, spec, kktsolver, opts, warm) -> tuple:
    c = args[1]
    return (c.device.type, c.device.index, c.dtype,
            tuple((tuple(x.shape), x.stride()) for x in args), spec,
            kktsolver, opts, telemetry.on(), warm is None, ipm.POLL)


def _telemetry(key) -> bool:
    """Whether telemetry was on for the key's entry: its graphs then carry
    the phase clock's stamps."""
    return key[-3]


def _lookup(key):
    """The key a call uses and its entry, None on a miss. Under a profiler
    alone (telemetry on, not :func:`telemetry.enable`), an entry captured
    with telemetry off serves where there is one: a profile of a program
    then replays the graphs the program runs unprofiled, and captures
    nothing anew."""
    if _telemetry(key) and not telemetry.enabled():
        off = key[:-3] + (False,) + key[-2:]
        if off in _cache:
            return off, _cache[off]
    return key, _cache.get(key)


def cache_info() -> list:
    """The keys of the entries kept, least recently used first."""
    return list(_cache)


def clear() -> None:
    """Release every entry: its graphs, buffers and memory pool."""
    while _cache:
        _cache.popitem(last=False)[1].release()


class _Entry:
    """One configuration's buffers and, on CUDA, graphs (module
    docstring)."""

    def __init__(self, key, prologue, inputs, slots):
        self.key = key
        self.prologue = prologue
        self.slots = slots  # counted bodies a unit may have (counted_bodies)
        # the inputs' buffers: the call's tensors, copied in their layout
        # (the reductions round by it), a shared slice once
        *args, warm = inputs
        self.inputs = tuple(_base(x).clone().expand(x.shape)
                            for x in args) + (
            None if warm is None else _clone(warm),)
        # on CUDA (prologue, loop): the loop the WHILE node's graph, or
        # with verbose output the chunk the host replays
        self.graphs = ()
        self.deltas = ()  # their captures' launch counts
        # the conditional bodies that launch counted kernels: each [its
        # runs so far (a device int64, a slot of `runs`), its capture's
        # launch counts, the runs the counters hold]
        self.bodies = []
        self.runs = None
        # the units the loop ran, a device int64 the captured loop adds to
        self.units = None
        # with telemetry on at the capture, the phase clock its stamps
        # write (telemetry.DeviceClock)
        self.clock = None
        self.static = self.flag = self.body = None
        # the graphs' memory pools: the captures', and that of the
        # conditional nodes' bodies, which a capture's pool cannot take
        self.pool = self.body_pool = None

    def refresh(self, inputs) -> None:
        *args, warm = inputs
        for dst, src in zip(self.inputs, args):
            _base(dst).copy_(_base(src))
        if warm is not None:
            _copy(self.inputs[-1], warm)

    def release(self) -> None:
        if self.pool is not None:
            torch.cuda.synchronize(self.inputs[1].device)
            for g in self.graphs:
                g.reset()
        self.graphs = self.deltas = ()
        self.bodies = []
        self.static = self.flag = self.body = self.inputs = self.runs = None
        self.units = self.clock = None
        if self.pool is not None:
            # the pools' segments are freed with them
            self.pool = self.body_pool = None
            torch.cuda.empty_cache()


def _make_room() -> None:
    """Evict the least recently used entries until one more fits."""
    while len(_cache) >= CACHE_SIZE:
        _cache.popitem(last=False)[1].release()


def _counts(entry, cy) -> dict:
    """The loop's counts, the units it ran (on CUDA), the device ns of each
    phase (with a phase clock: ``phases``) and the runs of the entry's
    counted bodies, in one copy: the bodies' launches are added to the
    counters once per run since the last read."""
    units = [] if entry.units is None else [entry.units]
    phases = [] if entry.clock is None else entry.clock.slots()
    counts, runs = ipm.loop_counts(cy, *units, *phases,
                                   *(b[0] for b in entry.bodies))
    if units:
        counts["units"] = runs.pop(0)
    if phases:
        counts["phases"] = dict(zip(telemetry.PHASES, runs[:len(phases)]))
        del runs[:len(phases)]
    for body, total in zip(entry.bodies, runs):
        ran, body[2] = total - body[2], total
        for c, delta in zip(_counters(), body[1]):
            for k, v in delta.items():
                c[k] += v * ran
    return counts


def _drive(key, prologue, inputs, slots, probe=None):
    """``ipm_solve``'s device loop through the cache (module docstring);
    ``slots`` the counted bodies a unit may have, ``probe`` the prologue on
    a caller's kktsolver under the guard, which a miss on CUDA runs
    first."""
    key, entry = _lookup(key)
    hit = entry is not None
    with telemetry.span(LOOP):
        with telemetry.span(telemetry.COPY_IN):
            if hit:
                _cache.move_to_end(key)
                entry.refresh(inputs)
            else:
                if inputs[1].device.type != "cuda":
                    # on CUDA, _build makes room after its probe
                    _make_room()
                entry = _Entry(key, prologue, inputs, slots)
        if inputs[1].device.type != "cuda":
            cy, info = ipm.run_chunks(entry.prologue, entry.inputs)
        elif hit:
            cy, info = _replay(entry)
        else:
            try:
                cy, info = _build(entry, probe)
            except control.ReadsDevice:
                # raised before any capture: the entry is dropped
                entry.release()
                raise
            except BaseException:
                _stranded.append(entry)
                raise
        # what the caller keeps, copied out of the entry's buffers: the
        # next call overwrites them
        out = cy._replace(sol=_clone(cy.sol))
    # outside the loop's span, as the eager loop's final read
    with telemetry.span(telemetry.WAIT):
        info.update(_counts(entry, cy))
    if not hit and (entry.graphs or inputs[1].device.type != "cuda"):
        _cache[key] = entry
    return out, dict(info, cache_hit=hit)


# The capture mode of every graph and conditional body: "thread_local".
# A capture in "global" mode fails when another thread makes a call that
# is unsafe during a capture, and ProcessGroupNCCL's watchdog thread
# queries CUDA events while a kktsolver_schur_tp entry is captured;
# PyTorch's CUDA-graph notes advise this mode when other threads make CUDA
# calls. The capturing thread is held to the same rules in both modes.
CAPTURE_MODE = "thread_local"
# cudaStreamCaptureModeThreadLocal, the same mode for the conditional bodies
_CAPTURE_MODE_ENUM = 1


def _capture(entry, fn):
    """Capture ``fn()`` into a new graph in the entry's pool; returns the
    graph and the launch counts the capture made, taken back from the
    counters."""
    counters = _counters()
    before = [Counter(c) for c in counters]
    graph = torch.cuda.CUDAGraph()
    with telemetry.span("conicip::capture"):
        graph.capture_begin(pool=entry.pool.id,
                            capture_error_mode=CAPTURE_MODE)
        try:
            fn()
        except BaseException:
            # end the capture so that the stream is usable again; the
            # error raised is the capture's own
            with contextlib.suppress(RuntimeError):
                graph.capture_end()
            raise
        graph.capture_end()
    deltas = []
    for c, b in zip(counters, before):
        deltas.append(c - b)
        c.clear()
        c.update(b)
    return graph, deltas


def _play(graph, deltas) -> None:
    with telemetry.replay_timer():
        graph.replay()
    for c, delta in zip(_counters(), deltas):
        c.update(delta)


def _build(entry, probe=None):
    """A miss on CUDA. The prologue runs eagerly, to build the kernels and
    warm cuBLAS and the caches a capture cannot fill (a generator's
    ``control.cond`` bodies after a host read), and is captured while the
    card runs it; its graph is then replayed as on a hit, since the loop
    reads the tensors that graph writes (so a miss does the prologue's
    device work twice). The first unit runs eagerly on them (a warm-up
    like the prologue's, run and counted in ``units`` whether or not the
    solve goes on: where the prologue ended it, a frozen unit that
    changes nothing and builds the KKT system once more), the loop
    is captured while the card runs it, and replayed: the WHILE node
    whose body is the chunk, which runs it until the predicate is false
    on the device; with verbose output the chunk, replayed while the flag
    the host reads after it holds. With ``probe`` (a caller's kktsolver
    under ``control.guarded``) the probe's prologue and one unit run
    eagerly after the warm-up and before any capture: a callback that reads the device raises
    ``control.ReadsDevice`` there. After the warm-up, so that what the
    package makes once per configuration (``ipm._identity``, the cones'
    index tensors, copies of host data) is made outside the guard; with
    every body run (``ipm.masked``), so that the package reads no
    predicate inside a guarded call (a caller's ``control.cond``) and the
    bodies the warm-up skipped (the other variant, refinement trips) are
    probed too. Room in the cache is made after the probe, so that a
    callable that reads the device evicts no entry."""
    inputs = entry.inputs
    device = inputs[1].device
    with telemetry.span("conicip::warmup"):
        # the carry only: the warm-up's loop functions, which hold its
        # operators, are not kept
        cy = entry.prologue(*inputs, branch=ipm.on_host)[1]
    if probe is not None:
        with telemetry.span("conicip::probe"):
            body, first = probe(*inputs, branch=ipm.masked)
            body.unit(first, ipm.masked)
    _make_room()
    entry.static = _clone(cy)
    verbose = cy.row is not None
    # the loop's predicate; with verbose output (a carry with a row) the
    # flag and the rows of a chunk's units (ipm.polled), which the host
    # polls
    entry.flag = (torch.zeros(1 + ipm.POLL * ipm.ROW, dtype=torch.float64,
                              device=device) if verbose else
                  torch.empty((), dtype=torch.bool, device=device))
    entry.pool = torch.cuda.MemPool()
    entry.body_pool = torch.cuda.MemPool()
    # the counted bodies' runs, made before any capture: a counter
    # allocated inside a captured body and zeroed after the capture counted
    # nothing on the H100
    entry.runs = torch.zeros(entry.slots * (1 + ipm.POLL),
                             dtype=torch.int64, device=device)
    entry.units = torch.zeros((), dtype=torch.int64, device=device)
    if _telemetry(entry.key):
        entry.clock = telemetry.DeviceClock(device)
    branch, loop = _conditional(entry, device)

    def prologue():
        telemetry.reset()
        entry.body, out = entry.prologue(*inputs, branch=branch)
        _copy(entry.static, out)
        entry.units.zero_()
        if verbose:
            _set_flag(entry, [entry.static.row])
        telemetry.phase(telemetry.EVALUATE)

    with telemetry.clocked(entry.clock):
        gp, dp = _capture(entry, prologue)
    with telemetry.span(REPLAY):
        _play(gp, dp)
    if verbose and not _read(entry):
        # ended at its first iterate: nothing to keep
        cy = entry.static
        gp.reset()
        entry.release()
        return cy, dict(polls=1, replays=0, units=0, loop="graph")
    with telemetry.span("conicip::unit0"), telemetry.clocked(entry.clock):
        telemetry.mark()
        cy, rows = entry.static, []
        for i in range(ipm.POLL):
            if i:
                telemetry.phase(telemetry.EVALUATE)
            cy = entry.body.unit(cy, ipm.on_host)
            rows.append(cy.row)
        entry.units.add_(ipm.POLL)
        telemetry.phase(telemetry.EVALUATE)

    def chunk():
        # the phase clock: each unit stamps its KKT build and its step,
        # and the chunk the evaluations, the last after the carry's copy
        # and the predicate
        out, rows = entry.static, []
        for i in range(ipm.POLL):
            if i:
                telemetry.phase(telemetry.EVALUATE)
            out = entry.body.unit(out, branch)
            rows.append(out.row)
        _copy(entry.static, out)
        entry.units.add_(ipm.POLL)
        _set_flag(entry, rows)
        telemetry.phase(telemetry.EVALUATE)

    def verbose_chunk():
        telemetry.mark()
        chunk()

    def whole():
        telemetry.mark()
        _set_flag(entry, None)
        loop(entry.flag, chunk)

    with telemetry.clocked(entry.clock):
        gl, dl = _capture(entry, verbose_chunk if verbose else whole)
    entry.graphs, entry.deltas = (gp, gl), (dp, dl)
    _copy(entry.static, cy)
    if verbose:
        replays = (_chunks(entry)
                   if ipm.poll(entry.body.more(cy, ipm.POLL), rows) else 0)
        return entry.static, dict(polls=2 + replays, replays=replays,
                                  loop="graph")
    with telemetry.span(REPLAY):
        _run_loop(entry)
    return entry.static, dict(polls=1, replays=1, loop="graph")


def _set_flag(entry, rows) -> None:
    """Inside a capture: write the loop's predicate (ipm's ``more``: some
    instance still active, the units under the cap) into the flag, with
    verbose output beside the units' rows."""
    more = entry.body.more(entry.static, entry.units)
    if entry.flag.dtype == torch.bool:
        entry.flag.copy_(more)
    else:
        entry.flag.copy_(ipm.polled(more, rows, ipm.POLL))


def _read(entry) -> bool:
    """The host's poll of the flag, with verbose output (in the same copy,
    the rows it prints)."""
    with telemetry.span(telemetry.WAIT):
        return ipm.read_polled(entry.flag)


def _replay(entry):
    """A hit on CUDA: the prologue's replay, then the loop's: the WHILE
    node's graph once, with no read; with verbose output the chunk's
    while the flag read after each holds."""
    (gp, _), (dp, _) = entry.graphs, entry.deltas
    if entry.flag.dtype == torch.bool:
        with telemetry.span(REPLAY):
            _play(gp, dp)
            _run_loop(entry)
        return entry.static, dict(polls=1, replays=1, loop="graph")
    with telemetry.span(REPLAY):
        _play(gp, dp)
    replays = _chunks(entry) if _read(entry) else 0
    return entry.static, dict(polls=1 + replays, replays=replays,
                              loop="graph")


def _run_loop(entry) -> None:
    """One replay of the loop's graph: the WHILE node runs the chunk until
    the predicate it writes is false; the host issues the graph and reads
    nothing (the solve's one read is the final copy, :func:`_counts`)."""
    (_, gl), (_, dl) = entry.graphs, entry.deltas
    _play(gl, dl)
    while_launches[entry.inputs[1].dtype] += 1


def _chunks(entry) -> int:
    """With verbose output: replays of the chunk, one flag read after
    each, until it is false. Returns the replays, which are also the
    reads."""
    (_, gc), (_, dc) = entry.graphs, entry.deltas
    replays = 0
    while True:
        with telemetry.span(REPLAY):
            _play(gc, dc)
        replays += 1
        if not _read(entry):
            return replays


@functools.lru_cache(maxsize=None)
def _cond_library():
    lib = load_library("graph_cond")
    lib.conicip_if_begin.argtypes = [ctypes.c_void_p] * 3 + [ctypes.c_int]
    lib.conicip_if_begin.restype = ctypes.c_int
    lib.conicip_if_end.argtypes = [ctypes.c_void_p]
    lib.conicip_if_end.restype = ctypes.c_int
    lib.conicip_while_begin.argtypes = [ctypes.c_void_p] * 3 + [
        ctypes.c_int, ctypes.POINTER(ctypes.c_ulonglong)]
    lib.conicip_while_begin.restype = ctypes.c_int
    lib.conicip_while_end.argtypes = [ctypes.c_void_p, ctypes.c_ulonglong,
                                      ctypes.c_void_p]
    lib.conicip_while_end.restype = ctypes.c_int
    return lib


@functools.lru_cache(maxsize=None)
def _body_stream(device_index, depth):
    """The stream the conditional nodes' bodies at one depth of nesting
    are captured on, one per device and depth, its cuBLAS workspace made
    before any capture."""
    stream = torch.cuda.Stream(device_index)
    with torch.cuda.stream(stream):
        for dt in (torch.float64, torch.float32):
            x = torch.ones(2, 2, dtype=dt, device=stream.device)
            torch.mv(x, x[0])
            torch.mm(x, x)
    stream.synchronize()
    return stream


def _conditional(entry, device):
    """The captured loop's conditional nodes (module docstring), each
    captured on the stream of its depth: ``branch(pred, body)``, the
    unit's, each body an IF node on ``pred``; and ``loop(flag, body)``, a
    WHILE node that runs ``body`` while ``flag`` (a device bool, which
    ``body`` rewrites) holds. A body that launches counted kernels counts
    its runs in a slot of ``entry.runs`` (``entry.bodies``)."""
    lib = _cond_library()
    # made before the capture, which a new stream's warm-up would break
    streams = [_body_stream(device.index, d) for d in range(NESTING)]
    depth = 0

    def node(flag, body, repeat):
        nonlocal depth
        if depth == NESTING:
            raise RuntimeError(f"conditional nodes nested deeper than "
                               f"{NESTING}")
        stream = torch.cuda.current_stream(device)
        child = streams[depth]
        counters = _counters()
        before = [Counter(c) for c in counters]
        handle = ctypes.c_ulonglong(0)
        if repeat:
            err = lib.conicip_while_begin(
                stream.cuda_stream, child.cuda_stream, flag.data_ptr(),
                _CAPTURE_MODE_ENUM, ctypes.byref(handle))
        else:
            err = lib.conicip_if_begin(stream.cuda_stream, child.cuda_stream,
                                       flag.data_ptr(), _CAPTURE_MODE_ENUM)
        if err != 0:
            raise RuntimeError(f"conditional node: CUDA error {err}")

        def end():
            # a WHILE body's last node sets the handle from the flag the
            # body wrote
            if repeat:
                return lib.conicip_while_end(child.cuda_stream, handle,
                                             flag.data_ptr())
            return lib.conicip_if_end(child.cuda_stream)

        depth += 1
        try:
            # the outermost body routes this thread's allocations to the
            # bodies' pool, the nested ones with it
            with torch.cuda.stream(child), (
                    torch.cuda.use_mem_pool(entry.body_pool) if depth == 1
                    else contextlib.nullcontext()):
                out = body()
                deltas = [c - b for c, b in zip(counters, before)]
                if any(deltas):
                    if len(entry.bodies) == entry.runs.numel():
                        raise RuntimeError("more counted conditional bodies "
                                           "than the entry has slots for")
                    runs = entry.runs[len(entry.bodies)]
                    runs.add_(1)
                    entry.bodies.append([runs, deltas, 0])
        except BaseException:
            end()
            raise
        finally:
            depth -= 1
            # the body's launches count per run, not per capture
            for c, b in zip(counters, before):
                c.clear()
                c.update(b)
        err = end()
        if err != 0:
            raise RuntimeError(f"conditional node body: CUDA error {err}")
        return out

    def branch(pred, body):
        return node(pred.to(torch.bool), body, False)

    def loop(flag, body):
        node(flag, body, True)

    return branch, loop


@functools.lru_cache(maxsize=None)
def _stream(device_index):
    """The one stream the solves on a device run and capture on: cuBLAS
    keeps a workspace for every stream it runs on, which a new stream per
    solve would add up."""
    return torch.cuda.Stream(device_index)


def solve(Q, c, A, b, G, d, spec, kktsolver, opts, warm=None,
          stats=None) -> SolState:
    """``ipm_solve`` with the device loop through the cache (module
    docstring); the arguments are ``ipm_solve``'s. The returned state's
    tensors are the caller's own; on CUDA they may be used on the caller's
    stream at once. A caller's kktsolver that reads the device runs the
    eager loop (``stats["reason"]``)."""
    args = (Q, c, A, b, G, d)
    key = _key(args, spec, kktsolver, opts, warm)
    probe = None
    if c.device.type == "cuda" and control.callers_own(kktsolver):
        probe = ipm.device_prologue(spec, control.guarded(kktsolver), opts)

    def loop(prologue, inputs):
        return _drive(key, prologue, inputs, counted_bodies(opts), probe)

    if c.device.type != "cuda":
        return ipm.ipm_solve(*args, spec, kktsolver, opts, warm=warm,
                             stats=stats, device_loop=loop)
    dev = c.device
    caller = torch.cuda.current_stream(dev)
    stream = _stream(dev.index)
    stream.wait_stream(caller)
    with torch.cuda.device(dev), torch.cuda.stream(stream):
        st = ipm.ipm_solve(*args, spec, kktsolver, opts, warm=warm,
                           stats=stats, device_loop=loop)
    caller.wait_stream(stream)
    for t in _leaves(st):
        t.record_stream(caller)
    return st
