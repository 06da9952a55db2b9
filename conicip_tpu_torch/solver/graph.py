"""The device loop on CUDA, captured in a CUDA graph.

Counterpart of ``_solve_jit`` and ``_solve_warm_jit``
(``conicip_tpu/solver/__init__.py``), which compile the whole solve into
one program that reads nothing back until it ends. :func:`solve` runs
:func:`~conicip_tpu_torch.solver.ipm.ipm_solve` on a stream of its own
with :func:`drive` as its loop:

- the inputs are copied into buffers of the solve (a graph reads its
  tensors by address), and the structure checks, the level-1 KKT callback
  and the initial point run first, outside any graph, where they may read
  the device;
- the first chunk of :data:`~conicip_tpu_torch.solver.ipm.POLL` iterations
  runs eagerly on that stream: it builds the kernels and warms up cuBLAS,
  and its work is the solve's own;
- one chunk is captured in a ``torch.cuda.CUDAGraph`` (a private memory
  pool, released after the solve) while the card still runs the first;
  then, if an instance is still running, the graph is replayed, the host
  reading one flag per replay, until no instance runs or ``k > maxIters``.

A read inside the captured chunk fails the capture, and a capture or
replay error raises: nothing runs the loop eagerly in its place. Graphs
are not kept from one call to the next: the level-1 callbacks
(``kkt/diag.py``, ``kkt/spectral.py``) build device tensors from each
call's data that a kept graph would hold stale.

The kernels' wrappers count a launch where they issue it. Under capture
the card runs nothing, so :func:`drive` takes the capture's counts back
and adds them once per replay: the counters say what the card ran.
"""

from __future__ import annotations

import contextlib
import functools
from collections import Counter
from dataclasses import fields, is_dataclass

import torch
from torch.profiler import record_function

from ..ops import cholesky_kernel, jacobi_kernel
from . import ipm
from .state import SolState

__all__ = ["solve", "drive", "LOOP", "REPLAY"]

# profiler ranges (python -m conicip_tpu_torch.trace reads them): the whole
# loop, and its replays, in which the host issues no kernel
LOOP, REPLAY = "conicip::loop", "conicip::replay"


def _counters():
    return (cholesky_kernel.cholesky_launches,
            cholesky_kernel.predicated_launches,
            jacobi_kernel.jacobi_launches)


def _leaves(x) -> list:
    """The tensors of a carry (records and tuples of tensors), in order."""
    if isinstance(x, torch.Tensor):
        return [x]
    if is_dataclass(x):
        return [t for f in fields(x) for t in _leaves(getattr(x, f.name))]
    if isinstance(x, tuple):
        return [t for v in x for t in _leaves(v)]
    raise TypeError(f"not a carry leaf: {type(x).__name__}")


def _rebuild(like, leaves):
    """``like`` with its tensors replaced, in order, from ``leaves``."""
    if isinstance(like, torch.Tensor):
        return next(leaves)
    if is_dataclass(like):
        return type(like)(**{f.name: _rebuild(getattr(like, f.name), leaves)
                             for f in fields(like)})
    vals = [_rebuild(v, leaves) for v in like]
    return type(like)(*vals) if hasattr(like, "_fields") else tuple(vals)


def drive(cy: ipm.Carry, iterate, active):
    """``ipm_solve``'s loop on CUDA (module docstring): the first chunk
    eagerly, then replays of one captured chunk. Returns the final carry and
    what the loop did: host reads (``polls``), ``replays``, ``loop``
    "graph"."""

    def chunk(cy):
        for _ in range(ipm.POLL):
            cy = iterate(cy)
        return cy

    with record_function(LOOP):
        return _drive(cy, chunk, active)


def _drive(cy, chunk, active):
    with record_function("conicip::chunk0"):
        cy = chunk(cy)
    # Whether any instance still runs after the first chunk is read only
    # after the capture: the host captures while the card runs that chunk.
    # A solve that ends inside it throws the graph away unreplayed.
    running = active(cy)
    # the graph's inputs and outputs: one buffer per carried tensor, and
    # the flag the host polls, computed inside the graph
    static = _rebuild(cy, iter([t.clone() for t in _leaves(cy)]))
    flag = torch.empty((), dtype=torch.bool, device=cy.k.device)
    counters = _counters()
    before = [Counter(c) for c in counters]
    # the graph's private memory pool, freed with it after the solve
    pool = torch.cuda.MemPool()
    graph = torch.cuda.CUDAGraph()
    with record_function("conicip::capture"):
        graph.capture_begin(pool=pool.id)
        try:
            out = chunk(static)
            for dst, src in zip(_leaves(static), _leaves(out)):
                dst.copy_(src)
            flag.copy_(active(static))
        except BaseException:
            # end the capture so that the stream is usable again; the
            # error raised is the capture's own
            with contextlib.suppress(RuntimeError):
                graph.capture_end()
            raise
        graph.capture_end()
    del out
    deltas = []
    for c, b in zip(counters, before):
        deltas.append(c - b)
        c.clear()
        c.update(b)

    polls, replays = 1, 0
    if bool(running):
        with record_function(REPLAY):
            while True:
                graph.replay()
                replays += 1
                for c, delta in zip(counters, deltas):
                    c.update(delta)
                polls += 1
                if not bool(flag):
                    break
        cy = static
    graph.reset()
    # the pool's large blocks go with it; its small ones stay cached until
    # the cache is emptied (2 MiB a solve, measured on the H100)
    del pool
    torch.cuda.empty_cache()
    return cy, dict(polls=polls, replays=replays, loop="graph")


@functools.lru_cache(maxsize=None)
def _stream(device_index):
    """The one stream the solves on a device run and capture on: cuBLAS
    keeps a workspace for every stream it runs on, which a new stream per
    solve would add up."""
    return torch.cuda.Stream(device_index)


def solve(Q, c, A, b, G, d, spec, kktsolver, opts, warm=None,
          stats=None) -> SolState:
    """``ipm_solve`` of CUDA operands with the device loop in a CUDA graph
    (module docstring); the arguments are ``ipm_solve``'s. The returned
    state's tensors may be used on the caller's stream at once."""
    dev = c.device
    caller = torch.cuda.current_stream(dev)
    stream = _stream(dev.index)
    stream.wait_stream(caller)
    with torch.cuda.device(dev), torch.cuda.stream(stream):
        args = [x.clone(memory_format=torch.contiguous_format)
                for x in (Q, c, A, b, G, d)]
        if warm is not None:
            warm = warm.map(torch.clone)
        st = ipm.ipm_solve(*args, spec, kktsolver, opts, warm=warm,
                           stats=stats, device_loop=drive)
    caller.wait_stream(stream)
    for t in _leaves(st):
        t.record_stream(caller)
    return st
