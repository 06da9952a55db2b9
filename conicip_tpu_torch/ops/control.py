"""Device-side control flow for the solve path.

Counterpart of ``conicip_tpu/ops/control.py``. The JAX package expresses
conditionals as 0/1-trip ``while_loop``s so that they stay real branches
under ``vmap`` and never leave the device. Here ``cond_once`` becomes a
plain ``if`` at its call sites (the host already knows its predicate), and
``retry_while`` a fixed number of predicated attempts: its predicate stays
on the device, so a solve that runs it reads nothing back and can be
captured in a CUDA graph.

A KKT generator's own ``lax.cond`` (the distributed factor's ridge retry)
is :func:`cond`, bound by the loop that calls the generator
(solver/ipm.py, :func:`bound`): the eager loop reads the predicate and
runs the body only where it holds; the device loop on the CPU runs the
body and takes its results by mask; on CUDA a captured unit makes the body
a conditional graph node, which runs only while the predicate holds on the
device.

Which kktsolvers the device loop takes is decided here too
(:func:`takes_device_loop`, :func:`eager_reason`): the package's own by a
mark on the function (so that a caller's ``functools.partial`` of one is
known as well) and its rule; a caller's own callable, as the reference's
``_solve_jit`` traces whatever kktsolver it is given, unless its callbacks
were found to read the device. :func:`guarded` finds that out before a
capture: it runs every call into the caller's code with PyTorch's sync
debug mode at "error", so that a ``.item()``, a ``bool(tensor)``, a
``torch.linalg`` call that checks ``info`` on the host, a ``nonzero`` or a
pageable host-to-device copy raises inside the caller's frame, and it
remembers the callable (:class:`ReadsDevice`).
"""

from __future__ import annotations

import contextlib
import functools
import inspect
import math
import os
import threading
import traceback
import weakref
from typing import Optional

import torch

__all__ = ["retry_while", "retry_attempts", "cond", "bound",
           "takes_device_loop", "eager_reason", "callers_own", "guarded",
           "ReadsDevice"]


def retry_attempts(scale0: float, factor: float, cap: float) -> int:
    """Attempts the reference's loop can make at most: one at each of
    scale0, scale0·factor, ... below ``cap``."""
    if scale0 >= cap:
        return 0
    return math.ceil(math.log(cap / scale0) / math.log(factor))


def retry_while(bad, step, state0, scale0, factor, cap):
    """Escalating retries: ``state = step(scale, skip, state)`` at scale
    ``scale0``, ``scale0·factor``, ... below ``cap``, each taken only where
    ``bad(state)`` holds. ``state0`` is the already-computed first attempt.

    ``step`` is predicated: ``skip`` is ``~bad(state)`` (``bad`` gives a
    bool tensor: one flag, or one per instance of a stack), and where it
    is set ``step`` must return ``state`` unchanged, and should cost
    nothing (the Cholesky kernel's predicated entry returns at once). So
    every attempt is launched, and each instance ends with the state the
    reference's ``while_loop`` gives it: the first good attempt, or the
    last one below the cap. Nothing is read back to decide it."""
    state, scale = state0, scale0
    for _ in range(retry_attempts(scale0, factor, cap)):
        skip = ~bad(state)
        state = step(scale, skip, state)
        scale = scale * factor
    return state


_loop = threading.local()


def _on_host(pred, body):
    return body() if bool(pred) else None


@contextlib.contextmanager
def bound(branch):
    """Bind :func:`cond` to the running loop's ``branch(pred, body)``
    (solver/ipm.py: ``on_host``, ``masked``, or a conditional graph node)
    while a KKT generator is called. Unbound, :func:`cond` reads its
    predicate on the host."""
    outer = getattr(_loop, "branch", None)
    _loop.branch = branch
    try:
        yield
    finally:
        _loop.branch = outer


def _merge(pred, new, old):
    if isinstance(new, torch.Tensor):
        return torch.where(pred, new, old)
    return type(old)(_merge(pred, a, b) for a, b in zip(new, old))


def cond(pred, body, old):
    """The reference's ``lax.cond(pred, body, lambda: old)``: ``body()``
    (a tensor or a tuple of tensors shaped as ``old``) where the device
    bool ``pred`` holds, else ``old``. The body runs as the bound loop runs
    it (:func:`bound`), and its results are merged by ``pred``, because a
    body that did not run (a conditional graph node whose predicate was
    false) leaves whatever its buffers held."""
    new = getattr(_loop, "branch", None) or _on_host
    new = new(pred, body)
    return old if new is None else _merge(pred, new, old)


def takes_device_loop(kktsolver, rule=None):
    """Mark one of the package's kktsolvers as one the device loop takes;
    ``rule(device)``, when given, names why it cannot on a device (None
    where it can). Returns ``kktsolver``."""
    kktsolver._device_loop_rule = rule or (lambda device: None)
    return kktsolver


def _rule(kktsolver):
    fn = kktsolver
    while isinstance(fn, functools.partial):
        fn = fn.func
    return getattr(fn, "_device_loop_rule", None)


def callers_own(kktsolver) -> bool:
    """Whether ``kktsolver`` is a caller's own callable: neither one of the
    package's marked kktsolvers nor a ``functools.partial`` of one."""
    return _rule(kktsolver) is None


# The callables found to read the device, each with the reason; weak keys,
# so that the memo keeps nothing alive. A bound method is a new object at
# each attribute access (``solver.kkt``), so it is remembered by its
# ``__self__`` and then its ``__func__`` (``_method_reads``), as the graph
# cache's key compares it.
_reads = weakref.WeakKeyDictionary()
_method_reads = weakref.WeakKeyDictionary()


def _remember(kktsolver, reason) -> None:
    """Record that ``kktsolver``'s callbacks read the device; a callable
    that cannot be weakly referenced is not remembered."""
    with contextlib.suppress(TypeError):
        if inspect.ismethod(kktsolver):
            _method_reads.setdefault(
                kktsolver.__self__,
                weakref.WeakKeyDictionary())[kktsolver.__func__] = reason
        else:
            _reads[kktsolver] = reason


def _recalled(kktsolver) -> Optional[str]:
    """The reason recorded for ``kktsolver``, or None."""
    try:
        if inspect.ismethod(kktsolver):
            funcs = _method_reads.get(kktsolver.__self__)
            return None if funcs is None else funcs.get(kktsolver.__func__)
        return _reads.get(kktsolver)
    except TypeError:  # not weakly referenceable: never remembered
        return None


def eager_reason(kktsolver, device) -> Optional[str]:
    """Why a run of ``kktsolver`` on ``device`` keeps the eager loop, or
    None when the device loop takes it: a marked kktsolver, or a
    ``functools.partial`` of one, by its rule; a caller's own callable
    unless :func:`guarded` found, on an earlier call on CUDA, that its
    callbacks read the device."""
    device = torch.device(device)
    rule = _rule(kktsolver)
    if rule is not None:
        return rule(device)
    if device.type != "cuda":
        return None
    return _recalled(kktsolver)


class ReadsDevice(RuntimeError):
    """A caller's KKT callback read the device under :func:`guarded`;
    ``reason`` names the operation and the caller's frame."""

    def __init__(self, reason: str):
        super().__init__(reason)
        self.reason = reason


# what PyTorch's sync debug mode raises in "error" mode
_SYNC = "synchronizing CUDA operation"
_TORCH = os.path.dirname(torch.__file__) + os.sep


def _culprit(err) -> str:
    """The caller's operation that synchronized: the source line and frame
    of the innermost traceback entry outside torch and this module."""
    frames = [f for f in traceback.extract_tb(err.__traceback__)
              if not f.filename.startswith(_TORCH)
              and f.filename != __file__]
    if not frames:
        return f"a caller's KKT callback reads the device: {err}"
    f = frames[-1]
    return (f"a caller's KKT callback reads the device: `{f.line}` "
            f"({os.path.basename(f.filename)}:{f.lineno}, in {f.name}) "
            f"synchronizes with the host")


def guarded(kktsolver):
    """``kktsolver`` with every call into the caller's code (level 1, the
    generator it returns, each solve that returns) run under PyTorch's sync
    debug mode "error", the old mode restored after it; only those calls,
    so the loop's own host reads between them are not refused. A read
    raises :class:`ReadsDevice` and is remembered for ``kktsolver``
    (:func:`eager_reason`). CUDA only."""

    def call(fn, args, kw):
        old = torch.cuda.get_sync_debug_mode()
        torch.cuda.set_sync_debug_mode("error")
        try:
            return fn(*args, **kw)
        except ReadsDevice:
            raise
        except RuntimeError as err:
            if _SYNC not in str(err):
                raise
            reason = _culprit(err)
            _remember(kktsolver, reason)
            raise ReadsDevice(reason) from err
        finally:
            torch.cuda.set_sync_debug_mode(old)

    def wrap(fn, then=None):
        # the wrapper keeps fn's signature (``mode`` of a two-variant
        # generator: kkt/pivot.py accepts_mode)
        @functools.wraps(fn)
        def wrapped(*args, **kw):
            out = call(fn, args, kw)
            return out if then is None else then(out)

        return wrapped

    return wrap(kktsolver, lambda gen: wrap(gen, wrap))
