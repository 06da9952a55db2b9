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

Which kktsolvers the device loop takes is marked here too
(:func:`takes_device_loop`, :func:`eager_reason`): the package's own, by a
mark on the function, so that a caller's ``functools.partial`` of one is
known as well.
"""

from __future__ import annotations

import contextlib
import functools
import math
import threading
from typing import Optional

import torch

__all__ = ["retry_while", "retry_attempts", "cond", "bound",
           "takes_device_loop", "eager_reason"]


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


def eager_reason(kktsolver, device) -> Optional[str]:
    """Why a run of ``kktsolver`` on ``device`` keeps the eager loop, or
    None when the device loop takes it: a marked kktsolver, or a
    ``functools.partial`` of one, by its rule; any other callable is a
    caller's own, whose callbacks may read the device."""
    fn = kktsolver
    while isinstance(fn, functools.partial):
        fn = fn.func
    rule = getattr(fn, "_device_loop_rule", None)
    if rule is None:
        return "a caller's own kktsolver, whose callbacks may read the device"
    return rule(torch.device(device))
