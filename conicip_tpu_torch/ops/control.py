"""Device-side control flow for the solve path.

Counterpart of ``conicip_tpu/ops/control.py``. The JAX package expresses
conditionals as 0/1-trip ``while_loop``s so that they stay real branches
under ``vmap`` and never leave the device. Here ``cond_once`` becomes a
plain ``if`` at its call sites (the host already knows its predicate), and
``retry_while`` a fixed number of predicated attempts: its predicate stays
on the device, so a solve that runs it reads nothing back and can be
captured in a CUDA graph.
"""

from __future__ import annotations

import math

__all__ = ["retry_while", "retry_attempts"]


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
