"""Host-side control flow for the solve path.

Counterpart of ``conicip_tpu/ops/control.py``. The JAX package expresses
conditionals as 0/1-trip ``while_loop``s so that they stay real branches
under ``vmap``. PyTorch runs eagerly, so ``cond_once`` becomes a plain
``if`` at its call sites and ``retry_while`` a Python loop that reads its
predicate back from the device once per test.
"""

from __future__ import annotations

__all__ = ["retry_while"]


def retry_while(bad, step, state0, scale0, factor, cap):
    """Escalating retries: repeat ``state = step(scale)`` with ``scale``
    multiplied by ``factor`` after each attempt, while ``bad(state)`` holds
    and ``scale < cap``. ``state0`` is the already-computed first attempt,
    so a healthy first attempt costs one predicate read and no retry."""
    state, scale = state0, scale0
    while bool(bad(state)) and scale < cap:
        state = step(scale)
        scale = scale * factor
    return state
