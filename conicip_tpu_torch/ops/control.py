"""Host-side control flow for the solve path.

Counterpart of ``conicip_tpu/ops/control.py``. The JAX package expresses
conditionals as 0/1-trip ``while_loop``s so that they stay real branches
under ``vmap``. PyTorch runs eagerly, so ``cond_once`` becomes a plain
``if`` at its call sites and ``retry_while`` a Python loop that reads its
predicate back from the device once per test.
"""

from __future__ import annotations

import torch

__all__ = ["retry_while"]


def retry_while(bad, step, state0, scale0, factor, cap):
    """Escalating retries: repeat ``state = step(scale)`` with ``scale``
    multiplied by ``factor`` after each attempt, while ``bad(state)`` holds
    and ``scale < cap``. ``state0`` is the already-computed first attempt,
    so a healthy first attempt costs one predicate read and no retry.

    ``bad`` may return one flag per instance of a stack (``state`` then has
    that many leading dims): the loop goes on while any instance is bad,
    and only the bad instances take the new attempt, so each instance ends
    with the state its own loop would have given it (what ``vmap`` makes of
    the reference's ``while_loop``)."""
    state, scale = state0, scale0

    def per_instance(flags):
        return isinstance(flags, torch.Tensor) and flags.dim() > 0

    flags = bad(state)
    while bool(flags.any() if per_instance(flags) else flags) and scale < cap:
        new = step(scale)
        if per_instance(flags):
            pick = flags.reshape(flags.shape + (1,) * (new.dim() - flags.dim()))
            state = torch.where(pick, new, state)
        else:
            state = new
        scale = scale * factor
        flags = bad(state)
    return state
