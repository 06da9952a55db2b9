"""Carry problem data and solver state between numpy and the port.

The JAX package (``conicip_tpu``) takes and returns numpy arrays; the port
takes and returns tensors. These helpers move one problem, one solution or
one warm start across, so that both packages solve the same thing.
"""

from __future__ import annotations

from typing import Optional, Tuple

import numpy as np
import torch

from .parallel.batch import BatchSolution
from .solver import _densify
from .solver.state import Solution, to_host

__all__ = ["problem_from_numpy", "solution_to_numpy", "warm_from_numpy",
           "warm_to_numpy", "batch_from_numpy", "batch_solution_to_numpy",
           "to_host"]


def problem_from_numpy(Q, c, A, b, cone_dims, G=None, d=None, *,
                       device="cuda", dtype=torch.float64):
    """``(Q, c, A, b, cone_dims, G, d)`` as tensors, ready for
    :func:`conicip_tpu_torch.conic_ip`'s positional arguments."""
    return (_densify(Q, dtype, device), _densify(c, dtype, device),
            _densify(A, dtype, device), _densify(b, dtype, device),
            list(cone_dims), _densify(G, dtype, device),
            _densify(d, dtype, device))


def batch_from_numpy(Q, c, A, b, cone_dims, G=None, d=None, *,
                     device="cuda", dtype=torch.float64):
    """A stack of problems (leading batch axis on Q, c, A, b; G and d
    stacked or shared) as tensors, ready for
    :func:`conicip_tpu_torch.solve_batch`'s positional arguments."""
    return problem_from_numpy(Q, c, A, b, cone_dims, G, d, device=device,
                              dtype=dtype)


def batch_solution_to_numpy(sol: BatchSolution) -> BatchSolution:
    """A copy of ``sol`` with every field a host numpy array,
    field-compatible with ``conicip_tpu.BatchSolution`` (its ``statuses``
    included)."""
    return BatchSolution(**{f: getattr(sol, f).detach().cpu().numpy()
                            for f in BatchSolution.__dataclass_fields__})


def solution_to_numpy(sol: Solution) -> Solution:
    """A copy of ``sol`` with ``y``, ``w``, ``v`` as host numpy arrays,
    field-compatible with ``conicip_tpu.Solution``."""
    return Solution(
        y=sol.y.detach().cpu().numpy(), w=sol.w.detach().cpu().numpy(),
        v=sol.v.detach().cpu().numpy(), status=sol.status, Iter=sol.Iter,
        Mu=sol.Mu, prFeas=sol.prFeas, duFeas=sol.duFeas, muFeas=sol.muFeas,
        pobj=sol.pobj, dobj=sol.dobj)


def warm_from_numpy(y, w: Optional[np.ndarray], v, *, device="cuda",
                    dtype=torch.float64):
    """The port's ``warm_start`` from a solution's numpy fields (for example
    those of a ``conicip_tpu.Solution``, or the stacked fields of a
    ``conicip_tpu.BatchSolution`` for ``solve_batch``): a ``(y, w, v)``
    tensor tuple."""
    return (_densify(y, dtype, device), _densify(w, dtype, device),
            _densify(v, dtype, device))


def warm_to_numpy(sol) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """``(y, w, v)`` of a port solution as numpy arrays, a ``warm_start``
    that ``conicip_tpu.conic_ip`` accepts (``conicip_tpu.solve_batch``, when
    ``sol`` is a :class:`BatchSolution`)."""
    return tuple(x.detach().cpu().numpy() for x in (sol.y, sol.w, sol.v))
