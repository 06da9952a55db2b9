"""conicip_tpu_torch — the PyTorch/CUDA port of conicip_tpu.

Solves, like ``conicip_tpu`` (note the MINUS sign on cᵀy):

    minimize    ½ yᵀQy − cᵀy
    subject to  Ay ≥_K b,   K a product of R, Q and S cones
                Gy = d

with the same Mehrotra predictor-corrector method, Nesterov-Todd scaling,
statuses, certificates, best-iterate rule, warm starts, default backend
choice and 3-level KKT-callback contract, for one problem
(:func:`conic_ip`) or a stack of them (:func:`solve_batch`), on one
device or over the ranks of a ``torch.distributed`` mesh
(:func:`make_mesh`: ``solve_batch(mesh=...)`` shards a stack, and
:func:`kktsolver_schur_tp` one problem's Schur solve). The dense
Cholesky of every Schur-path iteration runs a hand-written CUDA kernel on
CUDA tensors (``csrc/cholesky.cu``) and a plain PyTorch version on the CPU.
:mod:`conicip_tpu_torch.frontend` holds the modeling frontends
(:class:`Optimizer`, ``solve_conic_form``, the CVXPY bridge).

This package imports torch, numpy and scipy only; it never imports JAX or
``conicip_tpu``. It computes nothing at import and never changes torch's
default dtype.
"""

import torch

from .cones import (ConeSpec, cone_div, cone_prod, mat, maxstep,
                    maxstep_to_cone, nt_identity, nt_inv_adjoint, nt_scaling,
                    vecm)
from .frontend import Optimizer
from .interop import (batch_from_numpy, batch_solution_to_numpy,
                      problem_from_numpy, solution_to_numpy, warm_from_numpy,
                      warm_to_numpy)
from .kkt import (kktsolver_2x2, kktsolver_diag, kktsolver_lu, kktsolver_qr,
                  kktsolver_schur, pivot, separable)
from .parallel import (BatchSolution, kktsolver_schur_tp, make_mesh,
                       solve_batch)
from .preprocess import imcols, preprocess_conic_ip
from .solver import IPMOptions, Solution, conic_ip

__version__ = "0.1.0"


def Id(n: int, *, device="cuda", dtype=torch.float64):
    """n-by-n identity on ``device``."""
    return torch.eye(int(n), dtype=dtype, device=device)


__all__ = [
    "ConeSpec",
    "mat",
    "vecm",
    "cone_prod",
    "cone_div",
    "maxstep",
    "maxstep_to_cone",
    "nt_scaling",
    "nt_identity",
    "nt_inv_adjoint",
    "conic_ip",
    "Solution",
    "IPMOptions",
    "pivot",
    "kktsolver_2x2",
    "kktsolver_schur",
    "kktsolver_diag",
    "kktsolver_qr",
    "kktsolver_lu",
    "separable",
    "preprocess_conic_ip",
    "imcols",
    "problem_from_numpy",
    "solution_to_numpy",
    "warm_from_numpy",
    "warm_to_numpy",
    "solve_batch",
    "BatchSolution",
    "kktsolver_schur_tp",
    "make_mesh",
    "batch_from_numpy",
    "batch_solution_to_numpy",
    "Optimizer",
    "Id",
]
