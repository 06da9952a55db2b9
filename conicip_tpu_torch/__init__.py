"""conicip_tpu_torch — the PyTorch/CUDA port of conicip_tpu.

Solves, like ``conicip_tpu`` (note the MINUS sign on cᵀy):

    minimize    ½ yᵀQy − cᵀy
    subject to  Ay ≥_K b,   K a product of R, Q and S cones
                Gy = d

with the same Mehrotra predictor-corrector method, Nesterov-Todd scaling,
statuses, certificates, best-iterate rule, warm starts, default backend
choice and 3-level KKT-callback contract, for one problem
(:func:`conic_ip`) or a stack of them (:func:`solve_batch`). The dense
Cholesky of every Schur-path iteration runs a hand-written CUDA kernel on
CUDA tensors (``csrc/cholesky.cu``) and a plain PyTorch version on the CPU.

This package imports torch, numpy and scipy only; it never imports JAX or
``conicip_tpu``. It computes nothing at import and never changes torch's
default dtype.
"""

from .cones import (ConeSpec, cone_div, cone_prod, mat, maxstep,
                    maxstep_to_cone, nt_identity, nt_inv_adjoint, nt_scaling,
                    vecm)
from .interop import (batch_from_numpy, batch_solution_to_numpy,
                      problem_from_numpy, solution_to_numpy, warm_from_numpy,
                      warm_to_numpy)
from .kkt import (kktsolver_2x2, kktsolver_diag, kktsolver_lu, kktsolver_qr,
                  kktsolver_schur, pivot, separable)
from .parallel import BatchSolution, solve_batch
from .preprocess import imcols, preprocess_conic_ip
from .solver import IPMOptions, Solution, conic_ip

__version__ = "0.1.0"

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
    "batch_from_numpy",
    "batch_solution_to_numpy",
]
