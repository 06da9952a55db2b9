"""Pluggable KKT solvers, with the 3-level callback contract of
``conicip_tpu.kkt``::

    solve3x3gen = kktsolver(Q, A, G, spec)          # one-time setup
    solve3x3    = solve3x3gen(F, FinvT)             # per-iteration refactor
    (a, b, c)   = solve3x3(x, y, z)                 # per-RHS solve

solving::

    ┌             ┐ ┌   ┐   ┌   ┐
    │ Q   Gᵀ  -Aᵀ │ │ a │ = │ x │
    │ G           │ │ b │   │ y │
    │ A       FᵀF │ │ c │   │ z │
    └             ┘ └   ┘   └   ┘

Every level works on tensors; ``F``/``FinvT`` are structured
:class:`~conicip_tpu_torch.cones.scaling.NTScaling` records.

- :func:`kktsolver_schur`: dense Schur complement, the default;
- :func:`kktsolver_diag`: diagonal Schur matrix for separable problems;
- :func:`kktsolver_qr`: CVXOPT §10.2 double QR, for rank-deficient Q;
- :func:`kktsolver_lu`: dense LU of the full 3x3 saddle system.

``kkt.spectral`` and ``kkt.lowrank`` are reached by module path, as in
``conicip_tpu.kkt``.
"""

from .diag import kktsolver_diag, separable, separable_batch
from .lu import kktsolver_lu
from .pivot import pivot
from .qr import kktsolver_qr
from .schur import kktsolver_2x2, kktsolver_schur

__all__ = [
    "kktsolver_diag",
    "separable",
    "separable_batch",
    "pivot",
    "kktsolver_2x2",
    "kktsolver_schur",
    "kktsolver_qr",
    "kktsolver_lu",
]
