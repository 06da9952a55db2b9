"""Dense LU of the full 3x3 saddle system.

Counterpart of ``conicip_tpu/kkt/lu.py``: factors the indefinite

    Z = ┌ Q   Gᵀ  -Aᵀ ┐
        │ G   0    0  │
        │ A   0   FᵀF │

directly with partial pivoting. It is the fallback for problems where the
Schur matrix ``Q + Aᵀ(FᵀF)⁻¹A`` is badly conditioned; the default
:func:`~conicip_tpu_torch.kkt.schur.kktsolver_schur` is preferred.

The factor runs in the working dtype unless ``factor_dtype`` pins another;
the IPM's refinement loop then recovers the accuracy, as on the Schur path.
``torch.linalg.lu_factor_ex`` reads no status back and raises nothing: a
singular Z gives a non-finite step, which the IPM's guard sees.

A stack of instances (Q (..., n, n), A (..., m, n), G stacked (..., p, n)
or one shared (p, n) system, vectors (..., n)) is one batched factor and
one batched solve per right-hand side; a non-finite instance gives a
non-finite step for itself alone.
"""

from __future__ import annotations

import torch

from ..cones import scaling as sc
from ..cones.spec import ConeSpec

__all__ = ["kktsolver_lu"]


def kktsolver_lu(Q, A, G, spec: ConeSpec, *, factor_dtype=None):
    n = Q.shape[-1]
    m = A.shape[-2]
    p = G.shape[-2]
    dtype = Q.dtype
    fd = dtype if factor_dtype is None else factor_dtype
    stack = torch.broadcast_shapes(Q.shape[:-2], A.shape[:-2], G.shape[:-2])

    # the constant blocks, assembled once; FᵀF fills the corner per iteration
    Z0 = torch.zeros(*stack, n + p + m, n + p + m, dtype=dtype,
                     device=Q.device)
    Z0[..., :n, :n] = Q
    Z0[..., :n, n:n + p] = G.mT
    Z0[..., :n, n + p:] = -A.mT
    Z0[..., n:n + p, :n] = G
    Z0[..., n + p:, :n] = A

    def solve3x3gen(F, FinvT):
        # FᵀF assembled block-diagonally from the structured scaling:
        # O(Σ k·d³), not the O(m³) dense square (scaling.dense_gram)
        Z = Z0.clone()
        Z[..., n + p:, n + p:] = sc.dense_gram(spec, F, dtype)
        lu, piv, _ = torch.linalg.lu_factor_ex(Z.to(fd))

        def solve3x3(bx, by, bz):
            rhs = torch.cat([bx, by, bz], dim=-1).to(fd)
            u = torch.linalg.lu_solve(
                lu, piv, rhs.unsqueeze(-1)).squeeze(-1).to(dtype)
            return u[..., :n], u[..., n:n + p], u[..., n + p:]

        return solve3x3

    return solve3x3gen
