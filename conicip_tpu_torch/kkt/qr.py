"""CVXOPT §10.2 double-QR KKT solver.

Counterpart of ``conicip_tpu/kkt/qr.py``: a one-time complete QR of Gᵀ
splits the space into range and null parts of the equality constraints;
each iteration re-factors the reduced system ``Q₂ᵀ(Q + AᵀF⁻¹F⁻ᵀA)Q₂`` by
QR. Works with rank-deficient ``Q`` (the Schur solver needs
``Q + Aᵀ(FᵀF)⁻¹A ≻ 0``; this one only needs it on the null space of G).

Both QR factorizations and the triangular solves are ``torch.linalg``
calls, as they are library calls in the JAX package. None of them reads a
status back or raises on a singular factor: a breakdown gives a non-finite
step, which the IPM's guard sees.

A stack of instances (Q (..., n, n), A (..., m, n), vectors (..., n)) goes
through the same code as batched library calls; G may be stacked
(..., p, n) or one shared (p, n) system, whose one-time QR then serves
every instance. A non-finite instance of a stack gives non-finite factors
for itself alone.
"""

from __future__ import annotations

import torch

from ..cones import scaling as sc
from ..cones.spec import ConeSpec
from ..ops.batched import mv
from ..ops.control import takes_device_loop

__all__ = ["kktsolver_qr"]


def _tri_solve(T, b, upper):
    return torch.linalg.solve_triangular(
        T, b.unsqueeze(-1), upper=upper).squeeze(-1)


def _qr_solve(Qf, Rf, b):
    """Least-squares solve via a reduced QR factorization."""
    return _tri_solve(Rf, mv(Qf.mT, b), upper=True)


@takes_device_loop
def kktsolver_qr(Q, A, G, spec: ConeSpec):
    p = G.shape[-2]

    if p:
        Q0, R = torch.linalg.qr(G.mT, mode="complete")  # (n,n), (n,p)
        Q1 = Q0[..., :, :p]
        Q2 = Q0[..., :, p:]
        R1 = R[..., :p, :p]

    def solve3x3gen(F, FinvT):
        Atil = sc.apply_mat(spec, FinvT, A)  # F⁻ᵀ A
        M = Q + Atil.mT @ Atil  # Q + AᵀF⁻¹F⁻ᵀA
        Lq, Lr = torch.linalg.qr((Q2.mT @ M) @ Q2 if p else M)

        def solve3x3(bx, by, bz):
            Fz0 = sc.apply(spec, FinvT, bz)  # F⁻ᵀ bz
            rhs = bx + mv(Atil.mT, Fz0)
            if p:
                u1 = _tri_solve(R1.mT, by, upper=False)  # Q1ᵀ a
                t = mv(M, mv(Q1, u1))
                u2 = _qr_solve(Lq, Lr, mv(Q2.mT, rhs) - mv(Q2.mT, t))  # Q2ᵀ a
                b = _tri_solve(
                    R1, mv(Q1.mT, rhs) - mv(Q1.mT, t)
                    - mv(Q1.mT, mv(M, mv(Q2, u2))),
                    upper=True)
                a = mv(Q1, u1) + mv(Q2, u2)
            else:
                a = _qr_solve(Lq, Lr, rhs)
                b = bx[..., :0]
            Fz = Fz0 - mv(Atil, a)  # F⁻ᵀ(bz - A a)
            c = sc.apply_adjoint(spec, FinvT, Fz)  # (FᵀF)⁻¹(bz - A a)
            return a, b, c

        return solve3x3

    return solve3x3gen
