"""Adapter from 2x2 KKT solvers to the 3x3 interface.

Counterpart of ``conicip_tpu/kkt/pivot.py`` in its single-variant form.
The inner solver handles the Schur system::

    ┌                    ┐ ┌   ┐   ┌   ┐
    │ Q + Aᵀ(FᵀF)⁻¹A  Gᵀ │ │ a │ = │ y │
    │ G                  │ │ b │   │ w │
    └                    ┘ └   ┘   └   ┘

and the cone block is eliminated with ``(FᵀF)⁻¹ = F⁻¹F⁻ᵀ``.
"""

from __future__ import annotations

from ..cones import scaling as sc
from ..cones.spec import ConeSpec

__all__ = ["pivot"]


def pivot(kktsolver_2x2):
    """Wrap a 2x2 solver factory into a 3x3 one."""

    def kktsolver(Q, A, G, spec: ConeSpec):
        solve2x2gen = kktsolver_2x2(Q, A, G, spec)
        AT = A.T

        def solve3x3gen(F, FinvT):
            solve2x2 = solve2x2gen(F, FinvT)

            def w2inv(x):
                # (FᵀF)⁻¹ x = F⁻¹ (F⁻ᵀ x)
                return sc.apply_adjoint(spec, FinvT, sc.apply(spec, FinvT, x))

            def solve3x3(y, w, v):
                t1 = w2inv(v)
                dy, dw = solve2x2(y + AT @ t1, w)
                # Δv = (FᵀF)⁻¹ (v - A Δy)
                dv = t1 - w2inv(A @ dy)
                return dy, dw, dv

            return solve3x3

        return solve3x3gen

    return kktsolver
