"""Adapter from 2x2 KKT solvers to the 3x3 interface.

Counterpart of ``conicip_tpu/kkt/pivot.py``. The inner solver handles the
Schur system::

    ┌                    ┐ ┌   ┐   ┌   ┐
    │ Q + Aᵀ(FᵀF)⁻¹A  Gᵀ │ │ a │ = │ y │
    │ G                  │ │ b │   │ w │
    └                    ┘ └   ┘   └   ┘

and the cone block is eliminated with ``(FᵀF)⁻¹ = F⁻¹F⁻ᵀ`` (correct for the
S-cone congruences too, where ``F`` is not symmetric).

With ``factor_dtype`` set, the adapter's own matrix products (``Aᵀt₁`` and
``A·Δy``) run in that precision against a one-time-cast copy of A; the
IPM's refinement loop against full-precision residuals absorbs the error.

With ``lastmile`` additionally set, the adapter exposes the two-variant
``mode`` contract (kkt/schur.py): ``solve3x3gen(F, FinvT, mode="slow")``
returns a solver whose products and ``(FᵀF)⁻¹`` applies run in the working
dtype. ``t₁ = (FᵀF)⁻¹v`` is amplified by 1/μ near convergence, so a
low-precision ``Aᵀt₁`` alone would re-inject the noise the inner
full-precision factors just removed. The IPM picks the variant once per
iteration, on the host; both variants are straight-line code.

Operands may carry a stack of instances as leading dims (Q (..., n, n),
A (..., m, n), vectors (..., n)): every product is then a batched one, and
the inner solver receives and returns stacked tensors.
"""

from __future__ import annotations

import inspect

from ..cones import scaling as sc
from ..cones.spec import ConeSpec
from ..ops.batched import mv

__all__ = ["pivot", "accepts_mode"]


def accepts_mode(gen) -> bool:
    """Whether a generator takes the ``mode="fast"|"slow"`` keyword."""
    try:
        return "mode" in inspect.signature(gen).parameters
    except (TypeError, ValueError):  # pragma: no cover
        return False


def pivot(kktsolver_2x2, factor_dtype=None, lastmile=False):
    """Wrap a 2x2 solver factory into a 3x3 one."""

    def kktsolver(Q, A, G, spec: ConeSpec):
        solve2x2gen = kktsolver_2x2(Q, A, G, spec)
        fwd_mode = accepts_mode(solve2x2gen)
        wd = Q.dtype
        fd = wd if factor_dtype is None else factor_dtype
        Af = A.to(fd)
        AfT = Af.mT

        # (FᵀF)⁻¹ has κ ~ 1/μ near convergence. For pure-R specs it is
        # diagonal: a low-precision apply is accurate per component with
        # no cancellation, so the cast path is exact enough. SOC and SDP
        # scalings mix components: there a low-precision apply carries
        # ~eps/μ relative error that refinement cannot contract once it
        # exceeds 1, so those specs run w2inv in the working dtype; only
        # the big A products stay in the factor dtype either way.
        amplified = bool(spec.soc_groups or spec.sdp_groups)
        lm = bool(lastmile) and fd != wd

        def _mk_solve3(solve2x2, Ax, AxT, Fi_x, td_x):
            pd = Ax.dtype  # product dtype of the big A products

            def w2inv(x):
                # (FᵀF)⁻¹ x = F⁻¹ (F⁻ᵀ x)
                return sc.apply_adjoint(spec, Fi_x, sc.apply(spec, Fi_x, x))

            def solve3x3(y, w, v):
                t1 = w2inv(v.to(td_x))
                dy, dw = solve2x2(y + mv(AxT, t1.to(pd)).to(wd), w)
                # Δv = (FᵀF)⁻¹ (v - A Δy)
                dv = t1 - w2inv(mv(Ax, dy.to(pd)).to(td_x))
                return dy, dw, dv.to(wd)

            return solve3x3

        def _inner(F, FinvT, mode):
            if fwd_mode:
                return solve2x2gen(F, FinvT, mode=mode)
            return solve2x2gen(F, FinvT)

        def solve3x3gen(F, FinvT):
            Fi = FinvT if amplified else sc.cast(FinvT, fd)
            td = wd if amplified else fd
            return _mk_solve3(_inner(F, FinvT, "fast"), Af, AfT, Fi, td)

        if not lm:
            return solve3x3gen

        def solve3x3gen_lm(F, FinvT, mode="fast"):
            if mode == "slow":
                return _mk_solve3(_inner(F, FinvT, "slow"), A, A.mT, FinvT, wd)
            return solve3x3gen(F, FinvT)

        return solve3x3gen_lm

    return kktsolver
