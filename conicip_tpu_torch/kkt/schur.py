"""Dense Schur-complement KKT solver — the default for non-separable problems.

Counterpart of ``conicip_tpu/kkt/schur.py``. The Schur matrix is assembled
as ``M = Q + Atilᵀ Atil`` with ``Atil = F⁻ᵀA`` applied structurally (row
scaling on R cones, rank-1 updates on Q, congruences on S), and the saddle
system is solved by a second Schur complement on G:

    M̃ = M + γGᵀG = L Lᵀ     (Jacobi-equilibrated, ridge-retried Cholesky)
    S = G M̃⁻¹ Gᵀ = (L⁻¹Gᵀ)ᵀ(L⁻¹Gᵀ),   S = Ls Lsᵀ

Each factor's explicit inverse is formed once per iteration, so every
back-solve is two matrix-vector products. On CUDA tensors both factors run
the hand-written Cholesky kernel (``ops/cholesky.py``), through its f64 or
its f32 entry according to the dtype factored.

Mixed precision (``factor_dtype=torch.float32``): the whole inner solve
path (casts, assembly, factorization and every per-right-hand-side
application) runs in f32, and the IPM's iterative refinement against
higher-precision residuals restores accuracy. On hardware with native f64,
as the H100, this is an option and f64 the default. ``assemble_dtype`` pins
a (possibly higher) assembly precision: SOC scalings span ~16 decades near
convergence and the Gram assembly cancels catastrophically in f32.

A stack of instances (Q (..., n, n), A (..., m, n), G (..., p, n), vectors
(..., n)) is assembled and solved by the same code: the products become
batched library products, each instance is equilibrated and ridge-retried
by itself, and the two factors run the kernel's batched entry, one stacked
factor per build.

Last-mile full-precision iterations (``lastmile=True``): near convergence
κ(M) ~ 1/μ exceeds what an f32 factor can solve and refinement stalls just
above tolerance. A ``lastmile`` generator exposes two variants through
``solve3x3gen(F, FinvT, mode="fast"|"slow")``, the f32 path and the
full-working-dtype path, and the IPM picks one per iteration
(solver/ipm.py), so only the last one or two iterations pay the
full-precision factor. Only the variant picked assembles and factors.
"""

from __future__ import annotations

import functools

import torch

from ..cones import scaling as sc
from ..cones.spec import ConeSpec
from ..ops.batched import col, mv, sum_all, trace
from ..ops.cholesky import cholesky, tri_inv
from ..ops.control import retry_while, takes_device_loop
from .pivot import pivot

__all__ = ["kktsolver_2x2", "kktsolver_schur"]


def kktsolver_2x2(Q, A, G, spec: ConeSpec, *, factor_dtype=None,
                  assemble_dtype=None, lastmile=False):
    """Dense-Cholesky 2x2 solver for ``[[M, Gᵀ], [G, 0]]`` with
    ``M = Q + Aᵀ(FᵀF)⁻¹A``.

    With equalities, the *augmented* matrix ``M̃ = M + γ GᵀG`` is factored
    (SPD when ``[Q; A; G]`` has full column rank) and the saddle solution is
    recovered exactly:

        M̃ a + Gᵀ b = r₁ + γ Gᵀ r₂,   G a = r₂
        →  a = t − E b̂,  S̃ b̂ = G t − r₂
        with t = M̃⁻¹(r₁ + γ Gᵀ r₂),  E = M̃⁻¹Gᵀ,  S̃ = G E  (SPD).

    ``factor_dtype`` is the precision of the factors and back-solves,
    ``assemble_dtype`` that of the assembly (default: the factor dtype);
    ``lastmile`` exposes the two-variant ``mode`` contract (module
    docstring).
    """
    n = Q.shape[-1]
    p = G.shape[-2]
    wd = Q.dtype  # working dtype of the IPM vectors
    fd = wd if factor_dtype is None else factor_dtype
    ad = fd if assemble_dtype is None else assemble_dtype
    lastmile = bool(lastmile) and fd != wd

    def _factors(adt, odt, F, FinvT):
        """Assemble (precision ``adt``), equilibrate, and factor (precision
        ``odt``) the augmented Schur system. Returns ``odt`` tensors:
        (Linv, dscale, gamma, Lsinv, sscale)."""
        Atil = sc.apply_mat(spec, sc.cast(FinvT, adt), A.to(adt))  # F⁻ᵀ A
        M = Q.to(adt) + Atil.mT @ Atil
        if p:
            Ga = G.to(adt)
            gamma = (trace(M) / n) / (
                sum_all(Ga * Ga) / p + torch.finfo(adt).tiny)
            gamma = torch.where(torch.isfinite(gamma) & (gamma > 0), gamma,
                                torch.ones_like(gamma))
            M = M + gamma[..., None, None] * (Ga.mT @ Ga)
        else:
            gamma = None

        ridge = 30.0 * torch.finfo(odt).eps

        def _equilibrate(Msym):
            dscale = torch.rsqrt(torch.clamp(
                torch.diagonal(Msym, dim1=-2, dim2=-1),
                min=torch.finfo(Msym.dtype).tiny))
            Ms = (Msym * dscale[..., :, None] * dscale[..., None, :]).to(odt)
            return Ms, dscale.to(odt)

        def _factor_inv(Ms, k):
            # Jacobi equilibration (unit diagonal) plus a tiny relative
            # ridge keeps the factor finite as κ(M) grows like 1/μ;
            # escalating-ridge retries (boosts 1e3, then 1e6) catch what
            # rounding leaves indefinite. A failed factor is non-finite,
            # which is what triggers the retry, per instance of a stack;
            # both retries are predicated factors, decided on the device.
            Ik = torch.eye(k, dtype=odt, device=Ms.device)
            L = retry_while(
                lambda L: ~torch.isfinite(L).flatten(-2).all(-1),
                lambda boost, skip, L: cholesky(
                    Ms + (boost * ridge) * Ik, skip=skip, out=L),
                cholesky(Ms + ridge * Ik),
                1e3,
                1e3,
                1e7,
            )
            return tri_inv(L)

        Ms, dscale = _equilibrate(M)
        Linv = _factor_inv(Ms, n)
        if p:
            # S = G M̃⁻¹ Gᵀ = Ê Êᵀ with Ê = G D L⁻ᵀ in equilibrated space
            E = Linv @ (dscale[..., None] * G.mT.to(odt))
            Ss, sscale = _equilibrate(E.mT @ E)
            Lsinv = _factor_inv(Ss, p)
            gamma = gamma.to(odt)
        else:
            Lsinv = sscale = None
        return Linv, dscale, gamma, Lsinv, sscale

    def _make_solve(facts, Gd, GdT):
        Linv, dscale, gamma, Lsinv, sscale = facts
        td = Linv.dtype

        def inv2(Tinv, scale, x):
            # M⁻¹x = D L⁻ᵀ L⁻¹ D x with D the equilibration scale
            return scale * mv(Tinv.mT, mv(Tinv, scale * x))

        def solve(by, bw):
            by = by.to(td)
            bw = bw.to(td)
            if p:
                t = inv2(Linv, dscale, by + col(gamma) * mv(GdT, bw))
                b2 = inv2(Lsinv, sscale, mv(Gd, t) - bw)
                a = t - inv2(Linv, dscale, mv(GdT, b2))
                return a.to(wd), b2.to(wd)
            return inv2(Linv, dscale, by).to(wd), by[..., :0].to(wd)

        return solve

    Gf = G.to(fd)
    GfT = Gf.mT

    if not lastmile:

        def solve2x2gen(F, FinvT):
            return _make_solve(_factors(ad, fd, F, FinvT), Gf, GfT)

        return solve2x2gen

    GT = G.mT

    def solve2x2gen_lm(F, FinvT, mode="fast"):
        if mode == "slow":
            return _make_solve(_factors(wd, wd, F, FinvT), G, GT)
        return _make_solve(_factors(ad, fd, F, FinvT), Gf, GfT)

    return solve2x2gen_lm


@takes_device_loop
def kktsolver_schur(Q, A, G, spec: ConeSpec, *, factor_dtype=None,
                    assemble_dtype=None, lastmile=False):
    """Default KKT solver: :func:`pivot` around :func:`kktsolver_2x2`."""
    inner = functools.partial(kktsolver_2x2, factor_dtype=factor_dtype,
                              assemble_dtype=assemble_dtype,
                              lastmile=lastmile)
    return pivot(inner, factor_dtype=factor_dtype,
                 lastmile=lastmile)(Q, A, G, spec)
