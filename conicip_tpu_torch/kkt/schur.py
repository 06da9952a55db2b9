"""Dense Schur-complement KKT solver — the default for non-separable problems.

Counterpart of ``conicip_tpu/kkt/schur.py`` on its full-precision path.
The Schur matrix is assembled as ``M = Q + Atilᵀ Atil`` with
``Atil = F⁻ᵀA`` applied structurally (row scaling on R cones), and the
saddle system is solved by a second Schur complement on G:

    M̃ = M + γGᵀG = L Lᵀ     (Jacobi-equilibrated, ridge-retried Cholesky)
    S = G M̃⁻¹ Gᵀ = (L⁻¹Gᵀ)ᵀ(L⁻¹Gᵀ),   S = Ls Lsᵀ

Each factor's explicit inverse is formed once per iteration, so every
back-solve is two matrix-vector products. On CUDA tensors both factors run
the hand-written Cholesky kernel (``ops/cholesky.py``).
"""

from __future__ import annotations

import torch

from ..cones import scaling as sc
from ..cones.spec import ConeSpec
from ..ops.cholesky import cholesky, tri_inv
from ..ops.control import retry_while
from .pivot import pivot

__all__ = ["kktsolver_2x2", "kktsolver_schur"]


def _full_precision_only(factor_dtype, assemble_dtype):
    if factor_dtype is not None or assemble_dtype is not None:
        raise NotImplementedError(
            "the PyTorch port factors in the working dtype only; "
            "factor_dtype and assemble_dtype are still to be ported "
            "(see ROADMAP.md, queue 1)")


def kktsolver_2x2(Q, A, G, spec: ConeSpec, *, factor_dtype=None,
                  assemble_dtype=None):
    """Dense-Cholesky 2x2 solver for ``[[M, Gᵀ], [G, 0]]`` with
    ``M = Q + Aᵀ(FᵀF)⁻¹A``.

    With equalities, the *augmented* matrix ``M̃ = M + γ GᵀG`` is factored
    (SPD when ``[Q; A; G]`` has full column rank) and the saddle solution is
    recovered exactly:

        M̃ a + Gᵀ b = r₁ + γ Gᵀ r₂,   G a = r₂
        →  a = t − E b̂,  S̃ b̂ = G t − r₂
        with t = M̃⁻¹(r₁ + γ Gᵀ r₂),  E = M̃⁻¹Gᵀ,  S̃ = G E  (SPD).
    """
    _full_precision_only(factor_dtype, assemble_dtype)
    n = Q.shape[0]
    p = G.shape[0]
    dt = Q.dtype
    finfo = torch.finfo(dt)
    ridge = 30.0 * finfo.eps
    GT = G.T

    def _equilibrate(Msym):
        dscale = torch.rsqrt(torch.clamp(torch.diagonal(Msym), min=finfo.tiny))
        return Msym * dscale[:, None] * dscale[None, :], dscale

    def _factor_inv(Ms, k):
        # Jacobi equilibration (unit diagonal) plus a tiny relative ridge
        # keeps the factor finite as κ(M) grows like 1/μ; escalating-ridge
        # retries (boosts 1e3, then 1e6) catch what rounding leaves
        # indefinite. A failed factor is non-finite, which is what
        # triggers the retry.
        Ik = torch.eye(k, dtype=dt, device=Ms.device)
        L = retry_while(
            lambda L: ~torch.isfinite(L).all(),
            lambda boost: cholesky(Ms + (boost * ridge) * Ik),
            cholesky(Ms + ridge * Ik),
            1e3,
            1e3,
            1e7,
        )
        return tri_inv(L)

    def solve2x2gen(F, FinvT):
        Atil = sc.apply_mat(spec, FinvT, A)  # F⁻ᵀ A
        M = Q + Atil.T @ Atil
        if p:
            gamma = (torch.trace(M) / n) / (torch.sum(G * G) / p + finfo.tiny)
            gamma = torch.where(torch.isfinite(gamma) & (gamma > 0), gamma,
                                torch.ones_like(gamma))
            M = M + gamma * (GT @ G)
        Ms, dscale = _equilibrate(M)
        Linv = _factor_inv(Ms, n)
        if p:
            # S = G M̃⁻¹ Gᵀ = Ê Êᵀ with Ê = G D L⁻ᵀ in equilibrated space
            E = Linv @ (dscale[:, None] * GT)
            Ss, sscale = _equilibrate(E.T @ E)
            Lsinv = _factor_inv(Ss, p)

        def inv2(Tinv, scale, x):
            # M⁻¹x = D L⁻ᵀ L⁻¹ D x with D the equilibration scale
            return scale * (Tinv.T @ (Tinv @ (scale * x)))

        def solve2x2(by, bw):
            if p:
                t = inv2(Linv, dscale, by + gamma * (GT @ bw))
                b2 = inv2(Lsinv, sscale, G @ t - bw)
                return t - inv2(Linv, dscale, GT @ b2), b2
            return inv2(Linv, dscale, by), by[:0]

        return solve2x2

    return solve2x2gen


def kktsolver_schur(Q, A, G, spec: ConeSpec, *, factor_dtype=None,
                    assemble_dtype=None):
    """Default KKT solver: :func:`pivot` around :func:`kktsolver_2x2`."""
    _full_precision_only(factor_dtype, assemble_dtype)
    return pivot(kktsolver_2x2)(Q, A, G, spec)
