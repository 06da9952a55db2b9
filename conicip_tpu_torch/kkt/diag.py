"""Structure-exploiting KKT solver for separable (bound-style) constraints.

Counterpart of ``conicip_tpu/kkt/diag.py``. When every cone is ``R``, every
row of A has at most one nonzero and Q is diagonal, the Schur matrix
``M = Q + Aᵀ(FᵀF)⁻¹A`` is diagonal: ``diag(M) = diag(Q) + P @ (d ⊙ a²)``
with the 0/1 incidence matrix ``P[k, i] = 1`` iff row i of A touches
column k.

Equalities use the exact augmented-saddle recovery of the dense path
(``M̃ = M + γGᵀG``), with ``M̃⁻¹`` applied exactly in one of two modes:

- ``"disjoint"``: every row of G has at most one nonzero, so ``GᵀG`` is
  diagonal and so is ``M̃``.
- ``"woodbury"``: general G, ``M̃⁻¹ = D⁻¹ − D⁻¹Gᵀ(γ⁻¹I + GD⁻¹Gᵀ)⁻¹GD⁻¹``:
  a (p, p) Cholesky plus thin products. Needs a strictly positive diag(Q).

Both (p, p) factors go through ``ops/cholesky.py``, so on CUDA they run the
hand-written kernel. ``factor_dtype`` runs the whole 2x2 solve (pattern
data, diagonal, factors, back-solves) in that precision and returns the
working dtype. Applicability is checked on host arrays by
:func:`separable` (:func:`separable_batch` for a stack of instances) and
:func:`equality_mode`, not inside the solver. The solver takes a stack of
instances as leading dims on every operand.
"""

from __future__ import annotations

import functools

import numpy as np
import torch

from ..cones.spec import ConeSpec
from ..ops.batched import col, mv, sum_all, trace
from ..ops.cholesky import cholesky, tri_inv
from .pivot import pivot

__all__ = ["kktsolver_diag", "kktsolver_2x2_diag", "separable",
           "separable_batch", "equality_mode"]


def _where_it_is(X) -> torch.Tensor:
    """The caller's array as a tensor on the device it already lies on
    (host data stays on the host, without a copy where numpy allows), so
    that a structure check moves no operand: it reads back one flag."""
    if isinstance(X, torch.Tensor):
        return X.detach()
    X = np.asarray(X.toarray() if hasattr(X, "toarray") else X)
    if not X.flags.writeable:
        X = X.copy()
    return torch.as_tensor(X)


def _rows_have_one_nonzero(X: torch.Tensor) -> bool:
    return bool((torch.count_nonzero(X, dim=-1) <= 1).all())


def _is_diagonal(Q: torch.Tensor) -> bool:
    """Every matrix of the stack (..., n, n) is diagonal."""
    diag = torch.diag_embed(torch.diagonal(Q, dim1=-2, dim2=-1))
    return bool((Q == diag).all())


def equality_mode(Q, G):
    """Host-side choice of the exact equality mode, or ``None`` when no
    mode is exact and stable (the dense Schur backend must be used). Works
    on one problem and on a stack (leading batch axis), which must admit
    one common mode:

    - no equalities → ``"none"``
    - every row of G has at most one nonzero → ``"disjoint"``
    - diag(Q) strictly positive → ``"woodbury"``
    """
    if G is None:
        return "none"
    Gt = _where_it_is(G)
    if Gt.numel() == 0 or Gt.shape[-2] == 0:
        return "none"
    if _rows_have_one_nonzero(Gt):
        return "disjoint"
    qd = torch.diagonal(_where_it_is(Q), dim1=-2, dim2=-1)
    if qd.numel() and float(qd.min()) > 1e-10 * max(1.0, float(qd.max())):
        return "woodbury"
    return None


def separable(Q, A, G, spec: ConeSpec) -> bool:
    """Host-side applicability check on concrete problem data."""
    if spec.soc_groups or spec.sdp_groups:
        return False
    Qt = _where_it_is(Q)
    if Qt.dim() != 2 or not _is_diagonal(Qt):
        return False
    if not _rows_have_one_nonzero(_where_it_is(A)):
        return False
    return equality_mode(Q, G) is not None


def separable_batch(Q, A, G, spec: ConeSpec) -> bool:
    """:func:`separable` for a stack: the pattern must hold for every
    instance (leading batch axis on Q and A; G stacked or shared)."""
    if spec.soc_groups or spec.sdp_groups:
        return False
    Qt = _where_it_is(Q)
    if Qt.dim() != 3 or not _is_diagonal(Qt):
        return False
    if not _rows_have_one_nonzero(_where_it_is(A)):
        return False
    return equality_mode(Q, G) is not None


def kktsolver_2x2_diag(Q, A, G, spec: ConeSpec, *, factor_dtype=None,
                       eq_mode="woodbury"):
    """2x2 solver with a diagonal Schur matrix (module docstring)."""
    n = Q.shape[-1]
    p = G.shape[-2]
    wd = Q.dtype
    fd = wd if factor_dtype is None else factor_dtype
    dev = Q.device
    finfo = torch.finfo(fd)
    if p and eq_mode not in ("disjoint", "woodbury"):
        raise ValueError(f"unknown eq_mode {eq_mode!r}")

    # column index + coefficient of each row's single nonzero
    cols = torch.argmax(torch.abs(A), dim=-1)
    coef = torch.gather(A, -1, cols[..., None])[..., 0].to(fd)
    P = (torch.nn.functional.one_hot(cols, n).to(fd).mT
         * (coef != 0).to(fd)[..., None, :])  # (..., n, m) incidence
    asq = coef * coef
    qdiag = torch.diagonal(Q, dim1=-2, dim2=-1).to(fd)
    G = G.to(fd)
    GT = G.mT
    ridge = 30 * finfo.eps

    def _spd_inv_factor(S, k):
        eye = torch.eye(k, dtype=fd, device=dev)
        return tri_inv(cholesky(
            S + (ridge * trace(S) / k)[..., None, None] * eye))

    def solve2x2gen(F, FinvT):
        # (FᵀF)⁻¹ is diagonal for R cones: F = diag(r_d) ⇒ rinv = r_d⁻²
        rinv = (1.0 / (F.r_d * F.r_d)).to(fd)
        mdiag = qdiag + mv(P, rinv * asq)
        if p:
            gamma = (torch.sum(mdiag, dim=-1) / n) / (
                sum_all(G * G) / p + finfo.tiny)
            gamma = torch.where(torch.isfinite(gamma) & (gamma > 0), gamma,
                                torch.ones_like(gamma))
            if eq_mode == "disjoint":
                minv_d = 1.0 / (mdiag + col(gamma) * torch.sum(G * G, dim=-2))

                def minv(x):
                    return minv_d * x

                ET = minv_d[..., None] * GT  # M̃⁻¹Gᵀ  (n, p)
            else:
                # M̃⁻¹ = D⁻¹ − D⁻¹Gᵀ K⁻¹ G D⁻¹,  K = γ⁻¹I + G D⁻¹ Gᵀ
                dinv = 1.0 / torch.clamp(mdiag, min=finfo.tiny)
                GD = G * dinv[..., None, :]  # G D⁻¹  (p, n)
                GDGt = GD @ GT  # (p, p)
                K = GDGt + torch.eye(p, dtype=fd, device=dev) / gamma[
                    ..., None, None]
                Lkinv = _spd_inv_factor(K, p)
                Kinv = Lkinv.mT @ Lkinv
                GDT = GD.mT

                def minv(x):
                    t = dinv * x
                    return t - mv(GDT, mv(Kinv, mv(G, t)))

                ET = GDT - GDT @ (Kinv @ GDGt)  # M̃⁻¹Gᵀ  (n, p)
            S = G @ ET  # G M̃⁻¹ Gᵀ  (p, p)
            Lsinv = _spd_inv_factor(0.5 * (S + S.mT), p)
        else:
            minv_d = 1.0 / mdiag

        def solve2x2(by, bw):
            by = by.to(fd)
            bw = bw.to(fd)
            if p:
                t = minv(by + col(gamma) * mv(GT, bw))
                b2 = mv(Lsinv.mT, mv(Lsinv, mv(G, t) - bw))
                return (t - mv(ET, b2)).to(wd), b2.to(wd)
            return (minv_d * by).to(wd), by[..., :0].to(wd)

        return solve2x2

    return solve2x2gen


def kktsolver_diag(Q, A, G, spec: ConeSpec, *, factor_dtype=None,
                   eq_mode="woodbury"):
    """3x3 KKT solver exploiting separable structure. Check applicability
    with :func:`separable` and pick ``eq_mode`` with :func:`equality_mode`
    on the host data first."""
    if spec.soc_groups or spec.sdp_groups:
        raise ValueError("kktsolver_diag supports R cones only")
    inner = functools.partial(kktsolver_2x2_diag, factor_dtype=factor_dtype,
                              eq_mode=eq_mode)
    return pivot(inner, factor_dtype=factor_dtype)(Q, A, G, spec)
