"""Diagonal + low-rank Schur KKT solver.

Counterpart of ``conicip_tpu/kkt/lowrank.py``. For problems whose
inequality matrix is ``A = [I_n; A_s]`` (bound rows for every R coordinate
plus a small block of general rows tied to SOC cones) with diagonal ``Q``,
the Schur matrix is diagonal plus low rank:

    M = diag(Q) + diag(1/r_d²) + A_sᵀ (F⁻²)_soc A_s + γ GᵀG
      = D + U Kb Uᵀ,   U = [A_sᵀ, Gᵀ]  (n, r),  r = m_s + p

with ``Kb = blockdiag((F⁻²)_soc, γI)``, both blocks in closed form from the
NT scaling's (d, u, α) parameters. Woodbury reduces every ``M⁻¹`` apply to
diagonal scalings, thin products against the constant U, and one r x r
factorization per iteration in place of the dense (n, n) one. Equalities
use the same exact augmented-saddle recovery as ``kkt/schur.kktsolver_2x2``
(γ-augmented M, second Schur on G: no regularization error), with a second
factor of order p.

Working dtype only. Both factors go through ``ops/cholesky.py``, so on CUDA
they run the hand-written kernel at orders r and p, never n. Applicability
is checked on host data by :func:`lowrank_applicable`; ``conic_ip`` does
not select this backend by itself (the batched solve does, as its f64
finisher behind f32 factors). Operands may carry a stack of instances as
leading dims; the two factors of a stack run the kernel's batched entry.
"""

from __future__ import annotations

import functools

import numpy as np
import torch

from ..cones.scaling import _index
from ..cones.spec import ConeSpec
from ..ops.batched import col, mv, sum_all
from ..ops.cholesky import cholesky, tri_inv
from ..ops.control import takes_device_loop
from .diag import _is_diagonal, _where_it_is
from .pivot import pivot

__all__ = ["kktsolver_lowrank", "lowrank_applicable", "lowrank_kktsolver"]


def lowrank_applicable(Q, A, G, spec: ConeSpec, max_rank: int = 160) -> bool:
    """Host-side check: no SDP cones, ``nr == n`` with the R rows of A
    equal to I, diagonal Q, full-row-rank G, and a small total low-rank
    dimension (SOC rows + equality rows ≤ ``max_rank``)."""
    if spec.sdp_groups or not spec.soc_groups or not spec.nr:
        return False
    Qt = _where_it_is(Q)
    At = _where_it_is(A)
    n = Qt.shape[-1]
    if spec.nr != n or At.shape[-1] != n:
        return False
    m_s = At.shape[-2] - n
    p = 0 if G is None else np.shape(G)[-2]
    if m_s <= 0 or m_s + p > max_rank:
        return False
    if p:
        # rank-deficient or inconsistent equality systems keep the
        # elimination path, whose host-side rank repair and consistency
        # check the direct saddle lacks
        Gt = _where_it_is(G).to(torch.float64)
        if bool((torch.linalg.matrix_rank(Gt) < p).any()):
            return False
    # R rows must come first and equal I
    r_idx = np.asarray(spec.r_idx)
    if r_idx.size != n or not np.array_equal(r_idx, np.arange(n)):
        return False
    eye = torch.eye(n, dtype=At.dtype, device=At.device)
    if not bool((At[..., :n, :] == eye).all()):
        return False
    if not _is_diagonal(Qt):
        return False
    return not bool((torch.diagonal(Qt, dim1=-2, dim2=-1) < 0).any())


@functools.lru_cache(maxsize=None)
def _soc_index(spec: ConeSpec, n: int, dev) -> tuple:
    """Per SOC group its (k, dim) rows relative to the SOC section (after
    the n bound rows), on a device: made by the first solve of a
    configuration, eagerly, so that a captured level-1 call
    (solver/graph.py) copies nothing from the host."""
    return tuple(_index(g.idx - n, dev) for g in spec.soc_groups)


def _soc_sq_dense(soc_params, idxs, K):
    """Write blockdiag(F²) (or F⁻² from the inverse scaling's parameters)
    over the SOC section onto the leading block of ``K``:
    F² = diag(d²) + α(v₁uᵀ + uv₁ᵀ) + α²(uᵀu)uuᵀ, v₁ = d∘u. ``idxs`` holds
    per cone group the (k, dim) rows relative to the SOC section, on K's
    device; one scatter per group, whatever its count."""
    for ix, sc_ in zip(idxs, soc_params):
        v1 = sc_.d * sc_.u
        s_uu = torch.sum(sc_.u * sc_.u, dim=-1)
        blk = (
            torch.diag_embed(sc_.d * sc_.d)
            + sc_.alpha[..., None, None]
            * (v1[..., :, None] * sc_.u[..., None, :]
               + sc_.u[..., :, None] * v1[..., None, :])
            + (sc_.alpha * sc_.alpha * s_uu)[..., None, None]
            * sc_.u[..., :, None] * sc_.u[..., None, :]
        )  # (..., k, dim, dim)
        K[..., ix[:, :, None], ix[:, None, :]] = blk
    return K


def kktsolver_lowrank(Q, A, G, spec: ConeSpec):
    """2x2 solver factory (wrapped by :func:`pivot` in
    :func:`lowrank_kktsolver`); module docstring for the math."""
    n = Q.shape[-1]
    m_s = A.shape[-2] - n
    p = G.shape[-2]
    bs = Q.shape[:-2]
    wd, dev = Q.dtype, Q.device
    finfo = torch.finfo(wd)
    qdiag = torch.diagonal(Q, dim1=-2, dim2=-1)
    A_s = A[..., n:, :]  # (m_s, n), constant
    GT = G.mT
    U = torch.cat([A_s.mT, GT], dim=-1) if p else A_s.mT  # (n, r)
    UT = U.mT.contiguous()
    r = m_s + p
    ridge = 30.0 * finfo.eps
    eq_diag = torch.arange(m_s, r, device=dev)
    soc_idx = _soc_index(spec, n, dev)

    def _equilibrated_inv_factor(T, k):
        scale = torch.rsqrt(torch.clamp(
            torch.diagonal(T, dim1=-2, dim2=-1), min=finfo.tiny))
        Ts = T * scale[..., :, None] * scale[..., None, :]
        L = cholesky(Ts + ridge * torch.eye(k, dtype=wd, device=dev))
        return tri_inv(L), scale

    def _apply_inv(Linv, scale, x):
        # T⁻¹x = S L⁻ᵀ L⁻¹ S x with S the equilibration scale; x is a
        # vector (..., k) or a matrix (..., k, j)
        if x.dim() == scale.dim():
            return scale * mv(Linv.mT, mv(Linv, scale * x))
        s = scale[..., None]
        return s * (Linv.mT @ (Linv @ (s * x)))

    def solve2x2gen(F, FinvT):
        winv = 1.0 / (F.r_d * F.r_d)  # (n,)
        D = qdiag + winv
        if p:
            gamma = (torch.sum(D, dim=-1) / n) / (
                sum_all(G * G) / p + finfo.tiny)
            gamma = torch.where(torch.isfinite(gamma) & (gamma > 0), gamma,
                                torch.ones_like(gamma))
        # Kb⁻¹ = blockdiag((F²)_soc, (1/γ) I_p)
        Kinv = _soc_sq_dense(F.soc, soc_idx,
                             torch.zeros(*bs, r, r, dtype=wd, device=dev))
        if p:
            Kinv[..., eq_diag, eq_diag] = 1.0 / col(gamma)
        Dinv = 1.0 / D
        UD = U * Dinv[..., None]  # D⁻¹U  (n, r)
        T = Kinv + UT @ UD  # (r, r), SPD
        Linv, dscale = _equilibrated_inv_factor(0.5 * (T + T.mT), r)

        def Minv(x):
            # Woodbury: M̃⁻¹x = D⁻¹x − D⁻¹U T⁻¹ UᵀD⁻¹x; x a vector (..., n)
            # or a matrix (..., n, j)
            if x.dim() == Dinv.dim():
                return Dinv * x - mv(UD, _apply_inv(Linv, dscale,
                                                    mv(UD.mT, x)))
            return Dinv[..., None] * x - UD @ _apply_inv(Linv, dscale,
                                                         UD.mT @ x)

        if p:
            S = G @ Minv(GT)  # p×p SPD
            Lsinv, sscale = _equilibrated_inv_factor(0.5 * (S + S.mT), p)

        def solve(by, bw):
            if p:
                t = Minv(by + col(gamma) * mv(GT, bw))
                b2 = _apply_inv(Lsinv, sscale, mv(G, t) - bw)
                return t - Minv(mv(GT, b2)), b2
            return Minv(by), by[..., :0]

        return solve

    return solve2x2gen


@functools.lru_cache(maxsize=None)
def lowrank_kktsolver():
    """The 3x3 factory (pivot-adapted), one object per process."""
    return takes_device_loop(pivot(kktsolver_lowrank))
