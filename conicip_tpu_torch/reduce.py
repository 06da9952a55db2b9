"""Null-space elimination of equality constraints.

Counterpart of ``conicip_tpu/reduce.py`` (host numpy and scipy, f64). The
default KKT path factors equalities through a second Schur complement
``S = G M̃⁻¹ Gᵀ``, which squares the conditioning a low-precision factor
has to survive. Eliminating ``Gy = d`` once at setup with an orthonormal
null-space basis turns the solve into the p = 0 path, makes ``Gy = d`` hold
to machine precision by construction, and shrinks the per-iteration system
from an (n, p) saddle to n − p.

The transform (one-time, on the host):

    Gᵀ = Qr·R (complete QR),  Q1 = Qr[:, :r],  Z = Qr[:, r:]  (GZ = 0)
    y  = y0 + Z·x  with  y0 = Q1·R⁻ᵀd  (min-norm particular solution)

    minimize ½ xᵀ(ZᵀQZ)x − (Zᵀ(c − Qy0))ᵀ x
    s.t.     (AZ) x ≥_K b − A y0

Recovery: ``y = y0 + Zx``; cone duals ``v`` unchanged; equality duals from
stationarity ``Gᵀw = c − Qy + Aᵀv`` via the same QR factors (least squares;
exact when the reduced problem is solved exactly). Certificate rays map
through unchanged: a reduced unbounded ray x gives y = Zx with Gy = 0, and
a reduced Farkas pair (v) extends with the least-squares w.

Rank-deficient G is handled by column-pivoted rank detection (consistent
rows kept, as the preprocessor does); inconsistent equalities are flagged
and the caller returns an Infeasible solution.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Callable, Optional

import numpy as np
import scipy.linalg

__all__ = ["EqualityReduction", "eliminate_equalities", "EqualityBasis",
           "equality_basis"]


@dataclass
class EqualityBasis:
    """QR-derived bases of one equality system ``G``, reusable across a
    batch of instances that share G: the one-time host QR amortizes over
    the whole batch, and every transform below is a batched product.

    ``Z`` (n, n−r): orthonormal null-space basis;  ``Q1`` (n, r), ``R``
    (r, r), ``piv``: the rank-r column-pivoted QR factors of Gᵀ.
    """

    Z: np.ndarray
    Q1: np.ndarray
    R: np.ndarray  # leading r x r block, upper triangular
    piv: np.ndarray
    p: int
    n: int

    @property
    def rank(self) -> int:
        return self.R.shape[0]

    def particular(self, d: np.ndarray) -> np.ndarray:
        """Min-norm ``y0`` with ``G y0 = d`` (solve ``Rᵀ t = d[piv][:r]``,
        ``y0 = Q1 t``) — batched over a leading axis of d."""
        r = self.rank
        d = np.asarray(d, np.float64)
        if not r:
            return np.zeros(d.shape[:-1] + (self.n,))
        dp = d[..., self.piv[:r]]
        if d.ndim == 1:
            t = scipy.linalg.solve_triangular(self.R.T, dp, lower=True,
                                              check_finite=False)
            return self.Q1 @ t
        t = scipy.linalg.solve_triangular(self.R.T, dp.T, lower=True,
                                          check_finite=False)
        return t.T @ self.Q1.T

    def solve_gt(self, rhs: np.ndarray) -> np.ndarray:
        """Least-squares ``Gᵀ w = rhs`` (solve ``R t = Q1ᵀ rhs``, scatter
        through the pivots) — batched over a leading axis of rhs."""
        r = self.rank
        rhs = np.asarray(rhs, np.float64)
        w = np.zeros(rhs.shape[:-1] + (self.p,))
        if r:
            if rhs.ndim == 1:
                t = scipy.linalg.solve_triangular(
                    self.R, self.Q1.T @ rhs, lower=False,
                    check_finite=False,  # NaN rows (failed instances in a
                    # batch) must propagate NaN duals, not raise
                )
            else:
                t = scipy.linalg.solve_triangular(
                    self.R, (rhs @ self.Q1).T, lower=False,
                    check_finite=False,
                ).T
            w[..., self.piv[:r]] = t
        return w


def equality_basis(G, *, rank_tol: float = 1e-10) -> Optional[EqualityBasis]:
    """Column-pivoted QR of ``Gᵀ`` packaged for reuse (None when p == 0)."""
    G = np.asarray(G, np.float64)
    p, n = G.shape
    if p == 0:
        return None
    Qr, R, piv = scipy.linalg.qr(G.T, mode="full", pivoting=True)
    diag = np.abs(np.diagonal(R))
    thresh = rank_tol * (diag[0] if diag.size and diag[0] > 0 else 1.0)
    r = int(np.sum(diag > thresh))
    return EqualityBasis(Z=Qr[:, r:], Q1=Qr[:, :r], R=R[:r, :r],
                         piv=np.asarray(piv), p=p, n=n)


@dataclass
class EqualityReduction:
    """Reduced problem data plus the recovery maps."""

    Q: np.ndarray
    c: np.ndarray
    A: np.ndarray
    b: np.ndarray
    y0: np.ndarray  # particular solution, G y0 = d
    Z: np.ndarray  # orthonormal null-space basis of G
    consistent: bool
    recover_w: Callable[[np.ndarray, np.ndarray], np.ndarray]
    recover_w_cert: Callable[[np.ndarray], np.ndarray]

    def recover_y(self, x: np.ndarray) -> np.ndarray:
        return self.y0 + self.Z @ x


def eliminate_equalities(
    Q, c, A, b, G, d, *, rank_tol: float = 1e-10
) -> Optional[EqualityReduction]:
    """Build the null-space reduction, or None when G is empty/full-rank-n.

    Returns an :class:`EqualityReduction` with ``consistent=False`` when
    ``Gy = d`` has no solution (the caller returns an Infeasible status,
    as the preprocessor does).
    """
    Q = np.asarray(Q, np.float64)
    c = np.asarray(c, np.float64)
    A = np.asarray(A, np.float64)
    b = np.asarray(b, np.float64)
    G = np.asarray(G, np.float64)
    d = np.asarray(d, np.float64)
    p, n = G.shape
    if p == 0:
        return None

    # Column-pivoted QR of Gᵀ for rank detection + orthonormal bases.
    Qr, R, piv = scipy.linalg.qr(G.T, mode="full", pivoting=True)
    diag = np.abs(np.diagonal(R))
    thresh = rank_tol * (diag[0] if diag.size and diag[0] > 0 else 1.0)
    r = int(np.sum(diag > thresh))
    Q1 = Qr[:, :r]
    Z = Qr[:, r:]  # (n, n - r), orthonormal, G Z = 0

    # Min-norm particular solution via the rank-r leading system:
    # Gᵀ[:, piv] = Qr R  →  G[piv, :] = Rᵀ Qrᵀ;  solve Rᵀ[:r,:r] t = d[piv][:r]
    t = scipy.linalg.solve_triangular(
        R[:r, :r].T, d[piv][:r], lower=True
    ) if r else np.zeros(0)
    y0 = Q1 @ t
    consistent = bool(
        np.linalg.norm(G @ y0 - d) <= 1e-8 * (1.0 + np.linalg.norm(d))
    )

    Qy0 = Q @ y0
    red_Q = Z.T @ Q @ Z
    red_c = Z.T @ (c - Qy0)
    red_A = A @ Z
    red_b = b - A @ y0

    def solve_gt(rhs: np.ndarray) -> np.ndarray:
        """Least-squares solve of Gᵀw = rhs via the QR factors."""
        t = scipy.linalg.solve_triangular(R[:r, :r], Q1.T @ rhs, lower=False)
        w = np.zeros(p)
        w[piv[:r]] = t
        return w

    def recover_w(y: np.ndarray, v: np.ndarray) -> np.ndarray:
        """Least-squares equality duals from Qy + Gᵀw − Aᵀv = c."""
        return solve_gt(c - Q @ y + (A.T @ v if A.size else 0.0))

    def recover_w_cert(v: np.ndarray) -> np.ndarray:
        """Farkas-certificate duals: least-squares Gᵀw = Aᵀv."""
        return solve_gt(A.T @ v if A.size else np.zeros(n))

    return EqualityReduction(
        Q=red_Q, c=red_c, A=red_A, b=red_b, y0=y0, Z=Z,
        consistent=consistent, recover_w=recover_w,
        recover_w_cert=recover_w_cert,
    )
