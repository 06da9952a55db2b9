"""Rank-repairing preprocessor.

Counterpart of ``conicip_tpu/preprocess.py``. Rank detection is a one-time
cost outside the iteration, so it runs on the host in numpy (a
column-pivoted dense QR: the C++ one of :mod:`conicip_tpu_torch.native`,
or scipy's when that cannot be built).

Guarantees enforced before calling the IPM core:

- primal equalities:  rank(G) == size(G, 1)  (redundant rows dropped)
- dual system:        rank([Q Aᵀ Gᵀ]) == n   (deficient coordinates get a
  unit diagonal regularizer added to Q)

Inconsistent systems short-circuit to an ``Infeasible`` solution with
NaN-filled fields, and dropped equality duals are re-inflated with zeros.
"""

from __future__ import annotations

from typing import Sequence, Tuple

import numpy as np
import torch
from scipy.linalg import qr as _pivoted_qr

from . import native
from .kkt.diag import _host
from .solver.state import Solution

__all__ = ["imcols", "preprocess_conic_ip"]


def _to_dense_np(X) -> np.ndarray:
    return np.asarray(_host(X), dtype=np.float64)


def imcols(A, b, eps: float = 1e-8) -> Tuple[np.ndarray, bool]:
    """Independent-row detection + consistency check for ``A x = b``.

    Returns ``(R, consistent)`` where ``R`` is a sorted index array of
    independent rows of A and ``consistent`` says whether the full system
    is solvable, relative to the right-hand side's scale. Uses a
    column-pivoted QR of Aᵀ after normalising by ‖A‖.
    """
    A = _to_dense_np(A)
    b = _to_dense_np(b)
    if A.size == 0:
        return np.zeros(0, dtype=int), True

    nA = np.linalg.norm(A)
    A = A / nA
    b = b / nA

    res = native.pivoted_qr_rank(A.T)
    if res is not None:
        diag_R, piv = res
    else:
        _, Rm, piv = _pivoted_qr(A.T, mode="economic", pivoting=True)
        n_r = min(Rm.shape)
        diag_R = np.abs(np.diag(Rm)[:n_r])
    keep = piv[np.nonzero(diag_R > eps)[0]]
    R = np.sort(keep)

    if R.size == 0:
        return np.zeros(0, dtype=int), True

    x, *_ = np.linalg.lstsq(A[R, :], b[R], rcond=None)
    scale = max(1.0, float(np.linalg.norm(b, ord=np.inf)))
    consistent = np.linalg.norm(A @ x - b, ord=np.inf) < eps * scale
    return R, bool(consistent)


def preprocess_conic_ip(
    Q,
    c,
    A,
    b,
    cone_dims: Sequence[Tuple[str, int]],
    G=None,
    d=None,
    *,
    verbose: bool = False,
    **options,
) -> Solution:
    """``conic_ip`` with rank repair. ``options`` go to
    :func:`~conicip_tpu_torch.conic_ip` (``device``, ``dtype``, ...); the
    solution's ``y``, ``w``, ``v`` are tensors on the solve's device."""
    from .solver import conic_ip

    Q = _to_dense_np(Q)
    c = _to_dense_np(c)
    A = _to_dense_np(A)
    b = _to_dense_np(b)
    n = c.shape[0]
    m = A.shape[0]
    G = _to_dense_np(G) if G is not None else np.zeros((0, n))
    d = _to_dense_np(d) if d is not None else np.zeros(0)
    p = G.shape[0]
    like = dict(dtype=options.get("dtype") or torch.float64,
                device=torch.device(options.get("device", "cuda")))

    if verbose:
        print("\n > CONICIP-TPU-TORCH PREPROCESSOR v0.1\n")

    IP, pconsistent = imcols(G, d)
    ID, dconsistent = imcols(np.hstack([Q, A.T, G[IP, :].T]), c)

    if not (pconsistent and dconsistent):
        nan = float("nan")
        return Solution(
            y=torch.full((n,), nan, **like),
            w=torch.full((p,), nan, **like),
            v=torch.full((m,), nan, **like),
            status="Infeasible", Iter=0, Mu=nan, prFeas=nan, duFeas=nan,
            muFeas=nan, pobj=nan, dobj=nan,
        )

    if verbose and len(IP) != p:
        print(f"   - Removing {p - len(IP)} redundant primal constraints")
    if verbose and len(ID) != n:
        print(f"   - Augmenting {n - len(ID)} dual constraints")
    if verbose and len(ID) == n and len(IP) == p:
        print("   - No changes made")

    z = np.ones(n)
    z[ID] = 0.0
    Qz = Q + np.diag(z)

    sol = conic_ip(
        Qz, c, A, b, cone_dims, G[IP, :], d[IP], verbose=verbose, **options
    )

    # re-inflate equality duals with zeros for the dropped rows
    w = torch.zeros(p, dtype=sol.w.dtype, device=sol.w.device)
    w[torch.as_tensor(IP, dtype=torch.long, device=sol.w.device)] = sol.w
    sol.w = w
    return sol
