"""Batched small-matrix linear algebra with JAX's failure semantics.

The S-cone code factors and decomposes stacks of d x d matrices. In the JAX
package ``jnp.linalg.cholesky``, ``eigh`` and ``svd`` return NaN for a
batch entry they cannot handle, and the IPM reads that NaN on the device
(its non-finite guard). ``torch.linalg.cholesky`` raises instead, and
``eigh``/``svd`` may raise on non-finite input. These wrappers keep the
JAX behaviour: before a decomposition every non-finite batch entry is
replaced by the identity and its results are NaN-filled afterwards. (The
batched Cholesky is ``ops.cholesky_kernel.cholesky_plain``: ``cholesky_ex``
without its check, NaN-filled where it fails.)
"""

from __future__ import annotations

import torch

__all__ = ["nan_where_bad", "safe_eigh", "safe_eigvalsh", "safe_svd"]


def nan_where_bad(bad: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """``x`` with the batch entries where ``bad`` (shape ``x.shape[:bad.dim()]``)
    holds set to NaN."""
    return torch.where(bad.reshape(bad.shape + (1,) * (x.dim() - bad.dim())),
                       torch.nan, x)


def _finite_or_identity(A: torch.Tensor):
    bad = ~torch.isfinite(A).all(dim=-1).all(dim=-1)
    eye = torch.eye(A.shape[-1], dtype=A.dtype, device=A.device)
    return bad, torch.where(bad[..., None, None], eye, A)


def safe_eigh(A: torch.Tensor):
    """``(w, U)`` of symmetric (..., d, d), ascending; NaN where A is not finite."""
    bad, A = _finite_or_identity(A)
    w, U = torch.linalg.eigh(A)
    return nan_where_bad(bad, w), nan_where_bad(bad, U)


def safe_eigvalsh(A: torch.Tensor) -> torch.Tensor:
    """Eigenvalues of symmetric (..., d, d), ascending; NaN where A is not finite."""
    bad, A = _finite_or_identity(A)
    return nan_where_bad(bad, torch.linalg.eigvalsh(A))


def safe_svd(A: torch.Tensor):
    """``(U, σ)`` of (..., d, d), σ descending; NaN where A is not finite."""
    bad, A = _finite_or_identity(A)
    U, sig, _ = torch.linalg.svd(A)
    return nan_where_bad(bad, U), nan_where_bad(bad, sig)
