"""Batched small-matrix linear algebra with JAX's failure semantics.

The S-cone code factors and decomposes stacks of d x d matrices. In the JAX
package ``jnp.linalg.cholesky``, ``eigh`` and ``svd`` return NaN for a
batch entry they cannot handle, and the IPM reads that NaN on the device
(its non-finite guard). :func:`safe_eigh`, :func:`safe_eigvalsh` and
:func:`safe_svd` keep that behaviour on two routes, chosen by the device
of the tensor they are given:

- on the card, the hand-written Jacobi kernels of ``ops/jacobi_kernel.py``
  (``csrc/jacobi.cu``), one launch per stack: an entry that is not finite
  or does not converge comes back NaN from the kernel itself, nothing is
  read back to the host and nothing raises. A tensor the kernels do not
  take (another dtype, not square) raises; there is no other route.
- on the CPU, the plain versions :func:`eigh_plain`, :func:`eigvalsh_plain`
  and :func:`svd_plain` (``torch.linalg``): before a decomposition every
  non-finite batch entry is replaced by the identity and its results are
  NaN-filled afterwards; and when the library gives up on a finite entry
  (an iteration that does not converge raises for the whole stack), the
  stack is halved until the entry stands alone and is NaN-filled, so one
  instance of a stack cannot take down the rest.

(The batched Cholesky is ``ops.cholesky_kernel.cholesky_plain``:
``cholesky_ex`` without its check, NaN-filled where it fails.)

The second half are the products and reductions of the solve path written
for an optional stack of instances: vectors are (..., n), matrices
(..., m, n), per-instance scalars (...,), and nothing reduces across the
leading dims, so a NaN instance cannot reach its neighbours. Without
leading dims each is the one call the single solve always made.
"""

from __future__ import annotations

import torch

from . import jacobi_kernel

__all__ = ["nan_where_bad", "safe_eigh", "safe_eigvalsh", "safe_svd",
           "eigh_plain", "eigvalsh_plain", "svd_plain", "mv", "dot", "trace",
           "sum_all", "col", "bcast"]


def mv(A: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """Matrix-vector product over leading batch dims: A (..., m, n) against
    x (..., n). Without batch dims it is the plain ``A @ x``."""
    if x.dim() == 1 and A.dim() == 2:
        return A @ x
    return torch.matmul(A, x.unsqueeze(-1)).squeeze(-1)


def dot(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Inner product along the last axis; ``torch.dot`` for two non-empty
    vectors. Two empty ones (a spec with no equalities) sum to 0 on the
    device: ``torch.dot`` copies its 0 from host memory there, a node the
    body of a conditional graph node cannot hold (solver/graph.py)."""
    if a.dim() == 1 and b.dim() == 1 and a.numel():
        return torch.dot(a, b)
    return torch.sum(a * b, dim=-1)


def trace(M: torch.Tensor) -> torch.Tensor:
    """Trace over the last two axes."""
    if M.dim() == 2:
        return torch.trace(M)
    return torch.diagonal(M, dim1=-2, dim2=-1).sum(-1)


def sum_all(M: torch.Tensor) -> torch.Tensor:
    """Sum of each matrix's entries (the last two axes)."""
    if M.dim() == 2:
        return torch.sum(M)
    return torch.sum(M, dim=(-2, -1))


def col(s: torch.Tensor) -> torch.Tensor:
    """A per-instance scalar (...,) shaped to scale vectors (..., n)."""
    return s.unsqueeze(-1) if s.dim() else s


def bcast(s: torch.Tensor, like: torch.Tensor) -> torch.Tensor:
    """A per-instance value (...,) with trailing unit dims up to ``like``'s
    rank, for ``torch.where`` and products against per-instance tensors."""
    return s.reshape(s.shape + (1,) * (like.dim() - s.dim()))


def nan_where_bad(bad: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """``x`` with the batch entries where ``bad`` (shape ``x.shape[:bad.dim()]``)
    holds set to NaN."""
    return torch.where(bad.reshape(bad.shape + (1,) * (x.dim() - bad.dim())),
                       torch.nan, x)


def _finite_or_identity(A: torch.Tensor):
    bad = ~torch.isfinite(A).all(dim=-1).all(dim=-1)
    eye = torch.eye(A.shape[-1], dtype=A.dtype, device=A.device)
    return bad, torch.where(bad[..., None, None], eye, A)


def _per_entry(op, A: torch.Tensor):
    """``op(A)`` (a tuple of tensors) for a stack (..., d, d) of finite
    matrices, surviving entries the library fails on (module docstring)."""
    try:
        return op(A)
    except torch.linalg.LinAlgError:
        pass
    flat = A.reshape((-1,) + A.shape[-2:])
    if flat.shape[0] == 1:
        eye = torch.eye(A.shape[-1], dtype=A.dtype, device=A.device)
        outs = tuple(torch.full_like(o, torch.nan) for o in op(eye[None]))
    else:
        half = flat.shape[0] // 2
        outs = tuple(torch.cat(pair) for pair in zip(
            _per_entry(op, flat[:half]), _per_entry(op, flat[half:])))
    return tuple(o.reshape(A.shape[:-2] + o.shape[1:]) for o in outs)


def eigh_plain(A: torch.Tensor):
    """Plain version of :func:`safe_eigh` (``torch.linalg.eigh``)."""
    bad, A = _finite_or_identity(A)
    w, U = _per_entry(lambda X: tuple(torch.linalg.eigh(X)), A)
    return nan_where_bad(bad, w), nan_where_bad(bad, U)


def eigvalsh_plain(A: torch.Tensor) -> torch.Tensor:
    """Plain version of :func:`safe_eigvalsh` (``torch.linalg.eigvalsh``)."""
    bad, A = _finite_or_identity(A)
    (w,) = _per_entry(lambda X: (torch.linalg.eigvalsh(X),), A)
    return nan_where_bad(bad, w)


def svd_plain(A: torch.Tensor):
    """Plain version of :func:`safe_svd` (``torch.linalg.svd``)."""
    bad, A = _finite_or_identity(A)
    U, sig = _per_entry(lambda X: torch.linalg.svd(X)[:2], A)
    return nan_where_bad(bad, U), nan_where_bad(bad, sig)


def safe_eigh(A: torch.Tensor):
    """``(w, U)`` of symmetric (..., d, d), ascending; NaN where A is not
    finite or the decomposition fails."""
    if A.device.type == "cpu":
        return eigh_plain(A)
    return jacobi_kernel.eigh(A.contiguous())


def safe_eigvalsh(A: torch.Tensor) -> torch.Tensor:
    """Eigenvalues of symmetric (..., d, d), ascending; NaN where A is not
    finite or the decomposition fails."""
    if A.device.type == "cpu":
        return eigvalsh_plain(A)
    return jacobi_kernel.eigvalsh(A.contiguous())


def safe_svd(A: torch.Tensor):
    """``(U, σ)`` of (..., d, d), σ descending; NaN where A is not finite or
    the decomposition fails."""
    if A.device.type == "cpu":
        return svd_plain(A)
    return jacobi_kernel.svd(A.contiguous())
