"""Cholesky factorization and triangular solves — the solver's hot kernel.

Counterpart of ``conicip_tpu/ops/cholesky.py``. :func:`cholesky`
dispatches on the tensor's device through
:func:`~conicip_tpu_torch.ops.cholesky_kernel.cholesky_factor`: the
hand-written CUDA kernel on a CUDA tensor (its f64 or its f32 entry, by
the dtype factored; its batched entry for a stack of matrices), the plain
PyTorch version on the CPU. Every function takes (..., n, n).
``factor_dtype`` casts the matrix first, so the factor comes back in that
dtype. :func:`tri_inv` dispatches alike through
:func:`~conicip_tpu_torch.ops.cholesky_kernel.tri_inverse`: the kernel's
inverse entries on a CUDA tensor, where the JAX package leaves the inverse
to XLA's triangular solve; that solve against the identity on the CPU.
"""

from __future__ import annotations

import torch

from .cholesky_kernel import cholesky_factor, tri_inverse

__all__ = ["cholesky", "tri_inv", "cho_solve", "CholFactor"]


def cholesky(M: torch.Tensor, factor_dtype=None, skip=None, out=None
             ) -> torch.Tensor:
    """Lower-triangular Cholesky factor, optionally in another precision;
    non-finite where M is not SPD. ``skip`` and ``out`` make it the
    predicated factor of :func:`cholesky_factor`: the flagged matrices keep
    ``out``'s."""
    if factor_dtype is not None and factor_dtype != M.dtype:
        M = M.to(factor_dtype)
    return cholesky_factor(M.contiguous(), skip, out)


def tri_inv(L: torch.Tensor) -> torch.Tensor:
    """Explicit lower-triangular inverse L⁻¹: every later back-solve becomes
    two matrix-vector products. Its strict upper triangle is zero."""
    return tri_inverse(L.contiguous())


def cho_solve(L: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Solve (L Lᵀ) x = b given the lower Cholesky factor L (..., n, n);
    b is a vector (..., n) or, with one more dim than that, a matrix of
    right-hand sides (..., n, k)."""
    out_dtype = b.dtype
    b = b.to(L.dtype)
    col = b.dim() == L.dim() - 1
    if col:
        b = b[..., None]
    y = torch.linalg.solve_triangular(L, b, upper=False)
    x = torch.linalg.solve_triangular(L.mT, y, upper=True)
    return (x[..., 0] if col else x).to(out_dtype)


class CholFactor:
    """A factor bundled with its solve."""

    def __init__(self, M: torch.Tensor, factor_dtype=None):
        self.L = cholesky(M, factor_dtype)

    def solve(self, b: torch.Tensor) -> torch.Tensor:
        return cho_solve(self.L, b)
