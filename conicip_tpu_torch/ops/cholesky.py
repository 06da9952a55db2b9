"""Cholesky factorization and triangular solves — the solver's hot kernel.

Counterpart of ``conicip_tpu/ops/cholesky.py`` on its full-precision path.
:func:`cholesky` dispatches on the tensor's device through
:func:`~conicip_tpu_torch.ops.cholesky_kernel.cholesky_factor`: the
hand-written CUDA kernel on a CUDA tensor, the plain PyTorch version on the
CPU. :func:`tri_inv` stays a library triangular solve, as the JAX package
leaves it to XLA.
"""

from __future__ import annotations

import torch

from .cholesky_kernel import cholesky_factor

__all__ = ["cholesky", "tri_inv", "cho_solve"]


def cholesky(M: torch.Tensor) -> torch.Tensor:
    """Lower-triangular Cholesky factor; non-finite where M is not SPD."""
    return cholesky_factor(M.contiguous())


def tri_inv(L: torch.Tensor) -> torch.Tensor:
    """Explicit lower-triangular inverse L⁻¹: every later back-solve becomes
    two matrix-vector products."""
    eye = torch.eye(L.shape[0], dtype=L.dtype, device=L.device)
    return torch.linalg.solve_triangular(L, eye, upper=False)


def cho_solve(L: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Solve (L Lᵀ) x = b given the lower Cholesky factor L."""
    out_dtype = b.dtype
    b = b.to(L.dtype)
    col = b.dim() == 1
    if col:
        b = b[:, None]
    y = torch.linalg.solve_triangular(L, b, upper=False)
    x = torch.linalg.solve_triangular(L.T, y, upper=True)
    return (x[:, 0] if col else x).to(out_dtype)
