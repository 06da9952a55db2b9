"""Plain reference for the nearest positive semidefinite matrix.

    minimize  ½‖Y‖²_F − ⟨C, Y⟩  over  Y ⪰ 0

is ½‖Y − C‖²_F up to a constant, so its solution is the projection of C
onto the PSD cone, Y* = V·max(Λ, 0)·Vᵀ for C = VΛVᵀ (Higham, Linear
Algebra Appl. 103 (1988) 103-118), and the cone's multiplier is
Z* = Y* − C = V·max(−Λ, 0)·Vᵀ. Vectors are packed as the upper triangle,
row by row, off-diagonal entries scaled by √2, so that the packed dot
product is the trace inner product. Shares no code with the program under
test; runs in the dtype it is given (float64 as the reference, float32 as
the check's control).
"""

from __future__ import annotations

import math

import torch

__all__ = ["order", "vecm", "mat", "solve"]


def order(t: int) -> int:
    """k with k(k+1)/2 == t."""
    k = (math.isqrt(8 * t + 1) - 1) // 2
    if k * (k + 1) // 2 != t:
        raise ValueError(f"{t} is not a triangular number")
    return k


def _packing(k, device):
    rows, cols = torch.triu_indices(k, k, device=device)
    scale = torch.where(rows == cols, 1.0, math.sqrt(2.0)).to(torch.float64)
    return rows, cols, scale


def vecm(X: torch.Tensor) -> torch.Tensor:
    """(..., k, k) symmetric → (..., k(k+1)/2)."""
    rows, cols, scale = _packing(X.shape[-1], X.device)
    return X[..., rows, cols] * scale.to(X.dtype)


def mat(x: torch.Tensor) -> torch.Tensor:
    """(..., k(k+1)/2) → (..., k, k) symmetric."""
    k = order(x.shape[-1])
    rows, cols, scale = _packing(k, x.device)
    X = x.new_zeros(x.shape[:-1] + (k, k))
    vals = x / scale.to(x.dtype)
    X[..., rows, cols] = vals
    X[..., cols, rows] = vals
    return X


def solve(c: torch.Tensor):
    """(y, z): the packed projection of mat(c) onto the PSD cone and the
    cone's multiplier, for a stack of packed c."""
    C = mat(c)
    lam, V = torch.linalg.eigh(C)
    pos = (V * lam.clamp(min=0).unsqueeze(-2)) @ V.transpose(-1, -2)
    neg = (V * (-lam).clamp(min=0).unsqueeze(-2)) @ V.transpose(-1, -2)
    return vecm(pos), vecm(neg)
