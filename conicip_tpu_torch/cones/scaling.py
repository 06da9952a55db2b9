"""Nesterov-Todd scaling operators, R part.

Counterpart of ``conicip_tpu/cones/scaling.py``. On R cones the NT scaling
is diagonal, ``F = diag(r_d)`` with ``r_d = sqrt(s / z)``, and is never
materialized: applying F (or Fᵀ = F, F⁻ᵀ = diag(1 / r_d)) to a vector or
to the rows of a matrix is one elementwise product. The ``soc`` and ``sdp``
fields keep the reference's structure and stay empty until Q and S cones
are ported.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Tuple

import torch

from .segment import check_r_only, put_r, put_rows_r, take_r, take_rows_r
from .spec import ConeSpec

__all__ = [
    "NTScaling",
    "nt_scaling",
    "nt_identity",
    "nt_inv_adjoint",
    "apply",
    "apply_adjoint",
    "apply_mat",
    "apply_adjoint_mat",
    "cast",
]


@dataclass(frozen=True)
class NTScaling:
    r_d: torch.Tensor  # (nr,)
    soc: Tuple = ()
    sdp: Tuple = ()


def nt_scaling(spec: ConeSpec, z: torch.Tensor, s: torch.Tensor) -> NTScaling:
    """NT scaling F with ``F z = F⁻ᵀ s = λ``."""
    check_r_only(spec)
    r_d = torch.sqrt(take_r(spec, s) / take_r(spec, z)) if spec.nr else z[:0]
    return NTScaling(r_d=r_d)


def nt_identity(spec: ConeSpec, dtype=torch.float64, device="cpu") -> NTScaling:
    """Identity scaling, used for the cold-start KKT solve."""
    check_r_only(spec)
    return NTScaling(r_d=torch.ones(spec.nr, dtype=dtype, device=device))


def nt_inv_adjoint(spec: ConeSpec, F: NTScaling) -> NTScaling:
    """F⁻ᵀ with the same structure (R blocks are symmetric: F⁻ᵀ = F⁻¹)."""
    return NTScaling(r_d=1.0 / F.r_d)


def cast(F: NTScaling, dtype) -> NTScaling:
    """All scaling fields converted to ``dtype``."""
    return NTScaling(r_d=F.r_d.to(dtype))


def apply(spec: ConeSpec, F: NTScaling, x: torch.Tensor) -> torch.Tensor:
    """F @ x."""
    if spec.only_r:
        return F.r_d * x
    o = torch.zeros_like(x)
    if spec.nr:
        put_r(spec, o, F.r_d * take_r(spec, x))
    return o


def apply_adjoint(spec: ConeSpec, F: NTScaling, x: torch.Tensor) -> torch.Tensor:
    """Fᵀ @ x (equal to F @ x on R blocks)."""
    return apply(spec, F, x)


def apply_mat(spec: ConeSpec, F: NTScaling, A: torch.Tensor) -> torch.Tensor:
    """F @ A for A of shape (m, n): scales the rows. The Schur assembly
    builds ``Atil = F⁻ᵀ A`` this way."""
    if spec.only_r:
        return F.r_d[:, None] * A
    o = torch.zeros_like(A)
    if spec.nr:
        put_rows_r(spec, o, F.r_d[:, None] * take_rows_r(spec, A))
    return o


def apply_adjoint_mat(spec: ConeSpec, F: NTScaling, A: torch.Tensor) -> torch.Tensor:
    return apply_mat(spec, F, A)
