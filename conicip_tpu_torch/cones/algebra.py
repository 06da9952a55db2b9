"""Euclidean-Jordan-algebra operations over a cone product, R part.

Counterpart of ``conicip_tpu/cones/algebra.py``. On R cones every operation
is elementwise:

- ``cone_prod(spec, x, y)``  = x ∘ y   (Jordan product)
- ``cone_div(spec, x, y)``   = o such that y ∘ o = x (divides x *by* y)
- ``maxstep(spec, x, d)``    = sup { α : x - α d ∈ K }
- ``maxstep_to_cone(spec, x)`` = 0 if x is strictly interior, else the
  negative shift ``-1 + min(x)`` that pushes the initial point inside
- ``centrality_correction(spec, w, lo, hi)``: the Gondzio term
  ``max(clip(w, lo, hi) - w, -hi)``

All functions take 1-D ``(m,)`` tensors and return tensors on their device.
"""

from __future__ import annotations

import torch

from .segment import check_r_only, put_r, take_r
from .spec import ConeSpec

__all__ = [
    "cone_prod",
    "cone_div",
    "maxstep",
    "maxstep_to_cone",
    "centrality_correction",
]


def _elementwise(spec: ConeSpec, fn, *xs) -> torch.Tensor:
    """Apply ``fn`` to the R coordinates of ``xs``, zeros elsewhere."""
    check_r_only(spec)
    if spec.only_r:
        return fn(*xs)
    o = torch.zeros_like(xs[0])
    if spec.nr:
        put_r(spec, o, fn(*(take_r(spec, x) for x in xs)))
    return o


def cone_prod(spec: ConeSpec, x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    return _elementwise(spec, torch.mul, x, y)


def cone_div(spec: ConeSpec, x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    return _elementwise(spec, torch.div, x, y)


def maxstep(spec: ConeSpec, x: torch.Tensor, d: torch.Tensor) -> torch.Tensor:
    """``sup { α : x - α d ∈ K }`` as a 0-dim tensor (inf when unbounded)."""
    check_r_only(spec)
    inf = torch.full((), float("inf"), dtype=x.dtype, device=x.device)
    if not spec.nr:
        return inf
    xr, dr = take_r(spec, x), take_r(spec, d)
    return torch.minimum(inf, torch.min(torch.where(dr > 0, xr / dr, inf)))


def maxstep_to_cone(spec: ConeSpec, x: torch.Tensor) -> torch.Tensor:
    check_r_only(spec)
    zero = torch.zeros((), dtype=x.dtype, device=x.device)
    if not spec.nr:
        return zero
    mn = torch.min(take_r(spec, x))
    return torch.minimum(zero, torch.where(mn > 0, zero, mn - 1.0))


def centrality_correction(spec: ConeSpec, w: torch.Tensor, lo, hi) -> torch.Tensor:
    """Gondzio centrality-corrector term ``q = Π_{[lo,hi]}(w) − w`` with the
    floor clamp ``q ≥ −hi`` (componentwise on R)."""
    lo = torch.as_tensor(lo, dtype=w.dtype, device=w.device)
    hi = torch.as_tensor(hi, dtype=w.dtype, device=w.device)

    def _clip(lmb):
        return torch.maximum(
            torch.minimum(torch.maximum(lmb, lo), hi) - lmb, -hi)

    return _elementwise(spec, _clip, w)
