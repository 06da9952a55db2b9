"""Slice access to the R coordinates of a cone product.

Counterpart of ``conicip_tpu/cones/segment.py`` for R cones. The R
coordinates form a few consecutive runs (``ConeSpec.r_runs``), so every
access is a ``narrow`` view per run: no index tensor and no gather. The
``put_*`` helpers write into ``o`` in place and return it; callers pass a
freshly allocated output.

The vector helpers treat the last axis as the cone axis; the ``rows``
variants treat the leading axis of an (m, n) matrix as the cone axis.
"""

from __future__ import annotations

import torch

from .spec import ConeSpec

__all__ = ["take_r", "put_r", "take_rows_r", "put_rows_r", "check_r_only"]


def check_r_only(spec: ConeSpec) -> None:
    """Raise for Q and S cones, which the port does not compute on yet."""
    if spec.soc_groups or spec.sdp_groups:
        raise NotImplementedError(
            "the PyTorch port handles R cones only; Q and S cones are still "
            "to be ported (see ROADMAP.md, queue 1)")


def _take(x: torch.Tensor, runs, dim: int) -> torch.Tensor:
    if len(runs) == 1:
        a, b = runs[0]
        return x.narrow(dim, a, b - a)
    return torch.cat([x.narrow(dim, a, b - a) for a, b in runs], dim=dim)


def _put(o: torch.Tensor, runs, val: torch.Tensor, dim: int) -> torch.Tensor:
    pos = 0
    for a, b in runs:
        o.narrow(dim, a, b - a).copy_(val.narrow(dim, pos, b - a))
        pos += b - a
    return o


def take_r(spec: ConeSpec, x: torch.Tensor) -> torch.Tensor:
    """x restricted to the R coordinates, shape (..., nr)."""
    return _take(x, spec.r_runs, x.dim() - 1)


def put_r(spec: ConeSpec, o: torch.Tensor, val: torch.Tensor) -> torch.Tensor:
    """o with the R coordinates replaced by val (aligned with take_r)."""
    return _put(o, spec.r_runs, val, o.dim() - 1)


def take_rows_r(spec: ConeSpec, X: torch.Tensor) -> torch.Tensor:
    """Rows of an (m, n) matrix at the R coordinates, shape (nr, n)."""
    return _take(X, spec.r_runs, 0)


def put_rows_r(spec: ConeSpec, O: torch.Tensor, val: torch.Tensor) -> torch.Tensor:
    return _put(O, spec.r_runs, val, 0)
