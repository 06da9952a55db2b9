"""Slice access to the coordinates of a cone product.

Counterpart of ``conicip_tpu/cones/segment.py``. The R coordinates, and the
coordinates of each cone group, form a few consecutive runs
(``ConeSpec.r_runs``, ``SocGroup.runs``, ``SdpGroup.runs``), so every
access is a ``narrow`` view per run: no index tensor and no gather. A
group's runs hold its cones in order, so the taken coordinates reshape to
``(count, dim)``; this covers contiguous groups and interleaved cone orders
alike. The ``put_*`` helpers write into ``o`` in place and return it;
callers pass a freshly allocated output.

The vector helpers treat the last axis as the cone axis; the ``rows``
variants treat the second-to-last axis of an (..., m, n) matrix as the cone
axis. Leading dims are a stack of instances and pass through.
"""

from __future__ import annotations

import torch

from .spec import ConeSpec

__all__ = ["take_r", "put_r", "take_group", "put_group", "take_rows_r",
           "put_rows_r", "take_rows_group", "put_rows_group"]


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


def take_group(g, x: torch.Tensor) -> torch.Tensor:
    """x restricted to one cone group, shape (..., count, dim)."""
    k, t = g.idx.shape
    return _take(x, g.runs, x.dim() - 1).reshape(x.shape[:-1] + (k, t))


def put_group(g, o: torch.Tensor, val: torch.Tensor) -> torch.Tensor:
    """o with one group's coordinates replaced by val (..., count, dim)."""
    return _put(o, g.runs, val.reshape(val.shape[:-2] + (-1,)), o.dim() - 1)


def take_rows_r(spec: ConeSpec, X: torch.Tensor) -> torch.Tensor:
    """Rows of an (..., m, n) matrix at the R coordinates, (..., nr, n)."""
    return _take(X, spec.r_runs, X.dim() - 2)


def put_rows_r(spec: ConeSpec, O: torch.Tensor, val: torch.Tensor) -> torch.Tensor:
    return _put(O, spec.r_runs, val, O.dim() - 2)


def take_rows_group(g, X: torch.Tensor) -> torch.Tensor:
    """Rows of an (..., m, n) matrix at one group, (..., count, dim, n)."""
    return _take(X, g.runs, X.dim() - 2).reshape(
        X.shape[:-2] + g.idx.shape + X.shape[-1:])


def put_rows_group(g, O: torch.Tensor, val: torch.Tensor) -> torch.Tensor:
    """O with one group's rows replaced by val (..., count, dim, n)."""
    return _put(O, g.runs,
                val.reshape(O.shape[:-2] + (-1,) + O.shape[-1:]),
                O.dim() - 2)
