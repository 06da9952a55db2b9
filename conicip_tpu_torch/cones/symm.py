"""Batched symmetric-matrix packing (``vecm``/``mat``).

Counterpart of ``conicip_tpu/cones/symm.py``: the row-major upper triangle
with off-diagonal entries scaled by sqrt(2), so that
``dot(vecm(X), vecm(Y)) == tr(X @ Y)``, batched over leading dims. Both
directions are one gather on the last axis: ``vecm`` picks the packed
entries out of the flattened matrix, ``mat`` picks every matrix entry out of
the packed vector. The index and scale tensors are built once per
``(d, device, dtype)`` and cached, so an apply on the card copies nothing
from the host.
"""

from __future__ import annotations

from functools import lru_cache
from typing import Tuple

import numpy as np
import torch

from .spec import tri_indices, tri_order

__all__ = ["vecm", "mat", "vecm_single", "mat_single"]


@lru_cache(maxsize=None)
def _maps(d: int, device: torch.device,
          dtype: torch.dtype) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """``(upper, full, scale)``: flat positions of the packed entries in a
    d x d matrix, the packed position of every matrix entry, and the
    sqrt(2) off-diagonal scale."""
    rows, cols, scale = tri_indices(d)
    upper = rows.astype(np.int64) * d + cols
    full = np.empty((d, d), np.int64)
    full[rows, cols] = np.arange(rows.size)
    full[cols, rows] = np.arange(rows.size)
    return (torch.as_tensor(upper, device=device),
            torch.as_tensor(full.ravel(), device=device),
            torch.as_tensor(scale.copy(), dtype=dtype, device=device))


def vecm(Z: torch.Tensor) -> torch.Tensor:
    """Pack symmetric matrices ``Z`` of shape (..., d, d) into (..., d(d+1)/2)."""
    d = Z.shape[-1]
    upper, _, scale = _maps(d, Z.device, Z.dtype)
    return Z.reshape(Z.shape[:-2] + (d * d,))[..., upper] * scale


def mat(x: torch.Tensor) -> torch.Tensor:
    """Unpack (..., t) with t = d(d+1)/2 into symmetric (..., d, d)."""
    d = tri_order(x.shape[-1])
    _, full, scale = _maps(d, x.device, x.dtype)
    return (x / scale)[..., full].reshape(x.shape[:-1] + (d, d))


# The reference's aliases for the unbatched use (the same functions: both
# take any leading dims).
vecm_single = vecm
mat_single = mat
