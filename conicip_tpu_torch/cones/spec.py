"""Static cone-product metadata (numpy only).

Counterpart of ``conicip_tpu/cones/spec.py``. A cone product
``K = K_1 x ... x K_j`` is a list of ``(type, dim)`` tuples. :class:`ConeSpec`
precomputes, once in Python:

- the index set of all nonnegative-orthant (``R``) coordinates and its
  consecutive runs,
- second-order cones (``Q``) grouped by dimension as ``(k, dim)`` index maps,
- semidefinite cones (``S``) grouped by matrix order ``d`` as
  ``(k, d(d+1)/2)`` index maps.

Each R set and each group also keeps its coordinates as consecutive runs
``(start, stop)``, so that the segment helpers take and put them with
``narrow`` views.
"""

from __future__ import annotations

import math
from dataclasses import dataclass, field
from functools import cached_property, lru_cache
from typing import Sequence, Tuple

import numpy as np

__all__ = ["ConeSpec", "SocGroup", "SdpGroup", "tri_dim", "tri_order",
           "tri_indices"]


def tri_dim(d: int) -> int:
    """Packed dimension of a d x d symmetric matrix: d(d+1)/2."""
    return d * (d + 1) // 2


def tri_order(t: int) -> int:
    """Matrix order from packed length."""
    d = int(round((math.isqrt(1 + 8 * t) - 1) / 2))
    if tri_dim(d) != t:
        raise ValueError(f"{t} is not a triangular number d(d+1)/2")
    return d


@lru_cache(maxsize=None)
def tri_indices(d: int) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Row/col indices of the packed upper triangle, row-major, and the
    sqrt(2) off-diagonal scale that makes ``dot(vecm(X), vecm(Y)) ==
    tr(X @ Y)``. Returns immutable arrays of length d(d+1)/2."""
    rows, cols = np.triu_indices(d)
    rows_a = rows.astype(np.int32)
    cols_a = cols.astype(np.int32)
    scale = np.where(rows_a == cols_a, 1.0, math.sqrt(2.0))
    for a in (rows_a, cols_a, scale):
        a.setflags(write=False)
    return rows_a, cols_a, scale


def _runs(idx: np.ndarray) -> Tuple[Tuple[int, int], ...]:
    """Maximal consecutive runs of a sorted index vector as (start, stop)."""
    if idx.size == 0:
        return ()
    breaks = np.nonzero(np.diff(idx) != 1)[0]
    starts = np.concatenate([[0], breaks + 1])
    stops = np.concatenate([breaks + 1, [idx.size]])
    return tuple(
        (int(idx[a]), int(idx[b - 1]) + 1) for a, b in zip(starts, stops)
    )


def _freeze(a: np.ndarray) -> np.ndarray:
    a = a.astype(np.int32)
    a.setflags(write=False)
    return a


@dataclass(frozen=True)
class SocGroup:
    """All second-order cones of one dimension."""

    dim: int
    idx: np.ndarray = field(compare=False)  # (k, dim) coordinates into m
    runs: Tuple[Tuple[int, int], ...] = field(default=(), compare=False)

    @property
    def count(self) -> int:
        return self.idx.shape[0]


@dataclass(frozen=True)
class SdpGroup:
    """All semidefinite cones of one matrix order (packed storage)."""

    order: int
    idx: np.ndarray = field(compare=False)  # (k, order*(order+1)/2)
    runs: Tuple[Tuple[int, int], ...] = field(default=(), compare=False)

    @property
    def count(self) -> int:
        return self.idx.shape[0]

    @property
    def tdim(self) -> int:
        return tri_dim(self.order)


class ConeSpec:
    """Frozen, hashable description of a cone product: a sequence of
    ``("R"|"Q"|"S", dim)`` tuples, where for ``S`` the dim is the packed
    dimension d(d+1)/2."""

    def __init__(self, cone_dims: Sequence[Tuple[str, int]]):
        cone_dims = tuple((str(t), int(k)) for (t, k) in cone_dims)
        offset = 0
        r_idx = []
        soc: dict[int, list[np.ndarray]] = {}
        sdp: dict[int, list[np.ndarray]] = {}
        conedim = 0  # sum of barrier degrees
        for (ctype, k) in cone_dims:
            if k < 0:
                raise ValueError(f"negative cone dimension {k}")
            rng = np.arange(offset, offset + k, dtype=np.int32)
            if ctype == "R":
                r_idx.append(rng)
                conedim += k
            elif ctype == "Q":
                if k < 1:
                    raise ValueError("Q cone must have dim >= 1")
                soc.setdefault(k, []).append(rng)
                conedim += 1
            elif ctype == "S":
                d = tri_order(k)
                sdp.setdefault(d, []).append(rng)
                conedim += d
            else:
                raise ValueError(f"unknown cone type {ctype!r}")
            offset += k

        self.cone_dims = cone_dims
        self.m = offset
        self.conedim = conedim
        self.r_idx = (
            np.concatenate(r_idx).astype(np.int32) if r_idx else np.zeros(0, np.int32)
        )
        self.r_idx.setflags(write=False)
        self.r_runs = _runs(self.r_idx)
        self.soc_groups = tuple(
            SocGroup(dim=d, idx=_freeze(np.stack(v)),
                     runs=_runs(np.concatenate(v)))
            for d, v in sorted(soc.items())
        )
        self.sdp_groups = tuple(
            SdpGroup(order=d, idx=_freeze(np.stack(v)),
                     runs=_runs(np.concatenate(v)))
            for d, v in sorted(sdp.items())
        )

    @cached_property
    def identity(self) -> np.ndarray:
        """The cone-product identity element ``e``: ones on R blocks,
        (1, 0, ...) per Q cone, vecm(I) per S cone."""
        e = np.zeros(self.m)
        e[self.r_idx] = 1.0
        for g in self.soc_groups:
            e[g.idx[:, 0]] = 1.0
        for g in self.sdp_groups:
            rows, cols, _ = tri_indices(g.order)
            e[g.idx[:, rows == cols]] = 1.0
        e.setflags(write=False)
        return e

    @property
    def nr(self) -> int:
        return int(self.r_idx.shape[0])

    @property
    def only_r(self) -> bool:
        """True when the whole product is one contiguous R block: cone ops
        are then plain elementwise code."""
        return (
            self.nr == self.m
            and not self.soc_groups
            and not self.sdp_groups
            and len(self.r_runs) <= 1
        )

    def __hash__(self) -> int:
        return hash(self.cone_dims)

    def __eq__(self, other) -> bool:
        return isinstance(other, ConeSpec) and self.cone_dims == other.cone_dims

    def __repr__(self) -> str:
        return f"ConeSpec({list(self.cone_dims)!r})"
