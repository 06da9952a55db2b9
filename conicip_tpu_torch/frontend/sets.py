"""Constraint sets for the modeling frontend.

Counterpart of ``conicip_tpu/frontend/sets.py`` (this package's own copy):
vector sets Zeros / Nonnegatives / Nonpositives / SecondOrderCone /
PSDTriangle and scalar sets EqualTo / GreaterThan / LessThan.
"""

from __future__ import annotations

from dataclasses import dataclass

__all__ = [
    "Zeros",
    "Nonnegatives",
    "Nonpositives",
    "SecondOrderCone",
    "PSDTriangle",
    "EqualTo",
    "GreaterThan",
    "LessThan",
]


@dataclass(frozen=True)
class Zeros:
    dim: int


@dataclass(frozen=True)
class Nonnegatives:
    dim: int


@dataclass(frozen=True)
class Nonpositives:
    dim: int


@dataclass(frozen=True)
class SecondOrderCone:
    dim: int


@dataclass(frozen=True)
class PSDTriangle:
    side: int  # matrix order d; packed dimension is d(d+1)/2

    @property
    def dim(self) -> int:
        return self.side * (self.side + 1) // 2


@dataclass(frozen=True)
class EqualTo:
    value: float


@dataclass(frozen=True)
class GreaterThan:
    lower: float


@dataclass(frozen=True)
class LessThan:
    upper: float
