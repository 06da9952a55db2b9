"""Benchmark problem-family generators (numpy).

Counterpart of ``conicip_tpu/models/generators.py`` for the R-cone
families: same seeds, shapes and data, so both packages solve the same
instances.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import List, Optional, Tuple

import numpy as np

__all__ = ["Problem", "box_qp_dense", "box_qp_sparse"]


@dataclass
class Problem:
    name: str
    Q: np.ndarray
    c: np.ndarray
    A: np.ndarray
    b: np.ndarray
    cone_dims: List[Tuple[str, int]]
    G: Optional[np.ndarray] = None
    d: Optional[np.ndarray] = None

    def args(self):
        return (self.Q, self.c, self.A, self.b, self.cone_dims, self.G, self.d)


def box_qp_dense(n: int = 500, seed: int = 42) -> Problem:
    """Dense-Q box QP, −1 ≤ y ≤ 1: the dense Schur backend's family."""
    rng = np.random.default_rng(seed)
    M = rng.standard_normal((n, n))
    Q = M.T @ M / n
    c = rng.standard_normal(n)
    A = np.vstack([np.eye(n), -np.eye(n)])
    b = -np.ones(2 * n)
    return Problem(f"box_qp_dense(n={n})", Q, c, A, b, [("R", 2 * n)])


def box_qp_sparse(n: int = 1000, seed: int = 42) -> Problem:
    """Diagonal-Q box QP: the diagonal backend's family."""
    rng = np.random.default_rng(seed)
    Q = np.diag(1.0 + rng.random(n))
    c = rng.standard_normal(n)
    A = np.vstack([np.eye(n), -np.eye(n)])
    b = -np.ones(2 * n)
    return Problem(f"box_qp_sparse(n={n})", Q, c, A, b, [("R", 2 * n)])
