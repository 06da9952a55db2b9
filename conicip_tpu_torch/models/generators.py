"""Benchmark problem-family generators (numpy).

Counterpart of ``conicip_tpu/models/generators.py``: its eight
single-instance families and its four batched ones, with the same seeds,
RNG calls, shapes and data, so both packages solve the same instances.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import List, Optional, Tuple

import numpy as np

from ..cones.spec import tri_dim, tri_indices

__all__ = ["Problem", "box_qp_dense", "box_qp_sparse", "single_soc",
           "many_small_socs", "small_sdp", "larger_sdp", "mixed_rq_eq",
           "mixed_rqs", "batched_box_qp", "batched_small_sdp",
           "batched_mixed_rq_eq", "batched_mixed_rqs", "ALL_GENERATORS"]


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


def _vecm_identity(k: int) -> np.ndarray:
    x = np.zeros(tri_dim(k))
    pos = 0
    for i in range(k):
        x[pos] = 1.0
        pos += k - i
    return x


def single_soc(n: int = 500, seed: int = 42) -> Problem:
    """Projection onto the unit ball: one Q cone of dim n + 1."""
    rng = np.random.default_rng(seed)
    Q = np.eye(n)
    c = rng.standard_normal(n)
    A = np.vstack([np.zeros((1, n)), np.eye(n)])
    b = np.concatenate([[-1.0], np.zeros(n)])
    return Problem(f"single_soc(n={n})", Q, c, A, b, [("Q", n + 1)])


def many_small_socs(n: int = 500, k: int = 250, seed: int = 42) -> Problem:
    """k Q cones of dim 3 over a sparse random A."""
    rng = np.random.default_rng(seed)
    m = 3 * k
    Q = np.eye(n)
    c = rng.standard_normal(n)
    A = (rng.random((m, n)) < 0.1) * rng.standard_normal((m, n))
    b = np.zeros(m)
    b[0::3] = -1.0
    return Problem(
        f"many_small_socs(k={k},n={n})", Q, c, A, b, [("Q", 3)] * k
    )


def small_sdp(k: int = 10, seed: int = 42) -> Problem:
    """PSD projection of the k x k identity under the trace metric: one S
    cone, A = I, Q = I (the spectral backend's family)."""
    n = tri_dim(k)
    Q = np.eye(n)
    c = _vecm_identity(k)
    A = np.eye(n)
    b = np.zeros(n)
    return Problem(f"small_sdp(k={k})", Q, c, A, b, [("S", n)])


def larger_sdp(k: int = 30, seed: int = 42) -> Problem:
    return small_sdp(k=k, seed=seed)


def mixed_rq_eq(n: int = 200, seed: int = 42) -> Problem:
    """R block plus one Q cone of dim 51 over a sparse A, with 10 dense
    equalities: the Schur backend with its equality factor."""
    rng = np.random.default_rng(seed)
    n_q = 51
    Q = np.eye(n)
    c = rng.standard_normal(n)
    A_r = np.eye(n)
    A_q = (rng.random((n_q, n)) < 0.2) * rng.standard_normal((n_q, n))
    A_q[0, :] = 0.0
    A = np.vstack([A_r, A_q])
    b = np.concatenate([np.zeros(n), [-1.0], np.zeros(n_q - 1)])
    p = 10
    G = rng.standard_normal((p, n))
    d = G @ np.ones(n)
    return Problem(
        f"mixed_rq_eq(n={n},p={p})", Q, c, A, b, [("R", n), ("Q", n_q)], G, d
    )


def mixed_rqs(seed: int = 42) -> Problem:
    """R(50) x Q(21) x S(5 x 5), A = I, Q = I: n = 86."""
    n_r, n_q, k_s = 50, 21, 5
    n_s = tri_dim(k_s)
    n = n_r + n_q + n_s  # 86
    rng = np.random.default_rng(seed)
    Q = np.eye(n)
    c = rng.standard_normal(n)
    A = np.eye(n)
    b = np.concatenate([np.zeros(n_r), [-1.0], np.zeros(n_q - 1), np.zeros(n_s)])
    return Problem(
        f"mixed_rqs(n={n})", Q, c, A, b,
        [("R", n_r), ("Q", n_q), ("S", n_s)],
    )


def batched_box_qp(batch: int, n: int = 100, seed: int = 0):
    """Stacked independent dense box QPs, −1 ≤ y ≤ 1: ``(Q, c, A, b,
    cone_dims)`` with a leading batch axis on all but ``cone_dims``."""
    rng = np.random.default_rng(seed)
    Ms = rng.standard_normal((batch, n, n))
    Q = np.einsum("bij,bik->bjk", Ms, Ms) / n + np.eye(n)
    c = rng.standard_normal((batch, n))
    A = np.broadcast_to(np.vstack([np.eye(n), -np.eye(n)]), (batch, 2 * n, n)).copy()
    b = np.broadcast_to(-np.ones(2 * n), (batch, 2 * n)).copy()
    return Q, c, A, b, [("R", 2 * n)]


def _vecm_np(X: np.ndarray) -> np.ndarray:
    """Host-side packed √2-scaled upper triangle of a stack of symmetric
    matrices (the ``vecm`` convention of ``cones/symm.py``)."""
    rows, cols, scale = tri_indices(X.shape[-1])
    return X[..., rows, cols] * scale


def batched_small_sdp(batch: int, k: int = 10, seed: int = 0):
    """Stacked independent small SDPs: projection of a random symmetric
    k x k matrix onto the PSD cone under the trace metric (batched
    covariance repair). Distinct data per instance; shared A = I, b = 0:
    the spectral backend's batched family."""
    n = tri_dim(k)
    rng = np.random.default_rng(seed)
    C = rng.standard_normal((batch, k, k))
    C = (C + np.swapaxes(C, -1, -2)) / np.sqrt(2 * k)
    c = _vecm_np(C)
    Q = np.broadcast_to(np.eye(n), (batch, n, n)).copy()
    A = np.broadcast_to(np.eye(n), (batch, n, n)).copy()
    b = np.zeros((batch, n))
    return Q, c, A, b, [("S", n)]


def batched_mixed_rq_eq(batch: int, n: int = 60, seed: int = 0,
                        n_q: int = 21, p: int = 6):
    """Stacked independent mixed R+Q instances with a shared equality
    system: per-instance objectives and right-hand sides under one set of
    coupling equalities, bound-R rows first, then one SOC block (the
    low-rank backend's family). Returns ``(Q, c, A, b, cone_dims, G, d)``
    with a leading batch axis on all but ``cone_dims`` and ``G``.
    ``n=200, n_q=51, p=10`` is the shape of :func:`mixed_rq_eq`."""
    rng = np.random.default_rng(seed)
    Q = np.broadcast_to(np.eye(n), (batch, n, n)).copy()
    c = rng.standard_normal((batch, n))
    A_q = (rng.random((n_q, n)) < 0.2) * rng.standard_normal((n_q, n))
    A_q[0, :] = 0.0
    # every instance's point y_i = s_i·1 is strictly feasible by
    # construction: R slack s_i·1 > 0, SOC slack (1, s_i·A_q[1:]·1) with
    # the tail scaled to norm ≤ 0.5 < 1, and d_i = G y_i
    s = 1.0 + 0.1 * rng.random(batch)
    tail = np.linalg.norm(A_q[1:] @ np.ones(n)) * s.max()
    A_q[1:] *= 0.5 / max(tail, 1e-9)
    A0 = np.vstack([np.eye(n), A_q])
    A = np.broadcast_to(A0, (batch, n + n_q, n)).copy()
    b0 = np.concatenate([np.zeros(n), [-1.0], np.zeros(n_q - 1)])
    b = np.broadcast_to(b0, (batch, n + n_q)).copy()
    G = rng.standard_normal((p, n))
    d = s[:, None] * (G @ np.ones(n))[None, :]
    return Q, c, A, b, [("R", n), ("Q", n_q)], G, d


def batched_mixed_rqs(batch: int, seed: int = 0):
    """Stacked independent R(50) x Q(21) x S(5 x 5) instances, A = I,
    Q = I (n = 86), with distinct linear terms per instance."""
    n_r, n_q, k_s = 50, 21, 5
    n_s = tri_dim(k_s)
    n = n_r + n_q + n_s  # 86
    rng = np.random.default_rng(seed)
    Q = np.broadcast_to(np.eye(n), (batch, n, n)).copy()
    c = rng.standard_normal((batch, n))
    A = np.broadcast_to(np.eye(n), (batch, n, n)).copy()
    b0 = np.concatenate(
        [np.zeros(n_r), [-1.0], np.zeros(n_q - 1), np.zeros(n_s)]
    )
    b = np.broadcast_to(b0, (batch, n)).copy()
    return Q, c, A, b, [("R", n_r), ("Q", n_q), ("S", n_s)]


ALL_GENERATORS = [
    box_qp_dense,
    box_qp_sparse,
    single_soc,
    many_small_socs,
    small_sdp,
    larger_sdp,
    mixed_rq_eq,
    mixed_rqs,
]

# Each generator's instance name at its default parameters, so that a
# caller can pick families without building their data.
for _g, _n in [
    (box_qp_dense, "box_qp_dense(n=500)"),
    (box_qp_sparse, "box_qp_sparse(n=1000)"),
    (single_soc, "single_soc(n=500)"),
    (many_small_socs, "many_small_socs(k=250,n=500)"),
    (small_sdp, "small_sdp(k=10)"),
    (larger_sdp, "small_sdp(k=30)"),  # larger_sdp delegates to small_sdp
    (mixed_rq_eq, "mixed_rq_eq(n=200,p=10)"),
    (mixed_rqs, "mixed_rqs(n=86)"),
]:
    _g.family_name = _n
