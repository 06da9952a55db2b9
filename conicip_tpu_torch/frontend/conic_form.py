"""Conic standard-form entry point (the SCS/Clarabel data convention).

Counterpart of ``conicip_tpu/frontend/conic_form.py``. The Python modeling
ecosystem's lingua franca for cone programs (what CVXPY's
``ConeMatrixStuffing`` reduction emits and what SCS/ECOS/Clarabel consume)
is

    minimize    cᵀx
    subject to  b − Ax ∈ K,    K = {0}^z × R₊^l × SOC(q₁)×… × PSD(s₁)×…

with PSD blocks vectorized as the scaled lower triangle (column-major,
off-diagonals ×√2).  :func:`solve_conic_form` accepts exactly this data and
maps it onto the internal problem

    minimize  ½yᵀQy − c_intᵀy   s.t.  A_int y ≥_K b_int,  G y = d

via

    c_int = −c                       (the internal objective is −cᵀy)
    G     = A[zero rows],   d     = b[zero rows]
    A_int = −A[cone rows],  b_int = −b[cone rows]

The PSD vectorization needs **no permutation**: the column-major lower
triangle of a symmetric matrix enumerates entries in exactly the row-major
upper-triangle order of the internal ``vecm`` (cones/symm.py), and both
conventions scale off-diagonals by √2.

Duals: with Q = 0 the internal stationarity Qy − c_int − A_intᵀv + Gᵀw = 0
reads c + A_cᵀv + A_zᵀw = 0, the standard-form dual Aᵀy_dual + c = 0 with
``y_dual = [w; v]`` stacked back in original row order. So equality rows
report ``w`` and cone rows report ``v``, unchanged.

The model is assembled on the host in numpy and solved on ``device`` (the
card by default); the standard-form result is computed on the host from
one copy of the solution.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import List, Tuple

import numpy as np

from ..cones.spec import tri_dim
from ..solver.state import Solution, to_host

__all__ = ["ConeDims", "solve_conic_form", "ConicFormResult"]


@dataclass(frozen=True)
class ConeDims:
    """Cone sizes of the standard form, in row order zero → nonneg →
    soc → psd. ``psd`` entries are MATRIX ORDERS (d for a d×d block),
    matching CVXPY's ``ConeDims``; the vectorized row count of such a
    block is d(d+1)/2."""

    zero: int = 0
    nonneg: int = 0
    soc: Tuple[int, ...] = ()
    psd: Tuple[int, ...] = ()

    def __post_init__(self):
        object.__setattr__(self, "soc", tuple(int(q) for q in self.soc))
        object.__setattr__(self, "psd", tuple(int(s) for s in self.psd))

    @property
    def cone_rows(self) -> int:
        return (self.nonneg + sum(self.soc)
                + sum(tri_dim(d) for d in self.psd))

    @property
    def total_rows(self) -> int:
        return self.zero + self.cone_rows

    def cone_dims(self) -> List[Tuple[str, int]]:
        """Internal cone_dims list for the non-zero-cone rows."""
        out: List[Tuple[str, int]] = []
        if self.nonneg:
            out.append(("R", self.nonneg))
        for q in self.soc:
            out.append(("Q", q))
        for d in self.psd:
            out.append(("S", tri_dim(d)))
        return out


@dataclass
class ConicFormResult:
    """Solve result in standard-form coordinates: ``x``, ``y``, ``s`` are
    host numpy arrays; ``solution`` is the internal :class:`Solution`, its
    ``y``/``w``/``v`` tensors on the solve's device."""

    status: str              # internal status string
    x: np.ndarray            # primal (NaN for infeasible)
    y: np.ndarray            # dual, stacked [zero-rows duals; cone duals]
    s: np.ndarray            # slack b − Ax (cone rows ∈ K; zero rows ≈ 0)
    obj: float               # cᵀx at the returned primal
    solution: Solution = field(repr=False, default=None)  # raw internal


def _as_dense(M) -> np.ndarray:
    """Host f64 array of a numpy array, scipy.sparse matrix or tensor."""
    return np.asarray(to_host(M), dtype=np.float64)


def _normalize_dims(dims) -> ConeDims:
    if isinstance(dims, ConeDims):
        return dims
    if isinstance(dims, dict):
        return ConeDims(
            zero=int(dims.get("zero", dims.get("z", dims.get("f", 0))) or 0),
            nonneg=int(dims.get("nonneg", dims.get("l", 0)) or 0),
            soc=tuple(dims.get("soc", dims.get("q", ())) or ()),
            psd=tuple(dims.get("psd", dims.get("s", ())) or ()),
        )
    # duck-typed (e.g. cvxpy's ConeDims object)
    for exp_attr in ("exp", "p3d"):
        if getattr(dims, exp_attr, None):
            raise ValueError(
                "exponential/power cones are not supported (the solver "
                "supports R/Q/S cones only)"
            )
    return ConeDims(
        zero=int(getattr(dims, "zero", 0) or 0),
        nonneg=int(getattr(dims, "nonneg", 0) or 0),
        soc=tuple(getattr(dims, "soc", ()) or ()),
        psd=tuple(getattr(dims, "psd", ()) or ()),
    )


def solve_conic_form(
    c,
    A,
    b,
    dims,
    *,
    P=None,
    preprocess: bool = True,
    device="cuda",
    **solver_options,
) -> ConicFormResult:
    """Solve ``min cᵀx (+ ½xᵀPx)  s.t.  b − Ax ∈ K`` (standard conic form).

    ``dims`` is a :class:`ConeDims`, a dict with keys among
    ``zero/nonneg/soc/psd`` (SCS-style ``f/l/q/s`` aliases accepted), or any
    object exposing those attributes (CVXPY's ``ConeDims``). Rows of ``A``
    must be ordered zero → nonneg → soc → psd, PSD blocks vectorized as the
    scaled lower triangle (the CVXPY/SCS convention). ``c``, ``A``, ``b``
    and ``P`` may be numpy arrays, scipy.sparse matrices or tensors.

    ``P`` optionally adds a convex quadratic ½xᵀPx to the objective
    (Clarabel-style extension; CVXPY's conic path keeps P = 0).

    The problem is solved on ``device``; nothing falls back to the CPU when
    there is no card. ``solver_options`` pass through to
    :func:`conicip_tpu_torch.conic_ip` (``optTol``, ``maxIters``,
    ``verbose``, ``kktsolver``, …).
    """
    from ..interop import solution_to_numpy
    from ..preprocess import preprocess_conic_ip
    from ..solver import conic_ip

    dims = _normalize_dims(dims)
    c = _as_dense(c).ravel()
    A = _as_dense(A)
    b = _as_dense(b).ravel()
    n = c.shape[0]
    if A.shape != (dims.total_rows, n):
        raise ValueError(
            f"A has shape {A.shape}, expected ({dims.total_rows}, {n}) "
            f"from dims {dims} and len(c) = {n}"
        )
    z = dims.zero
    G, d = A[:z], b[:z]
    A_int, b_int = -A[z:], -b[z:]
    cone_dims = dims.cone_dims()
    Q = np.zeros((n, n)) if P is None else _as_dense(P)
    c_int = -c

    m = A_int.shape[0]
    if m == 0:
        # The IPM needs at least one cone row; add a vacuous slack bound
        # far from any finite solution's scale.
        scale = 1.0 + float(np.abs(b).max() if b.size else 0.0)
        A_int = np.concatenate([np.ones((1, n)), -np.ones((1, n))], axis=0)
        b_int = np.full(2, -1e12 * scale)
        cone_dims = [("R", 2)]
        pad_rows = 2
    else:
        pad_rows = 0

    solve = preprocess_conic_ip if preprocess else conic_ip
    sol = solve(Q, c_int, A_int, b_int, cone_dims, G if z else None,
                d if z else None, device=device, **solver_options)

    host = solution_to_numpy(sol)  # the one copy off the device
    y_std = np.concatenate([host.w.astype(float).ravel(),
                            host.v.astype(float).ravel()])
    if pad_rows:
        y_std = y_std[:-pad_rows]
    x = host.y.astype(float).ravel()
    if np.all(np.isfinite(x)):
        s = b - A @ x
        obj = float(c @ x) + (0.5 * float(x @ (Q @ x)) if P is not None
                              else 0.0)
    else:
        s = np.full(b.shape, np.nan)
        obj = np.nan
    return ConicFormResult(status=sol.status, x=x, y=y_std, s=s, obj=obj,
                           solution=sol)
