"""Modeling-language frontend: a MathOptInterface-style optimizer.

Counterpart of ``conicip_tpu/frontend/model.py``, with the same
constraint-translation sign conventions. Constraints are affine functions
``f(x) = M x + q`` paired with a set; the translation into the internal form

    minimize  ½ yᵀQy − cᵀy   s.t.  Ay ≥_K b,  Gy = d

is:

=====================  =====================================================
set                    internal rows
=====================  =====================================================
Zeros                  G ← M,   d ← −q
Nonnegatives           A ← M,   b ← −q,        cone ("R", dim)
Nonpositives           A ← −M,  b ← q,         cone ("R", dim)
SecondOrderCone        A ← M,   b ← −q,        cone ("Q", dim)
PSDTriangle            A ← M,   b ← −q,        cone ("S", dim)
EqualTo(v)             G ← M,   d ← v − q
GreaterThan(l)         A ← M,   b ← l − q,     cone ("R", 1)
LessThan(u)            A ← −M,  b ← q − u,     cone ("R", 1)
=====================  =====================================================

Objective sense handling: the solver minimizes ``−cᵀy``, so MIN sense
passes ``c_int = −c_obj`` and MAX passes ``c_int = +c_obj`` (objective value
negated back on read-out).

The model is assembled on the host in numpy; :meth:`Optimizer.optimize`
solves it on the model's ``device`` (the card by default) and keeps the
solution there (``Optimizer.sol``, tensors) beside one host copy, which the
getters read: they return numpy arrays and Python floats.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, List, Optional, Tuple

import numpy as np

from ..interop import solution_to_numpy
from ..preprocess import preprocess_conic_ip
from ..solver.state import Solution
from . import sets as S

__all__ = ["Optimizer", "TerminationStatus"]


class TerminationStatus:
    OPTIMIZE_NOT_CALLED = "OPTIMIZE_NOT_CALLED"
    OPTIMAL = "OPTIMAL"
    INFEASIBLE = "INFEASIBLE"
    DUAL_INFEASIBLE = "DUAL_INFEASIBLE"
    ITERATION_LIMIT = "ITERATION_LIMIT"
    OTHER_ERROR = "OTHER_ERROR"


_STATUS_MAP = {
    "Optimal": TerminationStatus.OPTIMAL,
    "Infeasible": TerminationStatus.INFEASIBLE,
    "Unbounded": TerminationStatus.DUAL_INFEASIBLE,
    "Abandoned": TerminationStatus.ITERATION_LIMIT,
}


@dataclass
class _VectorConstraint:
    M: np.ndarray  # (dim, n_at_add) coefficient matrix
    q: np.ndarray  # (dim,) constants
    set: object
    ci: int


def _internal_rows(st, q):
    """One constraint ``M x + q ∈ st`` in the internal form, by the table
    of the module docstring: ``(sign of M, right-hand side, cone kind)``,
    the cone kind None for an equality."""
    if isinstance(st, S.Zeros):
        return 1, -q, None
    if isinstance(st, S.EqualTo):
        return 1, np.array([st.value]) - q, None
    if isinstance(st, S.Nonnegatives):
        return 1, -q, "R"
    if isinstance(st, S.Nonpositives):
        return -1, q, "R"
    if isinstance(st, S.SecondOrderCone):
        return 1, -q, "Q"
    if isinstance(st, S.PSDTriangle):
        return 1, -q, "S"
    if isinstance(st, S.GreaterThan):
        return 1, np.array([st.lower]) - q, "R"
    if isinstance(st, S.LessThan):
        return -1, q - np.array([st.upper]), "R"
    raise TypeError(f"unsupported set {st!r}")


class Optimizer:
    """Build-and-solve model object. ``device`` is where
    :meth:`optimize` solves; nothing falls back to the CPU when there is no
    card. ``solver_options`` go to :func:`conicip_tpu_torch.conic_ip`.

    >>> model = Optimizer(optTol=1e-6)
    >>> x = model.add_variables(2)
    >>> model.set_objective("min", {x[0]: 1.0, x[1]: 1.0})
    >>> model.add_constraint(np.ones((1, 2)), np.zeros(1), GreaterThan(1.0))
    >>> model.optimize()
    """

    def __init__(self, *, verbose: bool = False, optTol: float = 1e-6,
                 maxIters: int = 100, device="cuda", **solver_options):
        self.verbose = verbose
        self.device = device
        self.optTol = optTol
        self.maxIters = maxIters
        self.solver_options = solver_options
        self._n = 0
        self._sense = "min"
        self._obj: Dict[int, float] = {}
        self._obj_constant = 0.0
        self._obj_quad: Optional[np.ndarray] = None
        self._constraints: List[_VectorConstraint] = []
        self._next_ci = 0
        self.sol: Optional[Solution] = None  # tensors on the device
        self._host: Optional[Solution] = None  # its one host copy (numpy)
        # ci → ("eq"|"ineq", row range) for dual recovery
        self._ci_rows: Dict[int, Tuple[str, slice]] = {}

    # ── model building ───────────────────────────────────────────
    def add_variables(self, k: int) -> List[int]:
        idx = list(range(self._n, self._n + k))
        self._n += k
        return idx

    def add_variable(self) -> int:
        return self.add_variables(1)[0]

    def set_objective(self, sense: str, terms, constant: float = 0.0,
                      quadratic=None) -> None:
        """``terms`` is a dict {variable index: coefficient} or a dense
        coefficient vector over all variables.

        ``quadratic`` adds a ½ xᵀPx term: a dict {(i, j): coefficient}
        (symmetrized) or a dense (n, n) matrix. P must be positive
        semidefinite for ``min`` and negative semidefinite for ``max``
        (convexity).
        """
        if sense not in ("min", "max"):
            raise ValueError("sense must be 'min' or 'max'")
        self._sense = sense
        if isinstance(terms, dict):
            self._obj = dict(terms)
        else:
            arr = np.asarray(terms, dtype=float)
            self._obj = {i: float(v) for i, v in enumerate(arr) if v != 0.0}
        self._obj_constant = float(constant)
        self._obj_quad = None
        if quadratic is not None:
            if isinstance(quadratic, dict):
                P = np.zeros((self._n, self._n))
                for (i, j), v in quadratic.items():
                    P[i, j] += 0.5 * v
                    P[j, i] += 0.5 * v
            else:
                P = np.asarray(quadratic, dtype=float)
                P = 0.5 * (P + P.T)
            self._obj_quad = P

    def add_constraint(self, M, q, cset) -> int:
        """Constrain the affine function ``M x + q`` to lie in ``cset``.

        Scalar sets accept 1-D ``M`` of length n (one row).
        ``variables_in(vars, cset)`` is sugar for M = selection rows.
        """
        M = np.atleast_2d(np.asarray(M, dtype=float))
        q = np.atleast_1d(np.asarray(q, dtype=float))
        _supported = (S.Zeros, S.Nonnegatives, S.Nonpositives,
                      S.SecondOrderCone, S.PSDTriangle, S.EqualTo,
                      S.GreaterThan, S.LessThan)
        if not isinstance(cset, _supported):
            raise TypeError(
                f"unsupported constraint set {cset!r}; expected one of "
                + ", ".join(t.__name__ for t in _supported)
            )
        if isinstance(cset, (S.EqualTo, S.GreaterThan, S.LessThan)):
            if M.shape[0] != 1 or q.shape != (1,):
                raise ValueError("scalar set needs a single affine row")
        else:
            if M.shape[0] != cset.dim or q.shape != (cset.dim,):
                raise ValueError(
                    f"affine function has {M.shape[0]} rows, set has dim "
                    f"{cset.dim}"
                )
        ci = self._next_ci
        self._next_ci += 1
        self._constraints.append(_VectorConstraint(M=M, q=q, set=cset, ci=ci))
        return ci

    def variables_in(self, variables: List[int], cset) -> int:
        """Constrain a vector of variables to a set (MOI VectorOfVariables)."""
        M = np.zeros((len(variables), self._n))
        for i, vi in enumerate(variables):
            M[i, vi] = 1.0
        return self.add_constraint(M, np.zeros(len(variables)), cset)

    # ── solve ────────────────────────────────────────────────────
    def optimize(self) -> Solution:
        n = self._n
        c_obj = np.zeros(n)
        for i, v in self._obj.items():
            c_obj[i] += v
        # solver minimizes ½yᵀQy − cᵀy; for a
        # quadratic user objective ½xᵀPx + cᵀx the mapping is Q = ±P with
        # the same sign flip as the linear part
        c_int = c_obj if self._sense == "max" else -c_obj
        Q = np.zeros((n, n))
        quad = self._obj_quad
        if quad is not None:
            P = np.zeros((n, n))
            P[: quad.shape[0], : quad.shape[1]] = quad
            Q = -P if self._sense == "max" else P

        G_rows, d_vals = [], []
        A_rows, b_vals = [], []
        cone_dims: List[Tuple[str, int]] = []
        eq_row = ineq_row = 0
        self._ci_rows.clear()

        for con in self._constraints:
            M = np.zeros((con.M.shape[0], n))
            M[:, : con.M.shape[1]] = con.M
            sign, rhs, cone = _internal_rows(con.set, con.q)
            dim = rhs.shape[0]
            if cone is None:  # an equality: G ← M, d ← rhs
                G_rows.append(M)
                d_vals.append(rhs)
                self._ci_rows[con.ci] = ("eq", slice(eq_row, eq_row + dim))
                eq_row += dim
            else:  # A ← ±M, b ← rhs, one cone block
                A_rows.append(sign * M if sign < 0 else M)
                b_vals.append(rhs)
                cone_dims.append((cone, dim))
                self._ci_rows[con.ci] = ("ineq",
                                         slice(ineq_row, ineq_row + dim))
                ineq_row += dim

        G = np.vstack(G_rows) if G_rows else np.zeros((0, n))
        d = np.concatenate(d_vals) if d_vals else np.zeros(0)
        A = np.vstack(A_rows) if A_rows else np.zeros((0, n))
        b = np.concatenate(b_vals) if b_vals else np.zeros(0)

        self.sol = preprocess_conic_ip(
            Q, c_int, A, b, cone_dims, G, d,
            verbose=self.verbose, optTol=self.optTol, maxIters=self.maxIters,
            device=self.device, **self.solver_options,
        )
        self._host = solution_to_numpy(self.sol)  # the one copy per solve
        return self.sol

    # ── result getters (host values: numpy arrays, Python floats) ─
    def termination_status(self) -> str:
        if self.sol is None:
            return TerminationStatus.OPTIMIZE_NOT_CALLED
        return _STATUS_MAP.get(self.sol.status, TerminationStatus.OTHER_ERROR)

    def objective_value(self) -> float:
        self._check_result()
        val = self.sol.pobj
        if self._sense == "max":
            val = -val
        return val + self._obj_constant

    def variable_primal(self, vi) -> float:
        self._check_result()
        if isinstance(vi, (list, tuple, np.ndarray)):
            return np.asarray([self._host.y[int(i)] for i in vi])
        return float(self._host.y[int(vi)])

    def constraint_dual(self, ci: int) -> np.ndarray:
        self._check_result()
        kind, rows = self._ci_rows[ci]
        vec = self._host.w if kind == "eq" else self._host.v
        return np.asarray(vec[rows])

    def _check_result(self):
        if self.sol is None:
            raise RuntimeError("optimize() has not been called")
