"""Modeling frontends: the MOI-style :class:`Optimizer`, the standard conic
form :func:`solve_conic_form`, and (in :mod:`.cvxpy_solver`) the CVXPY bridge.
Counterpart of ``conicip_tpu/frontend``."""

from .conic_form import ConeDims, ConicFormResult, solve_conic_form
from .model import Optimizer, TerminationStatus
from .sets import (
    EqualTo,
    GreaterThan,
    LessThan,
    Nonnegatives,
    Nonpositives,
    PSDTriangle,
    SecondOrderCone,
    Zeros,
)

__all__ = [
    "Optimizer",
    "TerminationStatus",
    "ConeDims",
    "ConicFormResult",
    "solve_conic_form",
    "Zeros",
    "Nonnegatives",
    "Nonpositives",
    "SecondOrderCone",
    "PSDTriangle",
    "EqualTo",
    "GreaterThan",
    "LessThan",
]
