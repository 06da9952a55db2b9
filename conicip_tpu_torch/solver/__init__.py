"""User-facing solver API of the PyTorch port.

Counterpart of ``conicip_tpu/solver/__init__.py`` on the path that
``conicip_tpu.conic_ip`` takes by default on hardware with native f64: full
working-precision factors, no mixed residuals, no equality elimination.
"""

from __future__ import annotations

import functools
from typing import Optional, Sequence, Tuple

import numpy as np
import torch

from ..cones.spec import ConeSpec
from ..kkt.diag import equality_mode, kktsolver_diag, separable
from ..kkt.schur import kktsolver_schur
from ..kkt.spectral import spectral_applicable, spectral_kktsolver
from .ipm import IPMOptions, ipm_solve
from .state import SolState, Solution, Status, Vec4

__all__ = ["conic_ip", "Solution", "SolState", "Status", "IPMOptions", "Vec4",
           "ipm_solve"]

_ROADMAP = "see ROADMAP.md, queue 1"


def _densify(X, dtype, device):
    if X is None:
        return None
    if hasattr(X, "toarray"):  # scipy.sparse
        X = X.toarray()
    if isinstance(X, torch.Tensor):
        return X.to(device=device, dtype=dtype)
    X = np.asarray(X)
    if not X.flags.writeable:  # e.g. a JAX array's host view
        X = X.copy()
    return torch.as_tensor(X, dtype=dtype, device=device)


def _auto_kktsolver(Q, A, G, spec):
    """Default backend, as the reference chooses it on its host data: a
    separable problem (diagonal Q, bound-style A, R cones, and an exact
    equality mode) takes the diagonal Schur solver; a PSD-projection
    structure (``A = I``, ``Q = q·I``, no equalities, any cone mix) the
    closed-form spectral solver; everything else the dense Schur solver."""
    if separable(Q, A, G, spec):
        mode = equality_mode(Q, G)
        return functools.partial(
            kktsolver_diag, eq_mode="woodbury" if mode == "none" else mode)
    if spectral_applicable(Q, A, G, spec):
        return spectral_kktsolver()
    return kktsolver_schur


def conic_ip(
    Q,
    c,
    A,
    b,
    cone_dims: Sequence[Tuple[str, int]],
    G=None,
    d=None,
    *,
    kktsolver=None,
    optTol: float = 1e-6,
    DTB: float = 0.01,
    verbose: bool = False,
    maxRefinementSteps: int = 3,
    maxIters: int = 100,
    cache_nestodd: bool = False,
    infeasTol: Optional[float] = None,
    refinementThreshold: Optional[float] = None,
    factor_dtype="auto",
    dtype=torch.float64,
    mixedResiduals: Optional[bool] = None,
    eliminateEqualities: Optional[bool] = None,
    centralityCorrectors: Optional[int] = None,
    warm_start=None,
    device="cuda",
) -> Solution:
    """Interior point solver for

    .. code-block:: text

        minimize    ½ yᵀQy − cᵀy        (note the MINUS sign on cᵀy)
        subject to  Ay ≥_K b,  K given by cone_dims, e.g. [("R",2),("Q",4)]
                    Gy = d

    over any product of R, Q and S cones (``("S", d(d+1)/2)`` for a d x d
    block, packed by :func:`~conicip_tpu_torch.cones.symm.vecm`).
    Signature- and semantics-compatible with ``conicip_tpu.conic_ip`` on its
    full-precision path, and it picks the same default backend. Inputs may be numpy arrays, scipy.sparse matrices or tensors;
    they are moved to ``device`` in ``dtype``, and the returned
    :class:`Solution` holds ``y``, ``w``, ``v`` as tensors there.
    ``kktsolver`` is the 3-level plugin callback (:mod:`conicip_tpu_torch.kkt`).
    ``centralityCorrectors=None`` means 1 on the dense Schur and spectral
    backends and 0 on the diagonal backend and for user callbacks.
    ``warm_start`` takes a previous ``Solution`` or a ``(y, w, v)`` tuple.

    ``factor_dtype`` other than ``None``/``"auto"``,
    ``mixedResiduals=True`` and ``eliminateEqualities=True`` are not ported
    yet and raise ``NotImplementedError``.
    """
    spec = ConeSpec(cone_dims)
    if not (factor_dtype is None or factor_dtype == "auto"):
        raise NotImplementedError(
            f"factor_dtype={factor_dtype!r} is not ported yet; the port "
            f"factors in the working dtype ({_ROADMAP})")
    if mixedResiduals:
        raise NotImplementedError(
            f"mixedResiduals is not ported yet ({_ROADMAP})")
    if eliminateEqualities:
        raise NotImplementedError(
            f"eliminateEqualities is not ported yet ({_ROADMAP})")

    device = torch.device(device)
    user_kktsolver = kktsolver is not None
    if kktsolver is None:
        # structure check on the host originals, before any device transfer
        kktsolver = _auto_kktsolver(Q, A, G, spec)
    auto_diag = getattr(kktsolver, "func", None) is kktsolver_diag
    if centralityCorrectors is None:
        centralityCorrectors = 0 if (user_kktsolver or auto_diag) else 1

    c = _densify(c, dtype, device)
    n = c.shape[0]
    Q = _densify(Q, dtype, device)
    A = _densify(A, dtype, device)
    b = _densify(b, dtype, device)
    G = (_densify(G, dtype, device) if G is not None
         else torch.zeros((0, n), dtype=dtype, device=device))
    d = (_densify(d, dtype, device) if d is not None
         else torch.zeros((0,), dtype=dtype, device=device))

    opts = IPMOptions(
        optTol=optTol,
        DTB=DTB,
        verbose=verbose,
        maxRefinementSteps=maxRefinementSteps,
        maxIters=maxIters,
        cache_nestodd=cache_nestodd,
        infeasTol=infeasTol,
        refinementThreshold=refinementThreshold,
        centralityCorrectors=centralityCorrectors,
    )
    warm = _user_warm_vec(warm_start, A, b, G.shape[0])
    sol = Solution.from_state(
        ipm_solve(Q, c, A, b, G, d, spec, kktsolver, opts, warm=warm))
    if verbose:
        _exit_banner(sol.status)
    return sol


def _user_warm_vec(warm_start, A, b, p) -> Optional[Vec4]:
    """The internal warm-start iterate from a previous :class:`Solution`
    (anything with ``y``/``w``/``v``) or a ``(y, w, v)`` tuple, on A's
    device and dtype. None (a cold start) when absent or non-finite."""
    if warm_start is None:
        return None
    if hasattr(warm_start, "y"):
        y, w, v = warm_start.y, warm_start.w, warm_start.v
    else:
        y, w, v = warm_start
    like = dict(dtype=A.dtype, device=A.device)
    y = _densify(y, **like)
    v = _densify(v, **like)
    w = torch.zeros(p, **like) if w is None else _densify(w, **like)
    if (tuple(w.shape) != (p,) or tuple(y.shape) != (A.shape[1],)
            or tuple(v.shape) != (A.shape[0],)):
        raise ValueError("warm_start dimensions do not match the problem")
    if not bool(torch.isfinite(y).all() & torch.isfinite(w).all()
                & torch.isfinite(v).all()):
        return None
    # shifted strictly into the cone by ipm_solve
    return Vec4(y, w, v, A @ y - b)


def _exit_banner(status: str) -> None:
    msgs = {
        "Infeasible": "\n > EXIT -- Certificate of Infeasibility Found!\n",
        "Unbounded": "\n > EXIT -- Certificate of Dual Infeasibility Found!\n",
        "Optimal": "\n > EXIT -- Below Tolerance!\n",
        "Error": "\n > EXIT -- Error!\n",
        "Abandoned": "\n > EXIT -- Maximum iterations reached.\n",
    }
    print(msgs.get(status, ""))
