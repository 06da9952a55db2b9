"""User-facing solver API of the PyTorch port.

Counterpart of ``conicip_tpu/solver/__init__.py``: :func:`conic_ip` with
the reference's keywords, defaults and semantics, the automatic backend
choice, null-space elimination of equalities, and the precision-escalation
ladder behind ``factor_dtype=torch.float32``. On hardware with native f64
(the CPU and CUDA devices this package runs on) the default is
full-precision factors, no mixed residuals and the direct saddle path.
"""

from __future__ import annotations

import functools
from typing import NamedTuple, Optional, Sequence, Tuple

import numpy as np
import torch

from .. import telemetry
from ..cones.spec import ConeSpec
from ..kkt.diag import equality_mode, kktsolver_diag, separable
from ..kkt.schur import kktsolver_schur
from ..kkt.spectral import spectral_applicable, spectral_kktsolver
from ..ops.control import eager_reason
from ..reduce import eliminate_equalities
from . import graph
from .ipm import IPMOptions, ipm_solve
from .state import SolState, Solution, Status, Vec4, to_host

__all__ = ["conic_ip", "Solution", "SolState", "Status", "IPMOptions", "Vec4",
           "ipm_solve", "resolve_factor_dtype"]

class Run(NamedTuple):
    """One interior-point run inside a :func:`conic_ip` call."""

    kktsolver: object
    status: str
    Iter: int
    # steps on the generator's fast (or only) variant and on its
    # full-precision last-mile variant; on either loop, for a stack, the
    # iterations on which some instance took one (a split stack's count in
    # both), which on the device loop are the variant's KKT builds
    fast_steps: int
    slow_steps: int
    cold_start: int  # 1 when the initial point cost a KKT build
    recertified: int  # mixed mode: full-precision product recomputes
    # host reads of the loop's status: on the card's WHILE node 1, the
    # final copy; on the CPU's chunks (and with verbose output on the
    # card) one after the prologue and one per chunk; on the eager loop
    # one or two per iteration
    polls: int
    # CUDA graph replays of the loop: of the WHILE node's graph (1), or
    # with verbose output of the chunk
    replays: int
    # units the device loop ran (ipm.POLL per chunk), counted on the card
    # and read in the final copy; on the CPU's chunks POLL * (polls - 1);
    # 0 on the eager loop. A miss on the card runs its first unit eagerly
    # as a warm-up and counts it, also where the prologue already ended
    # the solve (a frozen unit: POLL where the eager loop took no step)
    units: int
    # "graph", "chunks" (the device loop) or "eager" (kktsolver_schur_tp
    # over gloo on CUDA, a caller's callable that reads the device:
    # _eager_reason)
    loop: str
    trips: int  # refinement trips run (on a stack: some instance went on)
    cache_hit: bool  # the device loop's entry was kept from an earlier call
    reason: Optional[str] = None  # why the run kept the eager loop
    # device ns of each phase of the device loop (telemetry.PHASES),
    # prologue and units: on the card from an entry captured with
    # telemetry on, on the CPU's chunks from the host's clock; else None
    phases: Optional[dict] = None
    # the call's spans (telemetry.Record), shared by its runs
    spans: Optional[telemetry.Record] = None


# Every interior-point run of the latest conic_ip call, in order: the first
# attempt, then whatever the escalation ladder, the elimination path's
# retry and its fallback added. A diagnostic: nothing in the solver reads it.
runs: list = []


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


def _host64(X) -> np.ndarray:
    return X.detach().cpu().numpy().astype(np.float64, copy=False)


def resolve_factor_dtype(factor_dtype):
    """Resolve the ``"auto"`` factorization-precision default: ``None``
    (factor in the working dtype), the reference's rule for hardware with
    native f64, which the CPU and CUDA devices both are. A concrete dtype
    pins one; ``torch.float32`` selects f32 factors with mixed residuals,
    the in-loop last-mile escalation and the ladder behind it."""
    if isinstance(factor_dtype, str):
        if factor_dtype != "auto":
            raise ValueError(f"unknown factor_dtype {factor_dtype!r}")
        return None
    return factor_dtype


@functools.lru_cache(maxsize=None)
def _default_kktsolver(factor_dtype, assemble_dtype=None, lastmile=False):
    """The dense Schur backend at one precision configuration (one object
    per configuration)."""
    if factor_dtype is None and assemble_dtype is None and not lastmile:
        return kktsolver_schur
    return functools.partial(
        kktsolver_schur, factor_dtype=factor_dtype,
        assemble_dtype=assemble_dtype, lastmile=lastmile)


@functools.lru_cache(maxsize=None)
def _diag_kktsolver(factor_dtype, eq_mode="woodbury"):
    if factor_dtype is None and eq_mode == "woodbury":
        return kktsolver_diag
    return functools.partial(kktsolver_diag, factor_dtype=factor_dtype,
                             eq_mode=eq_mode)


def _eager_reason(kktsolver, device) -> Optional[str]:
    """Why a run keeps the eager loop (one host read per iteration), or
    None when it takes the device loop (``ipm.POLL`` units per host read,
    through solver/graph.py's cache; on CUDA captured CUDA graphs, kept
    across calls), as the reference's ``_solve_jit`` traces whatever
    kktsolver it is given. The device loop takes every kktsolver: the
    package's own, chosen here or passed by a caller, at every precision,
    and a caller's own callable; with verbose output too (the host prints
    each unit's row at its poll, as the reference prints from inside its
    loop through ``jax.debug.callback``). Two cases keep the eager loop,
    decided here before the solve: ``kktsolver_schur_tp`` over a gloo
    group on CUDA tensors (gloo stages its collectives through host
    memory, which a CUDA graph cannot hold), and a caller's callable that
    an earlier call on CUDA found to read the device. That finding is the
    one choice of loop made during a call: the first miss of a caller's
    callable on CUDA runs its callbacks under ``ops.control.guarded``
    before any capture, and where one reads the device (``.item()``,
    ``torch.linalg.cholesky``, a pageable host-to-device copy) the run
    starts over on the eager loop, ``Run.reason`` naming the read (not a
    fallback that hides the device: it stays on the card, and ``Run.loop``
    shows it). No option of the run decides. ``solve_batch`` applies this rule to its runs, and keeps the
    backstop's sub-batches eager (parallel/batch.py)."""
    return eager_reason(kktsolver, device)


def _is_diag(kktsolver) -> bool:
    return (kktsolver is kktsolver_diag
            or getattr(kktsolver, "func", None) is kktsolver_diag)


def _auto_kktsolver(Q, A, G, spec, factor_dtype):
    """Default backend, as the reference chooses it on its host data: a
    separable problem (diagonal Q, bound-style A, R cones, and an exact
    equality mode) takes the diagonal Schur solver; a PSD-projection
    structure (``A = I``, ``Q = q·I``, no equalities, any cone mix) the
    closed-form spectral solver; everything else the dense Schur solver,
    which with f32 factors gets the in-loop last-mile full-precision
    variant."""
    if separable(Q, A, G, spec):
        mode = equality_mode(Q, G)
        return _diag_kktsolver(
            factor_dtype, "woodbury" if mode in (None, "none") else mode)
    if spectral_applicable(Q, A, G, spec):
        return spectral_kktsolver(None)
    return _default_kktsolver(
        factor_dtype, lastmile=factor_dtype == torch.float32)


@telemetry.entry
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
    dtype=None,
    mixedResiduals: Optional[bool] = None,
    eliminateEqualities: Optional[bool] = None,
    lastmileProactive: Optional[float] = None,
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
    Signature- and semantics-compatible with ``conicip_tpu.conic_ip``, and
    it picks the same default backend. Inputs may be numpy arrays,
    scipy.sparse matrices or tensors; they are moved to ``device`` in
    ``dtype`` (default float64), and the returned :class:`Solution` holds
    ``y``, ``w``, ``v`` as tensors there.
    ``kktsolver`` is the 3-level plugin callback (:mod:`conicip_tpu_torch.kkt`).
    ``centralityCorrectors=None`` means 1 on the dense Schur and spectral
    backends, 2 on equality-eliminated problems, and 0 on the diagonal
    backend and for user callbacks.
    ``warm_start`` takes a previous ``Solution`` or a ``(y, w, v)`` tuple.

    ``factor_dtype=torch.float32`` runs the per-iteration factors in f32
    with iterative refinement recovering the working dtype's accuracy. It
    brings, by default: ``mixedResiduals`` (f32 residual products,
    recertified in full precision near the tolerances), the last-mile
    switch to full-precision factors near tolerance
    (``lastmileProactive``, default 50 x optTol), null-space elimination of
    equalities (``eliminateEqualities``), and, when the solve still ends
    ``Abandoned`` or ``Error``, warm-started re-solves at higher precision.
    The default ``"auto"`` is ``None``: full-precision factors
    (:func:`resolve_factor_dtype`).
    """
    dtype = dtype or torch.float64
    device = torch.device(device)
    factor_dtype = resolve_factor_dtype(factor_dtype)
    del runs[:]
    if lastmileProactive is None:
        # on by default for the automatic f32 path: entering the
        # full-precision branch at 50x tolerance replaces the one or two
        # fast iterations a reactive stall detection wastes
        lastmileProactive = (
            50.0 if factor_dtype == torch.float32 and kktsolver is None
            else 0.0)
    p = 0 if G is None else G.shape[0]
    if eliminateEqualities is None:
        # the double-Schur equality path squares the conditioning an f32
        # factor has to survive; the null-space transform restores the
        # p = 0 path. Full-precision factors keep the direct saddle.
        eliminateEqualities = (
            factor_dtype == torch.float32 and p > 0 and kktsolver is None)

    c = _densify(c, dtype, device)
    n = c.shape[0]
    tensors = (
        _densify(Q, dtype, device), c, _densify(A, dtype, device),
        _densify(b, dtype, device),
        (_densify(G, dtype, device) if G is not None
         else torch.zeros((0, n), dtype=dtype, device=device)),
        (_densify(d, dtype, device) if d is not None
         else torch.zeros((0,), dtype=dtype, device=device)),
    )
    options = dict(
        kktsolver=kktsolver, optTol=optTol, DTB=DTB, verbose=verbose,
        maxRefinementSteps=maxRefinementSteps, maxIters=maxIters,
        cache_nestodd=cache_nestodd, infeasTol=infeasTol,
        refinementThreshold=refinementThreshold, factor_dtype=factor_dtype,
        mixedResiduals=mixedResiduals, lastmileProactive=lastmileProactive,
        centralityCorrectors=centralityCorrectors)
    if eliminateEqualities and p > 0:
        return _solve_eliminated(tensors, (Q, A, G), cone_dims, warm_start,
                                 options)
    return _solve_direct(tensors, (Q, A, G), cone_dims, warm_start, options)


def _solve_direct(tensors, structure, cone_dims, warm_start, options
                  ) -> Solution:
    """The direct saddle path on device operands. ``structure`` is
    ``(Q, A, G)`` as the caller holds them (host data wherever the caller
    gave host data), which the one-time backend choice reads."""
    Q, c, A, b, G, d = tensors
    o = dict(options)
    kktsolver = o.pop("kktsolver")
    factor_dtype = o.pop("factor_dtype")
    mixedResiduals = o.pop("mixedResiduals")
    centralityCorrectors = o.pop("centralityCorrectors")
    lastmileProactive = o.pop("lastmileProactive")
    verbose = o["verbose"]
    dtype = c.dtype

    spec = ConeSpec(cone_dims)
    user_kktsolver = kktsolver is not None
    if kktsolver is None:
        kktsolver = _auto_kktsolver(*structure, spec, factor_dtype)
    if centralityCorrectors is None:
        # 1 Gondzio corrector on the dense factorization paths, where a
        # corrector back-solve costs a small fraction of the
        # refactorization it can save; 0 on the diagonal backend and for
        # user callbacks
        centralityCorrectors = (
            0 if (user_kktsolver or _is_diag(kktsolver)) else 1)
    if mixedResiduals is None:
        mixedResiduals = (factor_dtype == torch.float32
                          and dtype == torch.float64)

    def run(kkt, mixed, proactive, warm):
        opts = IPMOptions(mixedResiduals=mixed, lastmileProactive=proactive,
                          centralityCorrectors=centralityCorrectors, **o)
        stats = {}
        args = (Q, c, A, b, G, d, spec, kkt, opts)
        reason = _eager_reason(kkt, c.device)
        if reason is None:
            st = graph.solve(*args, warm=warm, stats=stats)
        else:
            st = ipm_solve(*args, warm=warm, stats=stats)
            stats["reason"] = reason
        with telemetry.span(telemetry.FINISH):
            sol = Solution.from_state(st)
            runs.append(Run(kkt, sol.status, sol.Iter, **stats,
                            spans=telemetry.current()))
        return sol

    sol = run(kktsolver, mixedResiduals, lastmileProactive,
              _user_warm_vec(warm_start, A, b, G.shape[0]))

    # Escalation ladder. An f32 factor stalls once κ(M) ~ 1/μ exceeds
    # ~1/eps_f32. When the fast mode ends without a definitive status
    # (near a solution or far from one: certificates are what an f32 mode
    # fails to sharpen), re-solve warm from the best iterate, first with
    # the f64-assembled f32 factor (assembly cancellation, measured on SOC
    # mixes in the reference; futile on S cones, where the factor itself
    # is the floor), then in the full working dtype. Only the default
    # backend escalates: a user's kktsolver is used as given.
    def stalled(s: Solution) -> bool:
        return s.status in ("Abandoned", "Error")

    def warm_from(s: Solution) -> Optional[Vec4]:
        sb = A @ s.y - b
        ok = (torch.isfinite(s.y).all() & torch.isfinite(s.v).all()
              & torch.isfinite(sb).all() & torch.isfinite(s.w).all())
        return Vec4(s.y, s.w, s.v, sb) if bool(ok) else None

    if factor_dtype == torch.float32 and not user_kktsolver and stalled(sol):
        ladder = ([] if spec.sdp_groups else
                  [(_default_kktsolver(torch.float32, torch.float64), True)])
        ladder.append((_default_kktsolver(None), False))
        for kkt_next, mixed_next in ladder:
            cand = run(kkt_next, mixed_next, 0.0, warm_from(sol))
            # keep whichever is better if the tier also stalled
            if (max(cand.prFeas, cand.duFeas, cand.muFeas)
                    <= max(sol.prFeas, sol.duFeas, sol.muFeas)
                    or not stalled(cand)):
                sol = cand
            if not stalled(sol):
                break

    if verbose:
        _exit_banner(sol.status)
    return sol


def _solve_eliminated(tensors, structure, cone_dims, warm_start, options
                      ) -> Solution:
    """Solve with the equalities removed by the null-space transform
    (:mod:`conicip_tpu_torch.reduce`), then recover the full-space solution.
    The transform and the recovery are one-time host f64 steps; the reduced
    operands go to the device once."""
    Q, c, A, b, G, d = tensors
    like = dict(dtype=c.dtype, device=c.device)
    Qh, ch, Ah, bh, Gh, dh = (_host64(X) for X in tensors)
    red = eliminate_equalities(Qh, ch, Ah, bh, Gh, dh)
    p, n = Gh.shape
    direct = dict(options)
    centralityCorrectors = direct["centralityCorrectors"]

    def tensor(x):
        return torch.as_tensor(np.ascontiguousarray(x), **like)

    def solution(sub, y, w, **fields):
        return Solution(
            y=tensor(y), w=tensor(w), v=sub.v, status=sub.status,
            Iter=sub.Iter, Mu=sub.Mu, prFeas=sub.prFeas,
            duFeas=fields.get("duFeas", sub.duFeas), muFeas=sub.muFeas,
            pobj=fields.get("pobj", sub.pobj),
            dobj=fields.get("dobj", sub.dobj))

    if red.consistent and red.Z.shape[1] == 0:
        # G pins y completely: a 0-variable reduced problem would crash the
        # IPM; the direct saddle path handles the degenerate case. (As in
        # the reference, this call takes the default last-mile trigger.)
        direct["lastmileProactive"] = (
            50.0 if direct["factor_dtype"] == torch.float32
            and direct["kktsolver"] is None else 0.0)
        return _solve_direct(tensors, structure, cone_dims, warm_start,
                             direct)
    if not red.consistent:
        # inconsistent equalities: the preprocessor's answer
        nan = float("nan")
        return Solution(
            y=torch.full((n,), nan, **like), w=torch.full((p,), nan, **like),
            v=torch.full((Ah.shape[0],), nan, **like), status="Infeasible",
            Iter=0, Mu=nan, prFeas=nan, duFeas=nan, muFeas=nan, pobj=nan,
            dobj=nan)

    # A user warm start maps into the reduced space: y = y0 + Zx with Z
    # orthonormal ⇒ x = Zᵀ(y − y0); the cone dual v carries over unchanged
    # (same cones, A_red = A Z rows).
    sub_warm = None
    if warm_start is not None:
        ws = warm_start
        y_w = np.asarray(to_host(ws.y if hasattr(ws, "y") else ws[0]), float)
        v_w = np.asarray(to_host(ws.v if hasattr(ws, "v") else ws[2]), float)
        if (y_w.shape == (n,) and np.all(np.isfinite(y_w))
                and np.all(np.isfinite(v_w))):
            sub_warm = (red.Z.T @ (y_w - red.y0), None, v_w)

    red_tensors = (tensor(red.Q), tensor(red.c), tensor(red.A), tensor(red.b),
                   torch.zeros((0, red.Z.shape[1]), **like),
                   torch.zeros((0,), **like))
    red_structure = (red.Q, red.A, None)
    reduced = dict(options)
    if centralityCorrectors is None:
        # reduced (equality-origin) problems save one further iteration at
        # K = 2 in the reference's sweeps, with no regressions
        reduced["centralityCorrectors"] = 2

    def dual_residual(y, w, v):
        r = Qh @ y + Gh.T @ w - (Ah.T @ v if Ah.size else 0.0) - ch
        return np.linalg.norm(r) / (1.0 + np.linalg.norm(ch))

    # The least-squares dual recovery can amplify the reduced-space dual
    # residual by a modest factor; when the recovered full-space rDu misses
    # optTol, one retry at a tighter reduced tolerance closes the gap.
    optTol = options["optTol"]
    for sub_tol in (optTol, optTol * 0.02):
        reduced["optTol"] = sub_tol
        sub = _solve_direct(red_tensors, red_structure, cone_dims, sub_warm,
                            reduced)
        if sub.status != "Optimal":
            break
        v = _host64(sub.v)
        y = red.recover_y(_host64(sub.y))
        w = red.recover_w(y, v)
        if dual_residual(y, w, v) < optTol:
            break

    if sub.status in ("Abandoned", "Error"):
        # the null-space transform can make some problems numerically
        # harder (Z mixes structure away): fall back to the direct saddle
        # path, whose own precision ladder handles f32 equality stalls
        direct["centralityCorrectors"] = reduced["centralityCorrectors"]
        return _solve_direct(tensors, structure, cone_dims, warm_start,
                             direct)

    v = _host64(sub.v)
    if sub.status == "Unbounded":
        # reduced ray x: y = Zx is a full-space ray (Gy = 0 by construction)
        return solution(sub, red.Z @ _host64(sub.y), np.full(p, np.nan))
    if sub.status == "Infeasible":
        # Farkas pair: extend v with the least-squares w solving Gᵀw = Aᵀv.
        # The reduced normalization −b̃ᵀv equals the full −(dᵀw − bᵀv).
        return solution(sub, np.full(n, np.nan), red.recover_w_cert(v))

    y = red.recover_y(_host64(sub.y))
    w = red.recover_w(y, v)
    # full-space dual residual and objectives with the recovered w
    pobj = 0.5 * float(y @ (Qh @ y)) - float(ch @ y)
    return solution(sub, y, w, duFeas=float(dual_residual(y, w, v)),
                    pobj=pobj, dobj=pobj - (sub.pobj - sub.dobj))


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
