"""Mehrotra predictor-corrector interior-point core.

Counterpart of ``conicip_tpu/solver/ipm.py``, over any product of R, Q and
S cones. The JAX package runs the whole solve as one ``lax.while_loop``;
here one iteration is a function of a carry (:class:`Carry`: the iterate,
the best-iterate record, the best residual, the stall count, and the
iteration number and the steps taken as device integers), and two loops
drive it:

- the device loop (``device_loop``, :func:`device_prologue`): a prologue
  (the level-1 callback, the initial point and its evaluation), then units
  of *step, then evaluate*, :data:`POLL` at a time with no host read and no
  early exit, while any instance is still running (the loop's predicate,
  ``more``, capped at ``maxIters + 1`` units), so the loop stops before a
  step that would change nothing, where the eager loop and the reference
  stop. On CUDA ``solver/graph.py`` captures the prologue and the loop in
  CUDA graphs, kept across calls: the loop is one conditional WHILE node
  whose body is a chunk, so the device decides when the loop ends and the
  host reads once, after the solve, as the reference's
  ``lax.while_loop`` does (with verbose output the chunk is replayed and
  the predicate read by the host after each). On the CPU
  :func:`run_chunks` runs the chunks eagerly, the host reading the
  predicate once after the prologue and once per chunk. A unit past the end (the solve
  finished inside a chunk, or ``k > maxIters``) changes nothing: every
  carried value is frozen by mask, ``pobj``/``dobj`` included. What the
  reference decides by ``lax.cond`` is handed to a ``branch(pred, body)``
  (:func:`masked`, which runs the body and takes its results by mask; on
  CUDA a conditional graph node, which runs it only while ``pred``
  holds): each refinement trip, the mixed-residual recompute (the
  reference's ``cond_once``) and, with a two-variant generator, each
  variant's scaling and step, so that a single solve builds one variant
  per iteration and a stack split across the variants builds both. The
  last-mile flag, the carried products and their drift are part of the
  carry, the Schur backend's ridge retries are predicated factors
  (ops/control.py), and what a generator decides by ``control.cond`` (the
  distributed factor's ridge retry) is a body of the same ``branch``,
  bound around every level-2 call, so nothing reads back inside a unit.
- the eager loop (``device_loop=None``). The callers decide before the
  solve which loop a run takes (``solver._eager_reason``): every
  kktsolver, the package's own and a caller's, takes the device loop,
  verbose output too (the host prints each unit's row at its poll, as the
  reference prints from inside its loop); this one keeps
  ``kktsolver_schur_tp`` over a gloo group on CUDA tensors (gloo stages
  its collectives through host memory, which a graph cannot hold) and a
  caller's callable whose callbacks read the device (``control.guarded``
  finds that before a capture: such a run starts over here, the one
  choice of loop made during a call). ``solve_batch`` also keeps the
  backstop's sub-batches on this one. It reads the status once per
  iteration and stops there, stops refinement as soon as no instance goes
  on, and runs a generator's ``control.cond`` bodies after a host read of
  their predicate.

Both loops run the same arithmetic (``evaluate``, ``take_step``; the
eager loop's ``advance``, the device loop's ``unit``), and everything else
is mask-based on the device, as in the reference:

- same initial point, residual normalizations and CVXOPT+ECOS
  infeasibility certificates,
- best-iterate tracking (``Iter`` is the best iterate's ``k``; ``pobj`` and
  ``dobj`` always follow the latest iterate),
- iterative refinement with its stall cutoff, fraction-to-boundary step,
  non-finite scrubbing and optional Gondzio centrality correctors,
- the λ-frame max-steps and Lyapunov divisions when S cones are present.

A spec whose cones are all R (:func:`_fused_r`) takes the R cones' fused
sequence of ``ops/rcone.py`` for its scaling, 4x4 reduction,
complementarity vectors and steps (the hand kernels of ``csrc/rcone.cu``
on the card; on the CPU plain twins that are the generic sequence's
bits); every other spec the generic ``cones/`` calls.

Mixed-precision options (all off by default; on hardware with native f64
the full-precision path is the default):

- ``mixedResiduals``: every residual product runs in f32 against one-time
  f32 copies of the operators and is carried across iterations by the
  incremental update ``P ← P − α·K·Δz``, with ``drift`` bounding the
  accumulated error in relative-residual units. The products are recomputed
  in the working dtype only when a tolerance decision is near and the drift
  could affect it, so convergence and certificates are only ever decided
  on full-precision values.
- a KKT generator that takes ``mode="fast"|"slow"`` (kkt/schur.py with
  ``lastmile``) is switched, once and for good, to its full-precision
  variant when the low-precision factor stalls near tolerance or breaks
  down; only the variant picked factors.

Both decisions are taken on the device. The eager loop brings them to the
host in the iteration's one status read (a firing recompute reads a
second time, in that iteration only); the device loop keeps them there.

A stack of instances. Every operand may carry leading batch dims (Q
(..., n, n), c (..., n), A (..., m, n), b (..., m); G and d stacked or
shared), which is what ``jax.vmap`` made of the reference's solve and is
written out here: status, ``Iter``, the best residual, the stall counter,
the last-mile flag, the drift and every step length are one value per
instance; no reduction crosses instances, so a NaN instance cannot reach
its neighbours; the loop runs while any instance is ``RUNNING``, and every
carried value of a finished instance is frozen by mask, so its ``Iter``,
status and iterate are those of its own single solve. The eager loop reads
once per iteration, for the whole stack: whether any instance runs, fires a
recompute, or needs either variant of a two-variant generator. When
instances of one stack are on different variants, both are built on that
iteration and each instance takes its own. A single solve is the case
without leading dims and runs the same code.
"""

from __future__ import annotations

import functools
from dataclasses import dataclass, is_dataclass, replace
from types import SimpleNamespace
from typing import Callable, NamedTuple, Optional

import torch

from .. import telemetry
from ..cones import algebra as ca
from ..cones import scaling as sc
from ..cones.spec import ConeSpec
from ..kkt.pivot import accepts_mode
from ..ops import control, rcone
from ..ops.batched import col, dot, mv
from .state import SolState, Status, Vec4

__all__ = ["IPMOptions", "ipm_solve", "device_prologue", "run_chunks",
           "loop_counts", "masked", "on_host", "Carry", "POLL", "ROW",
           "polled", "poll", "read_polled"]

# Units per chunk of the device loop: the body of solver/graph.py's WHILE
# node, and on the CPU (and with verbose output) the units between two
# host reads of the status. A solve runs up to
# POLL - 1 frozen units past its end (each a masked step, KKT build
# included; on the card a two-variant generator's variants, conditional
# bodies, build nothing there). 1 had the least wall time of 1, 2, 4 and
# 8 on every solve timed on the H100 (PERF.md §6).
POLL = 1

# Values of one verbose row (:func:`_row`): whether it is printed (the
# iterate was evaluated), then k, rPr, rDu, rCp, pobj, dobj, p_inf, d_inf,
# and the refinement count and residual of the step that led to it.
ROW = 11


@dataclass(frozen=True)
class IPMOptions:
    """Solver options (kwarg-compatible with ``conicip_tpu.IPMOptions``)."""

    optTol: float = 1e-6
    DTB: float = 0.01  # fraction-to-boundary
    verbose: bool = False
    maxRefinementSteps: int = 3
    maxIters: int = 100
    cache_nestodd: bool = False  # accepted and unused, as in the reference
    infeasTol: Optional[float] = None
    refinementThreshold: Optional[float] = None
    # f32 residual products with full-precision recertification near the
    # tolerances (module docstring); conic_ip turns it on with
    # factor_dtype=float32 over a float64 working dtype
    mixedResiduals: bool = False
    # "near" means within this factor of a tolerance
    residualSwitch: float = 50.0
    # Gondzio centrality correctors per iteration; 0 disables
    centralityCorrectors: int = 0
    # S-cone decompositions of the fast phase in f32. None: when the
    # two-variant KKT generator gives an in-loop full-precision escape.
    # True: also without one (the caller re-solves a breakdown at higher
    # precision). False: always the working dtype.
    fastEig: Optional[bool] = None
    # route full-precision S-cone decompositions through eig_dtype="refined"
    # (cones/algebra.py: the same function as the stock decomposition here)
    refinedEig: Optional[bool] = None
    # None: use a generator's fast/slow ``mode`` contract when it has one.
    # False: pin the fast variant; the caller owns escalation.
    twoModeKKT: Optional[bool] = None
    # also enter the generator's full-precision variant once the residual
    # is within this factor of tolerance (0: only on a stall or breakdown)
    lastmileProactive: float = 0.0
    # end Abandoned after this many consecutive non-improving iterations
    # once the best residual is within residualSwitch x optTol; None
    # disables
    stallCutoff: Optional[int] = None

    @property
    def infeas_tol(self) -> float:
        return self.optTol if self.infeasTol is None else self.infeasTol

    @property
    def refinement_threshold(self) -> float:
        return (
            self.optTol / 1e7
            if self.refinementThreshold is None
            else self.refinementThreshold
        )


def _norm(x):
    """Euclidean norm along the last axis, 0 for an empty one."""
    if x.shape[-1]:
        return torch.linalg.norm(x, dim=-1)
    return x.new_zeros(x.shape[:-1])


class _Products(NamedTuple):
    """The three stacked mat-vecs everything per-iteration derives from."""

    Qy: torch.Tensor  # Q @ y                       (..., n)
    GAy: torch.Tensor  # [G; A] @ y                 (..., p+m)
    GAtwv: torch.Tensor  # [Gᵀ, -Aᵀ] @ [w; v]       (..., n)


class _Resid(NamedTuple):
    rleft: Vec4
    r0: Vec4
    mu: torch.Tensor
    mubar: torch.Tensor
    cty: torch.Tensor
    rDu: torch.Tensor
    rPr: torch.Tensor
    rCp: torch.Tensor
    rmax: torch.Tensor
    pobj: torch.Tensor
    dobj: torch.Tensor
    p_infeas: torch.Tensor
    d_infeas: torch.Tensor


def _finite_rows(*xs) -> torch.Tensor:
    """Per instance: every entry of every vector finite."""
    ok = torch.isfinite(xs[0]).all(-1)
    for x in xs[1:]:
        ok = ok & torch.isfinite(x).all(-1)
    return ok


def _finite_each(*xs) -> torch.Tensor:
    """Per instance: every one of the per-instance scalars finite."""
    ok = torch.isfinite(xs[0])
    for x in xs[1:]:
        ok = ok & torch.isfinite(x)
    return ok


def _select(mask, new, old):
    """Per-instance choice between two values of the loop's carried state:
    tensors (``mask`` gets trailing unit dims), and records (iterates,
    residuals, scalings) and tuples of them, field by field. Anything else
    (a host count, None) is taken from ``new``."""
    if isinstance(new, torch.Tensor):
        old = torch.as_tensor(old, dtype=new.dtype, device=new.device)
        pick = mask.reshape(mask.shape + (1,) * (
            max(new.dim(), old.dim()) - mask.dim()))
        return torch.where(pick, new, old)
    if is_dataclass(new):
        return type(new)(**{f: _select(mask, getattr(new, f), getattr(old, f))
                            for f in new.__dataclass_fields__})
    if isinstance(new, tuple):
        vals = [_select(mask, a, b) for a, b in zip(new, old)]
        return type(new)(*vals) if hasattr(new, "_fields") else tuple(vals)
    return new


def _operands(Q, c, A, b, G, d, spec: ConeSpec):
    """The operands checked against each other and the spec, a shared
    equality system expanded over a stack's instances."""
    n = c.shape[-1]
    m = A.shape[-2]
    p = G.shape[-2]
    bs = tuple(c.shape[:-1])  # the stack's shape; () for a single solve
    if bs:
        # a shared equality system serves every instance
        if G.dim() == 2:
            G = G.expand(bs + G.shape)
        if d.dim() == 1:
            d = d.expand(bs + d.shape)
    if Q.shape != bs + (n, n):
        raise ValueError("Q is not square / inconsistent with objective")
    if b.shape != bs + (m,):
        raise ValueError("Inconsistency in inequalities")
    if A.shape != bs + (m, n):
        raise ValueError("Inconsistency in inequalities/objective")
    if d.shape != bs + (p,):
        raise ValueError("Inconsistency in equalities")
    if G.shape != bs + (p, n):
        raise ValueError("Inconsistency in equalities/objective")
    if spec.m != m:
        raise ValueError("cone dimensions do not sum to size(A, 1)")
    return Q, c, A, b, G, d


@functools.lru_cache(maxsize=None)
def _identity(spec: ConeSpec, dtype, device) -> torch.Tensor:
    """The cone identity ``e`` on a device: one tensor per configuration,
    made by the first solve, eagerly, so that a captured prologue
    (solver/graph.py) copies nothing from the host."""
    return torch.tensor(spec.identity, dtype=dtype, device=device)


def _fused_r(spec: ConeSpec) -> bool:
    """Whether the R cones' kernels (ops/rcone.py) carry the iteration's
    cone work: the spec's cones are all R. Any other spec runs the generic
    ``cones/`` sequence, its R segment included."""
    return spec.only_r and spec.m > 0


def masked(pred, body):
    """A body of the device loop without a conditional node: it runs, and
    what it computes is taken by mask (a refinement trip's writes by its
    latched stopping test, a variant's results by the last-mile flag, a
    recompute's by its own), so it changes nothing where ``pred`` is
    false. Returns the body's result."""
    return body()


def on_host(pred, body):
    """A body of the device loop as the eager loop runs it: after a host
    read of ``pred``, and only when it holds. Returns the body's result,
    or None. solver/graph.py runs the first unit of a capture so."""
    return body() if bool(pred) else None


def _loop(Q, c, A, b, G, d, spec: ConeSpec, kktsolver, opts: IPMOptions,
          warm: Optional[Vec4], branch):
    """Everything one solve's iterations read, and the functions of a
    carry they are made of, over checked operands (:func:`_operands`):
    the norms and stacked operators of the residuals, the cone identity,
    the level-1 generator (the LEVEL-1 plugin callback) and the initial
    iterate, an unevaluated :class:`Carry` (``cy0``). Nothing here reads the
    device: under ``device_prologue`` this is captured in a CUDA graph.
    ``branch`` runs what a generator decides by ``control.cond`` in the
    initial point's level-2 call (:func:`masked`, :func:`on_host` or a
    conditional graph node)."""
    n = c.shape[-1]
    m = A.shape[-2]
    p = G.shape[-2]
    bs = tuple(c.shape[:-1])
    dtype, dev = c.dtype, c.device

    def scalar(x):
        return torch.full((), x, dtype=dtype, device=dev)

    def each(x):
        # one value per instance
        return torch.full(bs, x, dtype=dtype, device=dev)

    nan, inf = scalar(float("nan")), scalar(float("inf"))
    e = _identity(spec, dtype, dev)
    fused = _fused_r(spec)
    conedim = spec.conedim
    normc = torch.linalg.norm(c, dim=-1)
    normb = _norm(b)
    normd = -inf if p == 0 else torch.linalg.norm(d, dim=-1)

    # Stacked residual operators: GA = [G; A], GAt = [Gᵀ, -Aᵀ], so that
    # rleft.y = Qy + GAt@[w;v], rleft.w = GAy[:p], rleft.v = GAy[p:] - s.
    GA = torch.cat([G, A], dim=-2)
    GAt = torch.cat([G.mT, -A.mT], dim=-1)

    mixed = bool(opts.mixedResiduals) and dtype != torch.float32
    if mixed:
        f32 = torch.float32
        Q32, GA32, GAt32 = Q.to(f32), GA.to(f32), GAt.to(f32)

    def products_full(y, w, v):
        return _Products(mv(Q, y), mv(GA, y),
                         mv(GAt, torch.cat([w, v], dim=-1)))

    def products_fast(y, w, v):
        if not mixed:
            return products_full(y, w, v)
        y32 = y.to(f32)
        wv32 = torch.cat([w, v], dim=-1).to(f32)
        return _Products(mv(Q32, y32).to(dtype), mv(GA32, y32).to(dtype),
                         mv(GAt32, wv32).to(dtype))

    def residual_block(P: _Products, z: Vec4, lam, sq=None) -> _Resid:
        # sq: λ∘λ and z.vᵀz.s where the scaling's pass made them (scaled)
        lam2, mubar = sq or (ca.cone_prod(spec, lam, lam), dot(z.v, z.s))
        rleft = Vec4(P.Qy + P.GAtwv, P.GAy[..., :p], P.GAy[..., p:] - z.s,
                     lam2)
        r0 = Vec4(rleft.y - c, rleft.w - d, rleft.v - b, rleft.s)

        mu = mubar / conedim
        cty = dot(c, z.y)
        rDu = torch.linalg.norm(r0.y, dim=-1) / (1.0 + normc)
        rPr = _norm(r0.v) / (1.0 + normb)
        rCp = _norm(r0.s) / (1.0 + torch.abs(cty))
        rmax = torch.maximum(rDu, torch.maximum(rPr, rCp))
        pobj = 0.5 * dot(z.y, P.Qy) - cty
        dobj = pobj + dot(z.w, r0.w) + dot(z.v, r0.v) - mubar

        p_infeas = nan
        d_infeas = nan
        if not (p == 0 and m == 0):
            # primal infeasibility (Farkas certificate, CVXOPT+ECOS scalings)
            dw_bv = dot(d, z.w) - dot(b, z.v)
            p_unscaled = torch.linalg.norm(P.GAtwv, dim=-1)  # ‖Gᵀw − Aᵀv‖
            p_cvx = torch.where(
                dw_bv < 0, p_unscaled / (_norm(z.y) + _norm(z.v)), nan)
            p_ecos = torch.where(
                dw_bv < 0,
                p_unscaled / (torch.clamp(normc, min=1.0) * torch.abs(dw_bv)),
                nan)
            p_infeas = torch.maximum(p_cvx, p_ecos)

            # dual infeasibility / unboundedness
            d1 = torch.linalg.norm(rleft.v, dim=-1) if m else -inf  # ‖Ay − s‖
            d2 = torch.linalg.norm(rleft.w, dim=-1) if p else -inf  # ‖Gy‖
            d3 = torch.where(torch.isfinite(z.y).all(-1),
                             torch.linalg.norm(P.Qy, dim=-1), nan)
            d_cvx = torch.where(
                cty > 0,
                torch.maximum(
                    d1 / torch.clamp(normb, min=1.0),
                    torch.maximum(d2 / torch.clamp(normd, min=1.0),
                                  d3 / torch.clamp(normc, min=1.0)))
                / torch.abs(cty),
                nan)
            d_ecos = torch.where(
                cty > 0,
                torch.maximum(d1, torch.maximum(d2, d3))
                / torch.linalg.norm(z.y, dim=-1),
                nan)
            d_infeas = torch.abs(torch.maximum(d_cvx, d_ecos))

        return _Resid(rleft, r0, mu, mubar, cty, rDu, rPr, rCp, rmax, pobj,
                      dobj, p_infeas, d_infeas)

    # LEVEL-1 plugin callback: one-time setup
    solve3x3gen = kktsolver(Q, A, G, spec)
    # A generator that takes ``mode`` has two variants, "fast" and "slow",
    # and the loop picks one per iteration (kkt/schur.py). With
    # twoModeKKT=False the fast variant is pinned.
    two_mode = accepts_mode(solve3x3gen)
    if two_mode and opts.twoModeKKT is False:
        _gen = solve3x3gen
        solve3x3gen = lambda F, FinvT: _gen(F, FinvT, mode="fast")  # noqa: E731
        two_mode = False

    def make_solve4(lam, F, solve3x3, eig_dtype=None, lam_eigs=None):
        """4x4 → 3x3 reduction. ``lam_eigs`` gives the spectral data of
        mat(λ) per S group for every Lyapunov division (ca.sdp_eighs)."""

        def solve4(r: Vec4) -> Vec4:
            if fused:
                t1, rv = rcone.r_reduce4_pre(r.s, lam, F.r_d, r.v)
                dy, dw, dv = solve3x3(r.y, r.w, rv)
                return Vec4(dy, dw, dv, rcone.r_reduce4_post(t1, F.r_d, dv))
            t1 = sc.apply_adjoint(
                spec, F, ca.cone_div(spec, r.s, lam, eig_dtype,
                                     y_eigs=lam_eigs))
            dy, dw, dv = solve3x3(r.y, r.w, r.v + t1)
            ds = t1 - sc.apply_adjoint(spec, F, sc.apply(spec, F, dv))
            return Vec4(dy, dw, dv, ds)

        return solve4

    # λ-frame for S-cone specs: by congruence invariance maxstep(z.v, d) =
    # maxstep(λ, F d) and maxstep(z.s, d) = maxstep(λ, F⁻ᵀ d), and mat(λ)
    # = diag(F.sdp[i].lam) is a byproduct of the scaling, so every
    # Lyapunov division is elementwise and the two max-steps of a call site
    # share one stacked eigenvalue call. R- and Q-only specs keep the
    # direct frame.
    lam_frame = bool(spec.sdp_groups)

    def lam_eigs(F):
        return tuple((sd.lam, None) for sd in F.sdp) if lam_frame else None

    # Initial point: one KKT solve at F = I, or the caller's warm start;
    # then shift v, s strictly inside the cone.
    if warm is None:
        Fi = sc.nt_identity(spec, dtype, dev, bs)
        with control.bound(branch):
            solve3x3 = solve3x3gen(Fi, Fi)
        telemetry.phase(telemetry.KKT_BUILD)
        z0 = make_solve4(e, Fi, solve3x3, lam_eigs=lam_eigs(Fi))(
            Vec4(c, d, b, torch.zeros(bs + (m,), dtype=dtype, device=dev)))
    else:
        z0 = warm.map(lambda x: x.to(dtype=dtype, device=dev))
    a_v = ca.maxstep_to_cone(spec, z0.v)
    a_s = ca.maxstep_to_cone(spec, z0.s)
    z = Vec4(z0.y, z0.w, z0.v - col(a_v) * e, z0.s - col(a_s) * e)

    int32 = dict(dtype=torch.int32, device=dev)
    sol = SolState(
        y=z.y, w=z.w, v=z.v,
        status=torch.full(bs, Status.RUNNING, **int32),
        Iter=torch.zeros(bs, **int32),
        Mu=each(0.0), prFeas=each(float("inf")), duFeas=each(float("inf")),
        muFeas=each(float("inf")),
        pobj=each(float("inf")), dobj=each(float("-inf")),
    )

    def fts(x1, a1, y1, x2, a2, y2):
        # (x1 - a1*y1)ᵀ(x2 - a2*y2) without forming the differences
        return (dot(x1, x2) - a2 * dot(x1, y2)
                - a1 * dot(y1, x2) + a1 * a2 * dot(y1, y2))

    sw = opts.residualSwitch
    eps32 = torch.finfo(torch.float32).eps

    # S-cone decompositions of the fast phase (NT scaling, max-step,
    # Lyapunov division, corrector clip) in f32: with the two-variant
    # generator the slow branch reverts to full precision and a non-finite
    # fast iteration escalates instead of ending in Error; fastEig=True
    # without such a generator runs f32 decompositions throughout.
    has_sdp = bool(spec.sdp_groups)
    fast_eig = opts.fastEig is not False and two_mode and has_sdp
    force_fast_eig = bool(opts.fastEig) and not two_mode and has_sdp
    slow_ed = "refined" if (opts.refinedEig and has_sdp) else None

    def eig_dtype_of(slow: bool):
        """Precision of an iteration's S-cone decompositions on the fast or
        the slow variant."""
        if two_mode:
            return torch.float32 if (fast_eig and not slow) else slow_ed
        return torch.float32 if force_fast_eig else slow_ed

    # A scaling decomposed below the working precision is NT only to its
    # rounding: F z.v and F⁻ᵀ z.s differ from diag(λ) by ~eps·κ(Z), which
    # near the boundary is as large as λ's smallest entry, so a step taken
    # against diag(λ) can leave the cone. Congruence holds for any
    # invertible F: there each side steps from its own image, F z.v or
    # F⁻ᵀ z.s, decomposed once a step.
    side_frames = lam_frame and any(
        eig_dtype_of(slow) not in (None, "refined", dtype)
        for slow in (False, True))

    def take_step(z, F, FinvT, lam, R: _Resid, solve3x3, eig_dtype, running,
                  branch):
        """The Newton step from the iterate ``z`` and its scaling and
        residuals. ``running`` says which instances step (the others'
        refinement stops at once), ``branch(pred, trip)`` runs a
        refinement trip (:func:`masked`, a host read, or a conditional
        graph node) and says whether the next may run. Returns the new
        iterate, the refinement residual and trips + 1 per instance, the
        step's products (mixed mode), the step length, and the number of
        refinement trips run (device int32)."""
        r0, rleft, mu, mubar = R.r0, R.rleft, R.mu, R.mubar

        eigs = lam_eigs(F)

        def steps(dv, ds):
            # direct frame: the max-steps of z.v along dv and z.s along ds
            return torch.minimum(
                torch.clamp(ca.maxstep(spec, z.v, dv, eig_dtype), max=1.0),
                torch.clamp(ca.maxstep(spec, z.s, ds, eig_dtype), max=1.0))

        if side_frames:
            lam_s = sc.apply(spec, FinvT, z.s)
            eigs_v = ca.sdp_eighs(spec, lam, eig_dtype)
            eigs_s = ca.sdp_eighs(spec, lam_s, eig_dtype)

        def steps2(Fdv, FiTds):
            # λ-frame: the same steps from the scaled directions F dv, F⁻ᵀ ds
            if side_frames:
                (av,) = ca.maxstep_multi(spec, lam, (Fdv,), eig_dtype, eigs_v)
                (as_,) = ca.maxstep_multi(spec, lam_s, (FiTds,), eig_dtype,
                                          eigs_s)
            else:
                av, as_ = ca.maxstep_multi(spec, lam, (Fdv, FiTds),
                                           eig_dtype, eigs)
            return torch.minimum(torch.clamp(av, max=1.0),
                                 torch.clamp(as_, max=1.0))

        solve4 = make_solve4(lam, F, solve3x3, eig_dtype, eigs)

        # predictor
        d_aff = solve4(r0)
        if fused:
            a_aff, _, _, fts_aff = rcone.r_step(z.v, z.s, d_aff.v, d_aff.s,
                                                fts=True)
        else:
            FiTds = sc.apply(spec, FinvT, d_aff.s)
            Fdv = sc.apply(spec, F, d_aff.v)
            a_aff = (steps2(Fdv, FiTds) if lam_frame
                     else steps(d_aff.v, d_aff.s))
            fts_aff = fts(z.v, a_aff, d_aff.v, z.s, a_aff, d_aff.s)
        rho = fts_aff / mubar
        sigma = torch.clamp(rho, 0.0, 1.0) ** 3
        smu = sigma * mu

        # corrector
        if fused:
            rs = rcone.r_corrector(rleft.s, F.r_d, FinvT.r_d, d_aff.v,
                                   d_aff.s, smu)
        else:
            rs = rleft.s - (-ca.cone_prod(spec, FiTds, Fdv) + col(smu) * e)
        r = Vec4(r0.y, r0.w, r0.v, rs)

        def K4(dz):
            # through the fast operators: refinement needs the residual
            # accurately relative to Δz only
            Pd = products_fast(dz.y, dz.w, dz.v)
            if fused:
                srow = rcone.r_k4(lam, F.r_d, FinvT.r_d, dz.v, dz.s)
            else:
                srow = (ca.cone_prod(spec, lam, sc.apply(spec, F, dz.v))
                        + ca.cone_prod(spec, lam, sc.apply(spec, FinvT, dz.s)))
            return Vec4(Pd.Qy + Pd.GAtwv, Pd.GAy[..., :p],
                        Pd.GAy[..., p:] - dz.s, srow)

        def resid(dz):
            rIr = r - K4(dz)
            return rIr, rIr.norm() / (n + 2 * m)

        # Newton step + iterative refinement, stopped when a step fails to
        # halve the residual. With a low-precision factor this loop is what
        # recovers the working dtype's accuracy. Each instance of a stack
        # has its own stopping test, latched in `go` (the reference's
        # ref_cond): a trip changes only the instances still going, and
        # writes its results into the refinement's own tensors, so that a
        # trip that does not run (a conditional graph node whose `pred` is
        # false) leaves them as a masked one would.
        dz = solve4(r)
        rIr, rnorm = resid(dz)
        rn_prev = torch.full_like(rnorm, float("inf"))
        rstep = torch.zeros(rnorm.shape, dtype=torch.int32, device=dev)
        go = running.clone()
        trips = torch.zeros((), dtype=torch.int32, device=dev)

        def trip():
            new = _select(go, dz + solve4(rIr), dz)
            rn_prev.copy_(torch.where(go, rnorm, rn_prev))
            rIr_new, rnorm_new = resid(new)
            _assign(rIr, _select(go, rIr_new, rIr))
            rnorm.copy_(torch.where(go, rnorm_new, rnorm))
            _assign(dz, new)
            rstep.add_(go)
            trips.add_(go.any())
            return True

        for _ in range(opts.maxRefinementSteps):
            go.logical_and_((rnorm >= opts.refinement_threshold)
                            & (rnorm < 0.5 * rn_prev))
            if not branch(go.any(), trip):
                break

        # step with fraction-to-boundary; a non-finite direction (a failed
        # low-precision factor, say) freezes the iterate instead of
        # corrupting it
        inv_dtb = 1.0 / (1.0 - opts.DTB)
        if fused:
            alpha, vs_ok = rcone.r_step(z.v, z.s, dz.v, dz.s, inv_dtb)
            dz_ok = _finite_rows(dz.y, *((dz.w,) if p else ())) & vs_ok
        else:
            if lam_frame:
                alpha = steps2(sc.apply(spec, F, dz.v) * inv_dtb,
                               sc.apply(spec, FinvT, dz.s) * inv_dtb)
            else:
                alpha = steps(dz.v * inv_dtb, dz.s * inv_dtb)
            dz_ok = _finite_rows(dz.y, dz.v, dz.s, *((dz.w,) if p else ()))
        alpha = torch.where(dz_ok & torch.isfinite(alpha), alpha, 0.0)
        dz = dz.map(lambda u: torch.where(col(dz_ok), u, torch.zeros_like(u)))

        # Gondzio centrality correctors, each accepted by mask; `active`
        # turns off after the first rejection
        active = dz_ok
        for _ in range(opts.centralityCorrectors):
            atil = torch.clamp(1.08 * alpha + 0.08, max=1.0)
            if fused:
                nq = rcone.r_gondzio(lam, F.r_d, FinvT.r_d, dz.v, dz.s, atil,
                                     smu)
            else:
                Fdv = sc.apply(spec, F, dz.v)
                FiTds_c = sc.apply(spec, FinvT, dz.s)
                w_trial = ca.cone_prod(spec, lam - col(atil) * Fdv,
                                       lam - col(atil) * FiTds_c)
                nq = -ca.centrality_correction(spec, w_trial, 0.1 * smu,
                                               10.0 * smu, eig_dtype)
            zero = torch.zeros_like
            ddz = solve4(Vec4(zero(dz.y), zero(dz.w), zero(dz.v), nq))
            dz_c = dz + ddz
            if fused:
                a_c, _ = rcone.r_step(z.v, z.s, dz_c.v, dz_c.s, inv_dtb)
            elif lam_frame:
                a_c = steps2((Fdv + sc.apply(spec, F, ddz.v)) * inv_dtb,
                             (FiTds_c + sc.apply(spec, FinvT, ddz.s)) * inv_dtb)
            else:
                a_c = steps(dz_c.v * inv_dtb, dz_c.s * inv_dtb)
            fin = _finite_rows(ddz.y, ddz.v, ddz.s) & torch.isfinite(a_c)
            accept = active & fin & (a_c >= alpha + 0.1 * (atil - alpha))
            dz = _select(accept, dz_c, dz)
            alpha = torch.where(accept, a_c, alpha)
            active = accept

        # products of the taken step, to update the carried ones
        Pd = products_fast(dz.y, dz.w, dz.v) if mixed else None
        return z - dz.scale(alpha), rnorm, rstep + 1, Pd, alpha, trips

    def assess(R: _Resid, z, k, sol, optBest, stall, lm_was):
        """Best iterate, status and the last-mile trigger from this
        iteration's residuals; nothing is read back. ``lm_was`` says
        whether the full-precision variant was on: a host bool, or one
        flag per instance of a stack."""
        improved = R.rmax < optBest
        best = torch.where(improved, R.rmax, optBest)
        stalled = torch.where(improved, 0, stall + 1).to(torch.int32)

        def upd(new, old):
            return _select(improved, new, old)

        st = SolState(
            y=upd(z.y, sol.y), w=upd(z.w, sol.w), v=upd(z.v, sol.v),
            status=sol.status,
            Iter=torch.where(improved, k, sol.Iter).to(torch.int32),
            Mu=upd(R.mu, sol.Mu),
            prFeas=upd(R.rPr, sol.prFeas),
            duFeas=upd(R.rDu, sol.duFeas),
            muFeas=upd(R.rCp, sol.muFeas),
            pobj=R.pobj,  # always updated (reference quirk)
            dobj=R.dobj,
        )

        # convergence and certificates
        status = torch.where(R.rmax < opts.optTol, Status.OPTIMAL,
                             Status.RUNNING)
        if not (p == 0 and m == 0):
            infeas = R.p_infeas < opts.infeas_tol
            unbnd = R.d_infeas < opts.infeas_tol
            status = torch.where(infeas, Status.INFEASIBLE, status)
            status = torch.where(unbnd, Status.UNBOUNDED, status)
            # certificate normalizations overwrite the solution fields
            dw_bv = dot(d, z.w) - dot(b, z.v)
            infeas_c, unbnd_c = col(infeas), col(unbnd)
            st = replace(
                st,
                y=torch.where(infeas_c, nan,
                              torch.where(unbnd_c, z.y / col(torch.abs(R.cty)),
                                          st.y)),
                w=torch.where(infeas_c, z.w / col(-dw_bv),
                              torch.where(unbnd_c, nan, st.w)),
                v=torch.where(infeas_c, z.v / col(-dw_bv),
                              torch.where(unbnd_c, nan, st.v)),
            )

        # whether a breakdown is terminal, and whether the last-mile
        # trigger is still open: True, False, or one flag per instance
        terminal = lm_was if two_mode else True
        lm_open = two_mode and (
            ~lm_was if isinstance(lm_was, torch.Tensor) else not lm_was)

        def where_terminal(cond):
            return cond if terminal is True else cond & terminal

        running = status == Status.RUNNING
        # Divergence of unknown cause. With a two-variant generator a
        # non-finite fast iteration freezes its step and escalates
        # through lm_on; only a breakdown inside the full-precision
        # branch is a terminal Error.
        if terminal is not False:
            bad = ~_finite_each(R.mu, R.rDu, R.rPr, R.rCp)
            status = torch.where(where_terminal(running & bad), Status.ERROR,
                                 status)
        if mixed and terminal is not False:
            # Exhaustion of the low-precision factor, terminal only
            # once the full-precision branch (where there is one) has
            # had its turn. The caller's ladder re-solves from the best
            # iterate. Three signatures, all after the iterate has been
            # near tolerance: a 100x residual blow-up; complementarity
            # collapsed 1000x below the stuck best residual; and
            # complementarity already below tolerance and 100x below
            # the best residual. The last two only on a non-improving
            # iteration, so a converging solve stays alive.
            near_best = best < sw * opts.optTol
            exhausted = near_best & (R.rmax > 100.0 * best)
            exhausted = exhausted | (
                near_best & (R.rCp < 1e-3 * best) & ~improved)
            exhausted = exhausted | (
                near_best & (R.rCp < 0.1 * opts.optTol)
                & (R.rCp < 0.01 * best) & ~improved)
            status = torch.where(
                where_terminal((status == Status.RUNNING) & exhausted),
                Status.ABANDONED, status)
        if opts.stallCutoff is not None:
            plateau = (best < sw * opts.optTol) & (
                stalled >= opts.stallCutoff)
            status = torch.where((status == Status.RUNNING) & plateau,
                                 Status.ABANDONED, status)
        status = status.to(torch.int32)

        lm = None
        if lm_open is not False:
            # Reactive: the iterate is near tolerance and this
            # iteration failed to improve the best residual (healthy
            # solves improve every iteration), or the residual is
            # non-finite. Proactive: the residual is within
            # lastmileProactive x tolerance.
            lm = ((best < sw * opts.optTol) & ~improved) | ~torch.isfinite(
                R.rmax)
            if opts.lastmileProactive > 0:
                lm = lm | (R.rmax < opts.lastmileProactive * opts.optTol)
            if lm_open is not True:
                lm = lm & lm_open
        return replace(st, status=status), best, stalled, lm

    def scaling(z, slow):
        # the variant's precision of the S-cone decompositions
        F = sc.nt_scaling(spec, z.v, z.s, eig_dtype=eig_dtype_of(slow))
        return F, sc.nt_inv_adjoint(spec, F)

    def scaled(z, slow):
        """The iterate's scaling F, F⁻ᵀ, its scaled point λ = F z.v (=
        F⁻ᵀ z.s), and λ∘λ with z.vᵀz.s where the R cones' scaling makes
        them in the same pass (else None: residual_block forms them)."""
        if fused:
            r_d, rinv, lam, lam2, mubar = rcone.r_scaling(z.v, z.s)
            return (sc.NTScaling(r_d=r_d), sc.NTScaling(r_d=rinv), lam,
                    (lam2, mubar))
        F, FinvT = scaling(z, slow)
        return F, FinvT, sc.apply(spec, F, z.v), None

    # the variants' scalings differ (fastEig on S cones): each iteration
    # scales on the variant an instance was on when it began
    split_scaling = eig_dtype_of(False) != eig_dtype_of(True)

    def active_of(cy: Carry):
        """Per instance: the iteration numbered ``cy.k`` is taken (the
        instance runs and k <= maxIters). Everything an iteration carries
        is frozen by this mask, so iterations past the end change nothing."""
        return (cy.sol.status == Status.RUNNING) & (cy.k <= opts.maxIters)

    def recompute_due(R: _Resid, drift, run):
        """Mixed mode, per instance: the products are recomputed in full
        precision. Estimates from the carried products decide whether a
        tolerance decision is near and the drift could affect it; the
        honesty guard recertifies once drift reaches 10 % of the estimated
        residual, so reported residuals stay trustworthy."""
        near = ((R.rmax < sw * opts.optTol)
                | (R.p_infeas < sw * opts.infeas_tol)
                | (R.d_infeas < sw * opts.infeas_tol)
                | ~torch.isfinite(R.rmax))
        return ((near & (drift > 0.05 * opts.optTol))
                | (drift > 0.1 * R.rmax)) & run

    def stepped_products(P: _Products, drift, Pd: _Products, alpha, run):
        """Mixed mode: the carried products after a step of length
        ``alpha`` along a direction with products ``Pd`` (the incremental
        update) and their drift bound, where an instance stepped."""
        P_new = _Products(P.Qy - col(alpha) * Pd.Qy,
                          P.GAy - col(alpha) * Pd.GAy,
                          P.GAtwv - col(alpha) * Pd.GAtwv)
        drift_new = drift + 10.0 * eps32 * alpha * (
            (torch.linalg.norm(Pd.Qy, dim=-1)
             + torch.linalg.norm(Pd.GAtwv, dim=-1)) / (1.0 + normc)
            + _norm(Pd.GAy) / (1.0 + normb))
        return _select(run, P_new, P), torch.where(run, drift_new, drift)

    def variants(lm_on, active, branch, fn):
        """The device loop's ``lax.cond`` on the last-mile flag: ``fn(slow)``
        on each variant that some active instance is on, each the body of
        a ``branch``, and per instance its own variant's result. Returns
        the fast and the slow result (None for a body a host branch
        skipped; on the card, the values a body that did not run left)
        and the two predicates (device bools)."""
        on = ((active & ~lm_on).any(), (active & lm_on).any())
        outs = [branch(pred, functools.partial(fn, slow))
                for slow, pred in zip((False, True), on)]
        return outs, on

    def pick(lm_on, fast, slow):
        """Per instance, the result of the variant it is on; None when a
        host branch ran neither (no instance is active)."""
        if fast is None or slow is None:
            return slow if fast is None else fast
        return _select(lm_on, slow, fast)

    def evaluate(cy: Carry, P, lam, lm_was, sq=None):
        """Residuals and assessment of the iterate against products P
        (``sq``: :func:`scaled`'s); an instance that is not active keeps
        what it had."""
        R = residual_block(P, cy.z, lam, sq)
        st, best, stalled, lm = assess(R, cy.z, cy.k, cy.sol, cy.best,
                                       cy.stall, lm_was)
        run = active_of(cy)
        st = _select(run, st, cy.sol)
        best = torch.where(run, best, cy.best)
        stalled = torch.where(run, stalled, cy.stall)
        lm = None if lm is None else lm & run
        return R, st, best, stalled, lm

    def advance(cy: Carry, st, best, stalled, z_new, go) -> Carry:
        """The eager loop's carry after an iteration: the new iterate where
        it stepped (``go``), the counts on the device."""
        return cy._replace(z=_select(go, z_new, cy.z), sol=st, best=best,
                           stall=stalled,
                           k=(cy.k + active_of(cy).any()).to(torch.int32),
                           steps=(cy.steps + go.any()).to(torch.int32))

    def evaluated(cy: Carry, branch=None, refined=None) -> Carry:
        """The device loop's carry with its iterate, numbered ``cy.k``,
        scaled and evaluated: what the next step starts from. ``branch``
        runs the variants' scalings and the mixed-mode recompute; None in
        the prologue, where every instance is on the fast variant and the
        recompute is masked. With verbose output the carry's ``row`` is
        the eager loop's printed row (:func:`_row`), ``refined`` the
        refinement residual and trips + 1 of the step that led here (0 in
        the prologue)."""
        run = active_of(cy)
        if split_scaling and branch is not None:
            outs, _ = variants(cy.lm_on, run, branch,
                               lambda slow: scaling(cy.z, slow))
            F, FinvT = pick(cy.lm_on, *outs) or (cy.F, cy.FinvT)
            lam, sq = sc.apply(spec, F, cy.z.v), None
        else:
            F, FinvT, lam, sq = scaled(cy.z, False)
        more = {}
        if mixed:
            # the reference's cond_once: the full-precision products where
            # a recompute fires, then the evaluation against them
            fire = recompute_due(residual_block(cy.P, cy.z, lam, sq),
                                 cy.drift, run)
            full = (branch or masked)(
                fire.any(), lambda: products_full(cy.z.y, cy.z.w, cy.z.v))
            P, drift = cy.P, cy.drift
            if full is not None:
                P = _select(fire, full, P)
                drift = torch.where(fire, 0.0, drift)
            more = dict(P=P, drift=drift, recertified=(
                cy.recertified + fire.any()).to(torch.int32))
        else:
            P = products_full(cy.z.y, cy.z.w, cy.z.v)
        R, st, best, stalled, lm = evaluate(
            cy, P, lam, cy.lm_on if two_mode else False, sq)
        if two_mode:
            more["lm_on"] = cy.lm_on | lm
        if opts.verbose:
            rnorm, rstep = refined or (torch.zeros((), dtype=dtype,
                                                   device=dev), count())
            more["row"] = _row(run, cy.k, R, rstep, rnorm)
        return cy._replace(sol=st, best=best, stall=stalled, F=F,
                           FinvT=FinvT, lam=lam, R=R, **more)

    def unit(cy: Carry, branch=masked) -> Carry:
        """One unit of the device loop: the step from the evaluated
        iterate, where it still runs, then the new iterate evaluated. No
        host read and no early exit, so it can be captured in a CUDA graph
        (solver/graph.py); ``branch`` runs the refinement trips, the
        variants, the recompute and the generator's own ``control.cond``
        (:func:`masked`, :func:`on_host`, or a conditional node inside a
        capture)."""
        go = active_of(cy)

        def step(slow):
            with control.bound(branch):
                if two_mode:
                    solve3x3 = solve3x3gen(cy.F, cy.FinvT,
                                           mode="slow" if slow else "fast")
                else:
                    solve3x3 = solve3x3gen(cy.F, cy.FinvT)
            telemetry.phase(telemetry.KKT_BUILD)
            out = take_step(cy.z, cy.F, cy.FinvT, cy.lam, cy.R, solve3x3,
                            eig_dtype_of(slow), go, branch)
            telemetry.phase(telemetry.STEP)
            # z_new, Pd, alpha, the refinement residual and trips + 1
            # (the verbose row's), trips
            return out[0], out[3], out[4], out[1], out[2], out[5]

        more = {}
        if two_mode:
            outs, on = variants(cy.lm_on, go, branch, step)
            keep = 5 if opts.verbose else 3
            z_new, Pd, alpha, *refined = pick(cy.lm_on, *(
                None if o is None else o[:keep] for o in outs)) or (
                    cy.z, None, None)
            trips = sum(torch.where(pred, o[5], 0)
                        for o, pred in zip(outs, on) if o is not None)
            more = dict(fast_steps=(cy.fast_steps + on[0]).to(torch.int32),
                        slow_steps=(cy.slow_steps + on[1]).to(torch.int32))
        else:
            z_new, Pd, alpha, *refined, trips = step(False)
        if mixed and Pd is not None:
            more["P"], more["drift"] = stepped_products(cy.P, cy.drift, Pd,
                                                        alpha, go)
        moved = go.any()
        return evaluated(cy._replace(
            z=_select(go, z_new, cy.z),
            k=(cy.k + moved).to(torch.int32),
            steps=(cy.steps + moved).to(torch.int32),
            trips=(cy.trips + trips).to(torch.int32), **more), branch,
            refined)

    def count():
        return torch.zeros((), **int32)

    cy0 = Carry(z=z, sol=sol, best=each(float("inf")),
                stall=torch.zeros(bs, **int32),
                k=torch.ones((), **int32), steps=count(), trips=count())
    if two_mode:
        # sticky: the generator's full-precision variant is on
        cy0 = cy0._replace(lm_on=torch.zeros(bs, dtype=torch.bool,
                                             device=dev),
                           fast_steps=count(), slow_steps=count())
    if mixed:
        # fast estimates with an infinite drift, so the first
        # near-tolerance decision always recomputes them
        cy0 = cy0._replace(P=products_fast(z.y, z.w, z.v),
                           drift=each(float("inf")), recertified=count())
    telemetry.phase(telemetry.STEP)
    return SimpleNamespace(
        cy0=cy0, two_mode=two_mode, mixed=mixed,
        solve3x3gen=solve3x3gen, products_full=products_full,
        scaling=scaling, scaled=scaled, split_scaling=split_scaling,
        active_of=active_of,
        eig_dtype_of=eig_dtype_of, evaluate=evaluate, take_step=take_step,
        advance=advance, recompute_due=recompute_due,
        stepped_products=stepped_products, evaluated=evaluated, unit=unit)


def device_prologue(spec: ConeSpec, kktsolver, opts: IPMOptions):
    """The device loop's prologue for one configuration: a function of the
    operands ``(Q, c, A, b, G, d, warm)`` that sets the solve up (the
    level-1 callback, the initial point) and evaluates its first iterate,
    reading nothing back. It returns the loop's functions (``unit``, and
    ``active``: a device bool, whether any instance still runs) and the
    first carry. ``branch`` runs what the initial point's level-2 call
    decides by ``control.cond``. With verbose output every evaluation
    writes the carry's ``row``, which the host reads with its poll
    (:func:`poll`).

    ``more(carry, units)`` is the loop's predicate, the counterpart of the
    reference's ``while_loop`` condition: some instance is still active
    and ``units``, the units run so far (a host int or a device integer),
    is at most ``maxIters``. The cap bounds the loop at ``maxIters + 1``
    units even where a unit failed to advance ``k``, so that a loop
    decided on the device (solver/graph.py's WHILE node) never spins."""

    def prologue(Q, c, A, b, G, d, warm=None, branch=masked):
        L = _loop(*_operands(Q, c, A, b, G, d, spec), spec, kktsolver, opts,
                  warm, branch)

        def more(cy, units):
            return L.active_of(cy).any() & (units <= opts.maxIters)

        body = SimpleNamespace(unit=L.unit, more=more,
                               active=lambda cy: L.active_of(cy).any())
        return body, L.evaluated(L.cy0)

    return prologue


def ipm_solve(
    Q: torch.Tensor,
    c: torch.Tensor,
    A: torch.Tensor,
    b: torch.Tensor,
    G: torch.Tensor,
    d: torch.Tensor,
    spec: ConeSpec,
    kktsolver: Callable,
    opts: IPMOptions,
    warm: Optional[Vec4] = None,
    stats: Optional[dict] = None,
    device_loop: Optional[Callable] = None,
) -> SolState:
    """One interior-point solve, or one solve of a stack of instances
    (module docstring): with leading batch dims on ``c`` every field of the
    returned state has them too. ``kktsolver`` then receives stacked
    tensors. ``stats``, when given, receives what only the loop knows:
    ``fast_steps`` and ``slow_steps`` (steps taken on a generator's low-
    and full-precision variant; every step of a single-variant generator is
    a fast one; for a stack, iterations on which some instance took one),
    ``cold_start`` (1 when the initial point cost a KKT build),
    ``recertified`` (mixed mode: iterations that recomputed the products in
    full precision), ``trips`` (refinement trips run: trips on which some
    instance went on), ``polls`` (host reads of the loop's status),
    ``replays`` (CUDA graph replays of the loop), ``units`` (units the
    device loop ran; 0 on the eager loop), ``loop`` ("eager", "chunks" or
    "graph": which loop ran) and ``cache_hit`` (the loop's CUDA graphs were
    kept from an earlier call).

    ``device_loop``, when given, runs the device loop (module docstring):
    ``device_loop(prologue, inputs)`` calls ``prologue(*inputs)``
    (:func:`device_prologue`; ``inputs`` are the operands and ``warm``),
    which gives the loop's functions and the first carry, and applies
    ``unit`` while ``more(carry, units)``, a device bool, holds; it returns
    the final carry and a dict of ``polls``, ``replays``, ``units`` and
    ``loop`` (:func:`run_chunks`), and of the loop's counts when it read
    them (:func:`loop_counts`). It takes every configuration; with verbose
    output the host prints each evaluated iterate's row from its polls,
    the eager loop's text. Nothing in the prologue or the loop reads the
    device. A caller's kktsolver found to read the device by
    ``control.guarded`` (the device loop's warm-up on CUDA raises
    ``control.ReadsDevice`` before any capture) runs the eager loop from
    the initial point instead, its ``stats`` ``reason`` naming the read."""
    counts = dict(fast_steps=0, slow_steps=0, recertified=0, trips=0,
                  cold_start=int(warm is None), cache_hit=False)
    if c.dim() > 1 and opts.verbose:
        raise ValueError("verbose output is not supported in batched mode")

    if device_loop is not None:
        if opts.verbose:
            _print_banner()
        try:
            cy, info = device_loop(device_prologue(spec, kktsolver, opts),
                                   (Q, c, A, b, G, d, warm))
        except control.ReadsDevice as err:
            # nothing was captured: the eager loop from the initial point
            counts["reason"] = err.reason
        else:
            return _device_result(cy, info, counts, stats)

    Q, c, A, b, G, d = _operands(Q, c, A, b, G, d, spec)
    L = _loop(Q, c, A, b, G, d, spec, kktsolver, opts, warm, on_host)
    two_mode, mixed, cy = L.two_mode, L.mixed, L.cy0
    evaluate, take_step, advance = L.evaluate, L.take_step, L.advance
    scaling, active_of, eig_dtype_of = L.scaling, L.active_of, L.eig_dtype_of
    solve3x3gen = L.solve3x3gen
    batched = bool(c.dim() > 1)
    bs, dev = tuple(c.shape[:-1]), c.device

    if opts.verbose and device_loop is None:
        _print_banner()

    zero = torch.zeros((), dtype=c.dtype, device=dev)
    rnorm_prev, rstep_prev = zero, zero.to(torch.int32)
    # Sticky: the generator's full-precision variant is on. A host bool for
    # a single solve; for a stack one flag per instance on the device, with
    # `modes` the variants (False fast, True slow) that some running
    # instance is on, as the host knows them from the latest read.
    lm_on = torch.zeros(bs, dtype=torch.bool, device=dev) if batched else False
    modes = (False,)
    P, drift = cy.P, cy.drift  # the carried products (mixed mode)
    counts.update(polls=0, replays=0, units=0, loop="eager")

    def per_variant(which, flags, fn):
        """``fn(slow)`` on the variant(s) in ``which``; when a stack is on
        both, each instance takes its own by ``flags``."""
        if len(which) == 1:
            return fn(which[0])
        return _select(flags, fn(True), fn(False))

    def read(st, lm, fire=None):
        """The iteration's read-back, in one copy: whether the solve (any
        instance of a stack) is still running, the last-mile flag(s) after
        this iteration, the variants the step needs, and whether a
        recompute fired."""
        counts["polls"] += 1
        if not batched:
            flags = [f.to(torch.int32) for f in (lm, fire) if f is not None]
            with telemetry.span(telemetry.WAIT):
                got = (torch.stack([st.status] + flags).tolist() if flags
                       else [int(st.status)])
            on = lm_on or (lm is not None and bool(got[1]))
            return (got[0] == Status.RUNNING, on, (on,),
                    fire is not None and bool(got[-1]))
        run = st.status == Status.RUNNING
        on = lm_on if lm is None else lm_on | lm
        flags = [run.any()]
        if two_mode:
            flags += [(run & ~on).any(), (run & on).any()]
        if fire is not None:
            flags.append(fire.any())
        with telemetry.span(telemetry.WAIT):
            got = torch.stack(flags).tolist()
        need = (False,)
        if two_mode:
            need = tuple(v for v, f in zip((False, True), got[1:3]) if f)
        return got[0], on, need or modes, fire is not None and got[-1]

    def branch(pred, trip):
        # the eager loop's refinement trip: a host read, and no trip once
        # no instance goes on
        with telemetry.span(telemetry.WAIT):
            go = bool(pred)
        if not go:
            return False
        trip()
        counts["trips"] += 1
        return True

    # The eager loop: the configurations the device loop does not take, one
    # host read per iteration (module docstring). Its arithmetic is the
    # device loop's (evaluate, take_step, advance); the reads decide the
    # early exits, the variant and the recompute.
    k = 1
    while k <= opts.maxIters:
        # the scaling is the variant's an instance was on when the
        # iteration began; the variants differ only in the precision of
        # the S-cone decompositions
        if L.split_scaling:
            F, FinvT = per_variant(modes, lm_on,
                                   lambda slow: scaling(cy.z, slow))
            lam, sq = sc.apply(spec, F, cy.z.v), None
        else:
            F, FinvT, lam, sq = L.scaled(cy.z, modes[0])

        if mixed:
            R, st, best, stalled, lm = evaluate(cy, P, lam, lm_on, sq)
            fire = L.recompute_due(R, drift, active_of(cy))
            go, on, need, fired = read(st, lm, fire)
            if fired:
                counts["recertified"] += 1
                P = _select(fire, L.products_full(cy.z.y, cy.z.w, cy.z.v), P)
                drift = torch.where(fire, 0.0, drift)
                R, st, best, stalled, lm = evaluate(cy, P, lam, lm_on, sq)
                go, on, need, _ = read(st, lm)
        else:
            R, st, best, stalled, lm = evaluate(
                cy, L.products_full(cy.z.y, cy.z.w, cy.z.v), lam, lm_on, sq)
            go, on, need, _ = read(st, lm)
        lm_on, modes = on, need

        if opts.verbose:
            _print_rows(_row(active_of(cy), cy.k, R, rstep_prev,
                             rnorm_prev).tolist())

        if not go:
            cy = cy._replace(sol=st)
            break
        # LEVEL-2 plugin callback: per-iteration numeric refactorization,
        # of the variant(s) this iteration steps on (an instance that
        # switched on this iteration steps on its new one)
        if two_mode and True in modes:
            counts["slow_steps"] += 1
        if not two_mode or False in modes:
            counts["fast_steps"] += 1
        run = active_of(cy) & (st.status == Status.RUNNING)

        def step(slow):
            with control.bound(on_host):
                if two_mode:
                    solve3x3 = solve3x3gen(F, FinvT,
                                           mode="slow" if slow else "fast")
                else:
                    solve3x3 = solve3x3gen(F, FinvT)
            return take_step(cy.z, F, FinvT, lam, R, solve3x3,
                             eig_dtype_of(slow), run, branch)[:5]

        z_new, rnorm_prev, rstep_prev, Pd, alpha = per_variant(
            modes, lm_on, step)
        if mixed:
            P, drift = L.stepped_products(P, drift, Pd, alpha, run)
        cy = advance(cy, st, best, stalled, z_new, run)
        k += 1

    if stats is not None:
        stats.update(counts)
    return _finish(cy.sol)


def _device_result(cy, info, counts, stats) -> SolState:
    """The device loop's result and its counts, read from the final carry
    in one copy unless the device loop read them with its own
    (solver/graph.py)."""
    counts.update(info if "trips" in info
                  else dict(info, **loop_counts(cy)[0]))
    if stats is not None:
        stats.update(counts)
    return _finish(cy.sol)


_COUNTS = ("fast_steps", "slow_steps", "recertified", "trips")


def loop_counts(cy: Carry, *extra) -> tuple:
    """The device loop's counts (``fast_steps``, ``slow_steps``,
    ``recertified``, ``trips``) and the values of the device integers
    ``extra``, in one copy. A single-variant generator's steps are all
    fast ones."""
    none = torch.zeros_like(cy.trips)
    vals = torch.stack([t.to(torch.int64) for t in (
        cy.steps if cy.fast_steps is None else cy.fast_steps,
        none if cy.slow_steps is None else cy.slow_steps,
        none if cy.recertified is None else cy.recertified,
        cy.trips, *extra)]).tolist()
    return dict(zip(_COUNTS, vals)), vals[len(_COUNTS):]


class Carry(NamedTuple):
    """What one iteration hands the next (the reference's while_loop
    carry): the iterate, the best-iterate record, the best residual and
    the stall count per instance, the number of the iteration (device
    int32: on the device loop the number of the evaluated iterate, on the
    eager loop that of the next), the count of iterations on which some
    instance stepped and of the refinement trips run. The device loop also
    carries what its next step starts from: the iterate's scaling
    (``F``, ``FinvT``), scaled point ``lam`` and residuals ``R``; with a
    two-variant generator the last-mile flag ``lm_on`` (one bool per
    instance) and the iterations on which some instance stepped on the
    fast and on the slow variant; in mixed mode the carried products
    ``P``, their ``drift`` (per instance) and the iterations that
    recomputed them; with verbose output the latest evaluation's printed
    ``row`` (:data:`ROW` values). What a configuration does not use is
    None."""

    z: Vec4
    sol: SolState
    best: torch.Tensor
    stall: torch.Tensor
    k: torch.Tensor
    steps: torch.Tensor
    trips: torch.Tensor
    F: Optional[sc.NTScaling] = None
    FinvT: Optional[sc.NTScaling] = None
    lam: Optional[torch.Tensor] = None
    R: Optional[_Resid] = None
    lm_on: Optional[torch.Tensor] = None
    fast_steps: Optional[torch.Tensor] = None
    slow_steps: Optional[torch.Tensor] = None
    P: Optional[_Products] = None
    drift: Optional[torch.Tensor] = None
    recertified: Optional[torch.Tensor] = None
    row: Optional[torch.Tensor] = None


def _assign(dst, src) -> None:
    """Write the tensors of ``src`` into those of ``dst`` (records of
    tensors of one structure), in place."""
    if isinstance(dst, torch.Tensor):
        dst.copy_(src)
        return
    for f in dst.__dataclass_fields__:
        _assign(getattr(dst, f), getattr(src, f))


def _finish(sol: SolState) -> SolState:
    """A loop exhausted without a status ends Abandoned."""
    return replace(sol, status=torch.where(
        sol.status == Status.RUNNING, Status.ABANDONED, sol.status
    ).to(torch.int32))


def run_chunks(prologue, inputs):
    """The device loop run eagerly (the CPU's counterpart of
    solver/graph.py's WHILE node): the prologue, then chunks of
    :data:`POLL` units while the loop's predicate holds (``more``: some
    instance active, the units under the cap), the host reading it once
    after the prologue and once after each chunk; each unit's bodies run
    masked. Returns the final carry and what the loop did (``polls``
    reads, ``units`` run, ``POLL`` per chunk, no ``replays``, ``loop``
    "chunks", and ``phases``: each phase's ns on the host's clock,
    ``telemetry.HostClock``, the reads left out). With verbose output
    each read prints the rows of the units since the last
    (:func:`poll`)."""
    clock = telemetry.HostClock()
    with telemetry.clocked(clock):
        body, cy = prologue(*inputs)
        telemetry.phase(telemetry.EVALUATE)
        polls, units, rows = 1, 0, [cy.row]
        while poll(body.more(cy, units), rows):
            telemetry.mark()
            rows = []
            for _ in range(POLL):
                cy = body.unit(cy)
                telemetry.phase(telemetry.EVALUATE)
                rows.append(cy.row)
            units += POLL
            polls += 1
    return cy, dict(polls=polls, replays=0, units=units, loop="chunks",
                    phases=clock.read())


def _row(run, k, R: _Resid, rstep, rnorm) -> torch.Tensor:
    """One iteration's verbose row on the device (:data:`ROW` f64
    values, each exactly the value the eager loop prints)."""
    return torch.stack([x.to(torch.float64) for x in (
        run, k, R.rPr, R.rDu, R.rCp, R.pobj, R.dobj, R.p_infeas, R.d_infeas,
        rstep, rnorm)])


def polled(active, rows, slots=None) -> torch.Tensor:
    """What a verbose poll copies in one read: ``active`` (a device bool)
    then the rows (:func:`_row`), padded with rows that print nothing to
    ``slots``."""
    vals = [active.to(torch.float64).reshape(1), *rows]
    if slots is not None and slots > len(rows):
        vals.append(active.new_zeros((slots - len(rows)) * ROW,
                                     dtype=torch.float64))
    return torch.cat(vals)


def read_polled(buf) -> bool:
    """Read a :func:`polled` buffer in one copy, print its rows, and
    return whether any instance is still active."""
    vals = buf.tolist()
    _print_rows(vals[1:])
    return bool(vals[0])


def poll(active, rows) -> bool:
    """The device loop's host read: whether any instance is still active,
    and with verbose output (``rows`` the carries' rows; None without)
    the rows of the units since the last read, in the same copy, printed
    as the eager loop prints them."""
    if not rows or rows[0] is None:
        return bool(active)
    return read_polled(polled(active, rows))


def _print_banner():
    print("\n > CONICIP-TPU-TORCH INTERIOR POINT SOLVER v0.1\n")
    print("            Optimality                      Objective              "
          "Infeasibility       ")
    print()
    print("\x1b[1m   Iter   │  prFeas    duFeas    muFeas   │  pobj      dobj      "
          "│  icertp    icertd   │  refine \x1b[0m")


def _print_rows(vals):
    """Print the rows of ``vals`` (:data:`ROW` values each, :func:`_row`)
    that an evaluation wrote."""
    for i in range(0, len(vals), ROW):
        shown, k, rPr, rDu, rCp, pobj, dobj, p_inf, d_inf, rstep, rnorm = (
            vals[i:i + ROW])
        if not shown:
            continue
        hot = rnorm > 0.001
        pre = "\x1b[1m\x1b[31m" if hot else ""
        post = "\x1b[0m" if hot else ""
        print(
            f"{pre} {int(k):6d}  │  {rPr:<8.1e}  {rDu:<8.1e}  "
            f"{rCp:<8.1e} │  {pobj:< 8.1e}  {dobj:< 8.1e}  │  "
            f"{p_inf:<8.1e}  {d_inf:<8.1e} │  {int(rstep)}{post}"
        )
