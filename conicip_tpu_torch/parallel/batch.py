"""Batched problem solving: data parallelism over problem instances.

Counterpart of ``conicip_tpu/parallel/batch.py``. There a stack of problems
is ``jax.jit(jax.vmap(ipm_solve))``, compiled once per configuration and
shape and kept; here :func:`ipm_solve` itself takes a leading batch axis on
every operand (``solver/ipm.py``): per-instance status, masks that freeze
finished instances while the loop keeps stepping the rest, and every dense
factor of an iteration one launch of the CUDA kernel's batched entry.

Every run takes the device loop through ``solver/graph.py``'s cache, as
``conic_ip``'s runs do (``solver._eager_reason``), and as the reference's
stacked solvers are ``jit(vmap(...))`` of whatever generator they are
given: on CUDA a captured prologue and chunk kept per configuration and
stack shape, one host read per chunk; on the CPU the same chunks run
eagerly. That is the automatic main run at f64 or f32 (diag, Schur or
spectral, cold or warm, with mixed residuals and, in a checkpoint loop's
chunks, the two-variant generator), every fused tier (the f32-factor tier
over an f64 assembly, the full-precision tier, the low-rank finisher),
the S-cone policy behind ``factor_dtype=float32``,
``solve_batch(kktsolver=...)`` with any kktsolver, the package's or a
caller's, and the public :func:`make_batched_solver` /
:func:`make_batched_warm_solver` on one. The eager loop (one host read
per iteration) keeps the sub-batches of instances that stalled (the host
backstop, the eliminated path's retry and fallback), whose shape depends
on the data: an entry for each would rarely be hit and would evict the
main run's; and a caller's callable whose callbacks read the device
(``solver._eager_reason``).

:func:`solve_batch` keeps the reference's policy: the automatic backend
(diagonal, dense Schur, spectral, low-rank) chosen on the caller's arrays
for the whole stack, the warm start, and behind ``factor_dtype=float32``
the fused rescue tiers, the host backstop ladder and the shared-G
null-space elimination. On the CPU and on CUDA the default is f64 factors:
one plain stacked solve.
"""

from __future__ import annotations

import functools
from dataclasses import dataclass, fields
from typing import List, NamedTuple, Optional, Sequence, Tuple

import numpy as np
import torch

from ..cones.spec import ConeSpec
from ..ops.batched import mv
from ..solver import _densify, _eager_reason, graph
from ..solver.ipm import IPMOptions, _select, ipm_solve
from ..solver.state import STATUS_NAMES, SolState, Status, Vec4
from .mesh import MeshAxis

__all__ = [
    "solve_batch",
    "BatchSolution",
    "make_batched_solver",
    "make_batched_warm_solver",
]


@dataclass
class BatchSolution:
    """Stacked solutions: every field a tensor with a leading batch axis,
    on the solve's device (``interop.batch_solution_to_numpy`` brings them
    to the host)."""

    y: torch.Tensor
    w: torch.Tensor
    v: torch.Tensor
    status: torch.Tensor  # int codes
    Iter: torch.Tensor
    Mu: torch.Tensor
    prFeas: torch.Tensor
    duFeas: torch.Tensor
    muFeas: torch.Tensor
    pobj: torch.Tensor
    dobj: torch.Tensor

    @property
    def statuses(self) -> List[str]:
        return [STATUS_NAMES[int(s)] for s in self.status.tolist()]

    @classmethod
    def from_state(cls, st: SolState) -> "BatchSolution":
        return cls(**{f.name: getattr(st, f.name) for f in fields(cls)})


class BatchRun(NamedTuple):
    """One stacked interior-point run inside a :func:`solve_batch` call."""

    kktsolver: object
    tier: str  # "main", "fused-1", ..., "backstop-1", ...
    status: tuple  # per instance of this run's stack, as it ended here
    Iter: tuple  # per instance, this run's own count
    fast_steps: int
    slow_steps: int
    cold_start: int
    recertified: int
    polls: int  # host reads of the loop's status
    replays: int  # CUDA graph replays of one captured chunk
    # "graph", "chunks" (the device loop) or "eager" (a backstop
    # sub-batch, a caller's callable that reads the device: _run)
    loop: str
    trips: int  # refinement trips run (some instance went on)
    cache_hit: bool  # the device loop's entry was kept from an earlier call
    reason: Optional[str] = None  # why the run kept the eager loop

    @property
    def batch(self) -> int:
        return len(self.status)

    @property
    def stalled(self) -> int:
        """Instances this run left Abandoned or Error."""
        return sum(s in (Status.ABANDONED, Status.ERROR) for s in self.status)

    @property
    def max_iter(self) -> int:
        return max(self.Iter, default=0)


# Every stacked run of the latest solve_batch call, in order: the main
# solve, the fused tiers that fired, the backstop's sub-batches, and what
# the elimination path's retry and fallback added. A diagnostic: nothing in
# the solver reads it.
runs: list = []


def _stalled_mask(status: torch.Tensor) -> torch.Tensor:
    return (status == Status.ABANDONED) | (status == Status.ERROR)


def _maxres(st) -> torch.Tensor:
    return torch.maximum(st.prFeas, torch.maximum(st.duFeas, st.muFeas))


def _run(spec, kktsolver, opts, tier, Q, c, A, b, G, d, warm=None, *,
         eager=False):
    """One stacked run, recorded in :data:`runs`. It takes the device loop
    by conic_ip's rule (``solver._eager_reason``): every generator at any
    precision, whether solve_batch chose it or a caller passed it.
    ``eager`` keeps a sub-batch of instances that stalled on the eager
    loop (module docstring)."""
    stats = {}
    args = (Q, c, A, b, G, d, spec, kktsolver, opts)
    reason = ("a sub-batch of stalled instances" if eager
              else _eager_reason(kktsolver, c.device))
    if reason is None:
        st = graph.solve(*args, warm=warm, stats=stats)
    else:
        st = ipm_solve(*args, warm=warm, stats=stats)
        stats["reason"] = reason
    runs.append(BatchRun(kktsolver, tier, tuple(st.status.tolist()),
                         tuple(st.Iter.tolist()), **stats))
    return st


def _neutral_warm(y, w, v, A, b) -> Vec4:
    """A warm iterate from stacked (y, w, v): instances with non-finite
    data restart from a neutral point (the solver shifts the iterate
    strictly into the cone either way)."""
    ok = (torch.isfinite(y).all(-1) & torch.isfinite(w).all(-1)
          & torch.isfinite(v).all(-1))[:, None]
    y = torch.where(ok, y, 0.0)
    w = torch.where(ok, w, 0.0)
    v = torch.where(ok, v, 1.0)
    return Vec4(y, w, v, mv(A, y) - b)


@functools.lru_cache(maxsize=None)
def make_batched_solver(spec: ConeSpec, kktsolver, opts: IPMOptions,
                        batch_G: bool = True):
    """Stacked solver ``(Q, c, A, b, G, d) -> SolState`` with (B,) fields
    for a fixed (spec, kktsolver, opts). With ``batch_G=False`` ``G`` and
    ``d`` are one shared equality system. ``kktsolver`` receives stacked
    tensors: Q (B, n, n), A (B, m, n), G (B, p, n). The run takes the
    device loop by ``conic_ip``'s rule (:func:`_run`), as the reference's
    solver is ``jit(vmap(...))`` of the caller's."""

    def core(Q, c, A, b, G, d):
        if batch_G != (G.dim() == 3):
            raise ValueError("G does not match batch_G")
        return _run(spec, kktsolver, opts, "main", Q, c, A, b, G, d)

    return core


@functools.lru_cache(maxsize=None)
def make_batched_warm_solver(spec: ConeSpec, kktsolver, opts: IPMOptions,
                             batch_G: bool = True):
    """Stacked warm-started solver ``(Q, c, A, b, G, d, warm) -> SolState``
    (the warm :class:`Vec4` stacked on axis 0); the loop is chosen as in
    :func:`make_batched_solver`."""

    def core(Q, c, A, b, G, d, warm):
        if batch_G != (G.dim() == 3):
            raise ValueError("G does not match batch_G")
        return _run(spec, kktsolver, opts, "main", Q, c, A, b, G, d, warm)

    return core


@functools.lru_cache(maxsize=None)
def make_batched_ladder_solver(spec: ConeSpec, kktsolver, tiers,
                               opts: IPMOptions, with_warm: bool = False,
                               eager: bool = False):
    """Stacked solver with the escalation ladder behind it: after the fast
    tier, each ``(kktsolver, IPMOptions)`` in ``tiers`` runs only when some
    instance ended Abandoned or Error (one host read per tier), warm from
    the stack's best iterates, and its answer is accepted per instance:
    a stalled instance takes it when it is definitive or no worse.
    ``eager`` keeps every run on the eager loop (a sub-batch of stalled
    instances, :func:`_run`)."""

    def run(Q, c, A, b, G, d, warm=None):
        st = _run(spec, kktsolver, opts, "main", Q, c, A, b, G, d, warm,
                  eager=eager)
        for i, (kkt_t, opts_t) in enumerate(tiers, 1):
            stalled = _stalled_mask(st.status)
            if not bool(stalled.any()):
                continue
            st2 = _run(spec, kkt_t, opts_t, f"fused-{i}", Q, c, A, b, G, d,
                       _neutral_warm(st.y, st.w, st.v, A, b), eager=eager)
            accept = stalled & (~_stalled_mask(st2.status)
                                | (_maxres(st2) <= _maxres(st)))
            st = _select(accept, st2, st)
        return st

    if with_warm:
        return run
    return lambda Q, c, A, b, G, d: run(Q, c, A, b, G, d)


def _warm_fields(ws):
    if hasattr(ws, "y"):
        return ws.y, ws.w, ws.v
    return ws[0], ws[1], ws[2]


def solve_batch(
    Q,
    c,
    A,
    b,
    cone_dims: Sequence[Tuple[str, int]],
    G=None,
    d=None,
    *,
    mesh=None,
    batch_axis="batch",
    kktsolver=None,
    factor_dtype="auto",
    dtype=None,
    warm_start=None,
    backstop: bool = True,
    eliminate_equalities: Optional[bool] = None,
    device="cuda",
    **options,
) -> BatchSolution:
    """Solve a stack of independent conic QPs (leading batch axis on
    Q, c, A, b and optionally G, d). Inputs may be numpy arrays or tensors;
    they are moved to ``device`` in ``dtype`` (default float64), and the
    returned :class:`BatchSolution` holds tensors there.

    ``mesh`` (a ``DeviceMesh`` from :func:`~conicip_tpu_torch.make_mesh`)
    shards the stack over the mesh dimension ``batch_axis``, or over
    several (a tuple of names, the first the slowest, as a JAX
    ``PartitionSpec`` orders them). Every rank of the mesh makes the same
    call; each solves its contiguous slice of the stack, rescue tiers
    included, and every rank returns the whole :class:`BatchSolution`,
    gathered. The batch must divide over the ranks of ``batch_axis``.

    ``kktsolver`` is the 3-level plugin callback; it receives stacked
    tensors (Q (B, n, n), A (B, m, n), G (B, p, n), scalings and vectors
    with a leading batch axis) and must not reduce across the batch.

    ``warm_start`` seeds every instance from a previous
    :class:`BatchSolution` (or a ``(y, w, v)`` tuple of stacked arrays).
    Instances with non-finite warm data are scrubbed to a neutral start.

    ``factor_dtype=torch.float32`` runs the factors in f32 with mixed
    residuals and, unless ``backstop=False``, rescue tiers at higher
    precision for the instances that stall, fused behind the main solve
    and then per sub-batch (``backstop=False`` is what the checkpoint loop
    uses, where an intermediate chunk's "Abandoned" just means "budget not
    yet spent"). It also eliminates a shared equality system by its null
    space (``eliminate_equalities``), unless the direct form has diagonal
    plus low-rank structure. The default ``"auto"`` is f64 factors.

    ``centralityCorrectors`` (via ``**options``) defaults to 1 Gondzio
    corrector on the automatic dense-Schur path for R/Q specs, 2 on
    eliminated problems and 0 otherwise.
    """
    del runs[:]
    kw = dict(kktsolver=kktsolver, factor_dtype=factor_dtype, dtype=dtype,
              backstop=backstop, eliminate_equalities=eliminate_equalities,
              device=device, **options)
    if mesh is not None:
        return _solve_sharded(mesh, batch_axis, (Q, c, A, b, G, d),
                              cone_dims, warm_start, kw)
    return _solve_batch(Q, c, A, b, cone_dims, G, d, warm_start=warm_start,
                        **kw)


# leading-axis rank of each operand of a stack: (Q, c, A, b, G, d); G and d
# of lower rank are one system shared by every instance
_STACKED_NDIM = (3, 2, 3, 2, 3, 2)


def _solve_sharded(mesh, batch_axis, operands, cone_dims, warm_start, kw):
    """This rank's contiguous slice of the stack, solved by
    :func:`_solve_batch`, then every field gathered over the batch axes."""
    names = (batch_axis,) if isinstance(batch_axis, str) else batch_axis
    axes = [MeshAxis(mesh, name) for name in names]
    if torch.device(kw["device"]).type != mesh.device_type:
        raise ValueError(f"solve_batch: device {kw['device']!r} on a mesh of "
                         f"{mesh.device_type!r} ranks")
    shards, index = 1, 0
    for ax in axes:  # the first axis is the slowest
        shards, index = shards * ax.size, index * ax.size + ax.rank
    batch = operands[1].shape[0]
    if batch % shards:
        raise ValueError(
            f"solve_batch: a batch of {batch} does not split over the "
            f"{shards} ranks of mesh axes {batch_axis!r}: dimension 0 should "
            f"be divisible by {shards} (full shape "
            f"{tuple(operands[0].shape)})")
    k = batch // shards
    mine = slice(index * k, (index + 1) * k)
    part = [X[mine] if X is not None and np.ndim(X) == nd else X
            for X, nd in zip(operands, _STACKED_NDIM)]
    if warm_start is not None:
        warm_start = tuple(None if x is None else x[mine]
                           for x in _warm_fields(warm_start))
    out = _solve_batch(*part[:4], cone_dims, *part[4:],
                       warm_start=warm_start, **kw)
    fields_ = {}
    for f in fields(out):
        x = getattr(out, f.name)
        for ax in reversed(axes):  # the fastest axis first: contiguous
            x = ax.all_gather(x)
        fields_[f.name] = x
    return BatchSolution(**fields_)


def _solve_batch(Q, c, A, b, cone_dims, G=None, d=None, *, kktsolver=None,
                 factor_dtype="auto", dtype=None, warm_start=None,
                 backstop=True, eliminate_equalities=None, device="cuda",
                 own=True, **options):
    """:func:`solve_batch` on this process's stack. ``own=False`` keeps
    every run on the eager loop: a sub-batch of the instances that
    stalled, whose shape depends on the data (module docstring)."""
    from ..solver import (_default_kktsolver, _diag_kktsolver,
                          resolve_factor_dtype)

    dtype = dtype or torch.float64
    device = torch.device(device)
    factor_dtype = resolve_factor_dtype(factor_dtype)
    f32 = torch.float32
    Q_in, A_in = Q, A  # as the caller holds them, for the pattern checks
    Q = _densify(Q, dtype, device)
    c = _densify(c, dtype, device)
    A = _densify(A, dtype, device)
    b = _densify(b, dtype, device)
    batch = c.shape[0]
    n = c.shape[-1]
    spec = ConeSpec(tuple(cone_dims))

    # Shared-G null-space elimination (same rationale as conic_ip's
    # default: the double-Schur equality path squares the conditioning an
    # f32 factor has to survive; eliminating once turns the whole batch
    # into the p = 0 path). One host QR of G serves every instance;
    # per-instance d is fine (y0 is linear in d). Exception: when the
    # direct form has diagonal plus low-rank Schur structure
    # (kkt/lowrank.py), elimination would destroy it (A·Z is dense); the
    # direct ladder with the low-rank f64 finisher is exact on equalities
    # and far cheaper per iteration than the dense factor of the reduced
    # problem.
    g_is_shared = G is not None and np.ndim(G) == 2
    use_lowrank = False
    if kktsolver is None and factor_dtype == f32 and backstop:
        from ..kkt.lowrank import lowrank_applicable

        use_lowrank = lowrank_applicable(Q_in, A_in, G, spec)
    if eliminate_equalities is None:
        eliminate_equalities = (
            factor_dtype == f32 and g_is_shared
            and np.shape(G)[0] > 0 and kktsolver is None
            and not use_lowrank
        )
    if eliminate_equalities and G is not None and np.shape(G)[-2] > 0:
        if not g_is_shared:
            raise ValueError(
                "eliminate_equalities=True requires a shared 2-D G "
                "(per-instance equality systems would need one QR each: "
                "solve those via the precision ladder instead)"
            )
        return _solve_batch_eliminated(
            Q, c, A, b, cone_dims, G, d, factor_dtype=factor_dtype,
            dtype=dtype, warm_start=warm_start, backstop=backstop,
            device=device, options=options,
        )

    if G is None:
        G = torch.zeros((batch, 0, n), dtype=dtype, device=device)
        d = torch.zeros((batch, 0), dtype=dtype, device=device)
    else:
        G = _densify(G, dtype, device)
        d = _densify(d, dtype, device)
        if G.dim() == 2:  # shared equality system (d batched or shared)
            G = G.expand((batch,) + G.shape)
        if d.dim() == 1:
            d = d.expand((batch,) + d.shape)
    p = G.shape[1]

    auto_schur = False
    auto_kkt = kktsolver is None
    if kktsolver is None:
        # automatic structure exploitation (same policy as conic_ip), but
        # the separability pattern must hold for every instance. The check
        # reads the caller's arrays where they lie.
        from ..kkt.diag import equality_mode, separable_batch

        if separable_batch(Q_in, A_in, G, spec):
            mode = equality_mode(Q_in, G)
            kktsolver = _diag_kktsolver(
                factor_dtype, "woodbury" if mode in (None, "none") else mode
            )
        else:
            kktsolver = _default_kktsolver(factor_dtype)
            auto_schur = True
    if "centralityCorrectors" not in options:
        # one Gondzio corrector on the dense-Schur path for R/Q specs, off
        # with S cones: batched solves run without the two-variant
        # generator, so the corrector's decompositions would run in full
        # precision every iteration, for no saved iteration on the batched
        # SDP families
        options = {
            **options,
            "centralityCorrectors": (
                1 if auto_schur and not spec.sdp_groups else 0
            ),
        }
    if "mixedResiduals" not in options:
        options = {
            **options,
            "mixedResiduals": factor_dtype == f32 and dtype == torch.float64,
        }
    if "twoModeKKT" not in options and factor_dtype == f32 and backstop:
        # a stack whose instances sit on both variants of a two-variant
        # generator builds both every iteration; pin the fast variant, the
        # rescue tiers below own escalation. Without a backstop
        # (checkpoint loops) the in-loop escalation stays.
        options = {**options, "twoModeKKT": False}
    opts = IPMOptions(**options)
    if opts.verbose:
        raise ValueError("verbose output is not supported in batched mode")

    warm = None
    if warm_start is not None:
        wy, ww, wv = _warm_fields(warm_start)
        wy = _densify(wy, dtype, device)
        wv = _densify(wv, dtype, device)
        ww = (torch.zeros((batch, p), dtype=dtype, device=device)
              if ww is None else _densify(ww, dtype, device))
        if (tuple(wy.shape) != (batch, n) or wv.shape != A.shape[:2]
                or tuple(ww.shape) != (batch, p)):
            raise ValueError("warm_start dimensions do not match the batch")
        warm = _neutral_warm(wy, ww, wv, A, b)

    # The escalation ladder fused behind the main solve (same tiers and
    # policy as the host loop below): the rescue tiers cost one host read
    # each when every instance finishes in the fast tier. The host loop
    # remains for the instances all fused tiers leave stalled.
    fused_tiers = ()
    if factor_dtype == f32 and backstop:
        if not spec.sdp_groups:
            if use_lowrank:
                # direct diagonal plus low-rank path: the f32 dense tier is
                # the main solve, and one exact f64 low-rank finisher
                # follows (every stalled instance needs the full-f64
                # factor, which the low-rank form makes cheap)
                from ..kkt.lowrank import lowrank_kktsolver

                fused_tiers = (
                    (lowrank_kktsolver(),
                     IPMOptions(**{**options, "mixedResiduals": False,
                                   "fastEig": False,
                                   "stallCutoff": options.get(
                                       "stallCutoff", 6)})),
                )
            else:
                fused_tiers = (
                    (_default_kktsolver(f32, torch.float64),
                     IPMOptions(**{**options, "mixedResiduals": True,
                                   "fastEig": False})),
                    # full-precision final tier: no exhaustion detector
                    # runs without mixedResiduals, so a near-tolerance
                    # plateau would hold the stack's loop open to
                    # maxIters; the stallCutoff ends it with the best
                    # iterate (the host backstop owns the remainder)
                    (_default_kktsolver(None),
                     IPMOptions(**{**options, "mixedResiduals": False,
                                   "fastEig": False,
                                   "stallCutoff": options.get(
                                       "stallCutoff", 6)})),
                )
        if spec.sdp_groups and auto_kkt:
            # S-cone policy: f32 tiers are a false economy here (the f32
            # decompositions of the NT congruence collapse once κ ~ 1/μ
            # passes ~1e7, and every broken instance then re-pays a rescue
            # tier while it holds the stack's loop open). The main solve is
            # switched to full precision. Structure first: the
            # PSD-projection pattern (A = I, Q = qI, p = 0) solves the
            # Newton system in closed form in the NT congruence's
            # eigenbasis, one batched d×d decomposition per iteration and
            # no factor; a stalled instance first gets the same spectral
            # solver with a patient stall cutoff, warm, and only then the
            # dense f64 KKT tier. stallCutoff ends near-tolerance plateaus
            # as Abandoned instead of letting one stuck instance hold the
            # loop open to maxIters.
            from ..kkt.spectral import spectral_applicable, spectral_kktsolver

            sdp_cfg = {**options, "mixedResiduals": False,
                       "fastEig": False,
                       "refinedEig": options.get("refinedEig", False),
                       "stallCutoff": options.get("stallCutoff", 4),
                       "maxRefinementSteps": options.get(
                           "maxRefinementSteps", 3)}
            if spectral_applicable(Q_in, A_in, G, spec):
                kktsolver = spectral_kktsolver(None)
                polish_cfg = {**sdp_cfg, "maxRefinementSteps": 3,
                              "stallCutoff": 8}
                fused_tiers = (
                    (kktsolver, IPMOptions(**polish_cfg)),
                    (_default_kktsolver(None), IPMOptions(**polish_cfg)),
                )
            else:
                kktsolver = _default_kktsolver(None)
            opts = IPMOptions(**sdp_cfg)

    if fused_tiers:
        st = make_batched_ladder_solver(
            spec, kktsolver, fused_tiers, opts, with_warm=True,
            eager=not own)(Q, c, A, b, G, d, warm)
    else:
        st = _run(spec, kktsolver, opts, "main", Q, c, A, b, G, d, warm,
                  eager=not own)
    out = BatchSolution.from_state(st)

    # Host backstop (same ladder as conic_ip): instances whose f32 tiers
    # ended without a definitive status are re-solved as a sub-batch, first
    # f64-assembled/f32-factored (assembly-cancellation stalls), then full
    # f64, warm from their best iterates. Every Abandoned/Error instance
    # escalates whatever its residual: infeasible and unbounded instances
    # end with large residuals, and only the full-precision tiers sharpen
    # their certificates. The middle tier cannot move an S-cone stall
    # (there the f32 factor itself is the floor), so S-cone specs go
    # straight to full f64.
    if factor_dtype == f32 and backstop:
        stalled = torch.nonzero(_stalled_mask(out.status))[:, 0]
        ladder = ([(_default_kktsolver(f32, torch.float64), True)]
                  if not spec.sdp_groups else []) + [
            (_default_kktsolver(None), False),
        ]
        if stalled.numel():
            # the fields may share storage with the solver's state
            out = BatchSolution(**{f.name: getattr(out, f.name).clone()
                                   for f in fields(out)})
        for i, (kkt_next, mixed_next) in enumerate(ladder, 1):
            if not stalled.numel():
                break
            Qs, cs, As, bs_, Gs, ds = (X[stalled] for X in (Q, c, A, b, G, d))
            opts_next = IPMOptions(**{**options, "mixedResiduals": mixed_next,
                                      "refinedEig": options.get(
                                          "refinedEig",
                                          bool(spec.sdp_groups))})
            cand = BatchSolution.from_state(_run(
                spec, kkt_next, opts_next, f"backstop-{i}", Qs, cs, As, bs_,
                Gs, ds, _neutral_warm(out.y[stalled], out.w[stalled],
                                      out.v[stalled], As, bs_), eager=True))
            # accept a tier's answer if it reached a definitive status or
            # at least improved the residual (same policy as conic_ip)
            accept = ~_stalled_mask(cand.status) | (
                _maxres(cand) <= _maxres(out)[stalled])
            take = stalled[accept]
            for f in fields(out):
                getattr(out, f.name)[take] = getattr(cand, f.name)[accept]
            # rejected instances keep their old (still stalled) status
            stalled = stalled[_stalled_mask(out.status[stalled])]
    return out


def _solve_batch_eliminated(Q, c, A, b, cone_dims, G, d, *, factor_dtype,
                            dtype, warm_start, backstop, device, options
                            ) -> BatchSolution:
    """Batched null-space elimination of a shared equality system.

    Mirrors the single-problem ``_solve_eliminated`` (solver/__init__.py)
    with the QR of G done once on the host
    (:func:`conicip_tpu_torch.reduce.equality_basis`) and every
    per-instance transform a batched product on the device: the whole
    batch becomes the p = 0 path. The recovery runs on the device in f64.
    """
    from ..reduce import equality_basis

    optTol = options.get("optTol", 1e-6)
    batch, n = c.shape
    f64 = torch.float64
    like = dict(dtype=f64, device=device)

    def host64(X):
        if isinstance(X, torch.Tensor):
            X = X.detach().cpu().numpy()
        return np.asarray(X, np.float64)

    Gh = host64(G)
    basis = equality_basis(Gh)
    direct_args = dict(factor_dtype=factor_dtype, dtype=dtype,
                       backstop=backstop, eliminate_equalities=False,
                       device=device)
    if basis.rank >= n:
        # G determines y completely: nothing to reduce; the direct saddle
        # path handles the (degenerate) fully-pinned case
        return _solve_batch(Q, c, A, b, cone_dims, G, d,
                            warm_start=warm_start, **direct_args, **options)
    p = basis.p
    dh = host64(d)
    if dh.ndim == 1:
        dh = np.broadcast_to(dh, (batch, p))
    y0h = basis.particular(dh)  # (batch, n)
    # Per-instance consistency of G y0 = d (rank-deficient rows checked as
    # the preprocessor does)
    bad = np.linalg.norm(y0h @ Gh.T - dh, axis=-1) > 1e-8 * (
        1.0 + np.linalg.norm(dh, axis=-1)
    )

    # Reduced batch (batched products on the device; Z is orthonormal)
    Z = torch.as_tensor(np.ascontiguousarray(basis.Z), dtype=dtype,
                        device=device)  # (n, n - r)
    y0 = torch.as_tensor(y0h, dtype=dtype, device=device)
    Qy0 = mv(Q, y0)
    Q_red = Z.T @ (Q @ Z)
    c_red = (c - Qy0) @ Z
    A_red = A @ Z
    b_red = b - mv(A, y0)

    # A user warm start maps into the reduced space: x = Zᵀ(y − y0)
    sub_warm = None
    if warm_start is not None:
        y_w, _, v_w = _warm_fields(warm_start)
        y_w = _densify(y_w, dtype, device)
        v_w = _densify(v_w, dtype, device)
        if tuple(y_w.shape) == (batch, n) and v_w.shape[0] == batch:
            sub_warm = ((y_w - y0) @ Z, None, v_w)

    if ("centralityCorrectors" not in options
            and not ConeSpec(tuple(cone_dims)).sdp_groups):
        # reduced (equality-origin) R/Q batches save a further iteration
        # at K = 2 in the reference's sweeps, with no regressions
        options = {**options, "centralityCorrectors": 2}

    sub = _solve_batch(Q_red, c_red, A_red, b_red, cone_dims,
                       warm_start=sub_warm, **direct_args, **options)

    # ── full-space recovery (f64, one pass over the batch) ──
    Q64, c64, A64 = Q.to(f64), c.to(f64), A.to(f64)
    Z64 = torch.as_tensor(np.ascontiguousarray(basis.Z), **like)
    y064 = torch.as_tensor(y0h, **like)
    G64 = torch.as_tensor(Gh, **like)
    Q1 = torch.as_tensor(np.ascontiguousarray(basis.Q1), **like)
    R = torch.as_tensor(np.ascontiguousarray(basis.R), **like)
    piv = torch.as_tensor(np.asarray(basis.piv[:basis.rank], np.int64),
                          device=device)

    def solve_gt(rhs):
        """Least-squares ``Gᵀ w = rhs`` through the QR factors, batched
        over the leading axis of rhs; NaN rows give NaN duals."""
        w = torch.zeros(rhs.shape[:-1] + (p,), **like)
        if basis.rank:
            t = torch.linalg.solve_triangular(R, (rhs @ Q1).T, upper=True).T
            w[..., piv] = t
        return w

    def recover(x, v, Qs, cs, As, y0s):
        """y, w, the recovered dual residual and the primal objective of a
        reduced solution (x, v)."""
        y = y0s + x @ Z64.T
        # least-squares equality duals from Qy + Gᵀw − Aᵀv = c
        Av = mv(As.mT, v)
        Qy = mv(Qs, y)
        w = solve_gt(cs - Qy + Av)
        rDu = torch.linalg.norm(Qy + w @ G64 - Av - cs, dim=-1) / (
            1.0 + torch.linalg.norm(cs, dim=-1))
        pobj = 0.5 * (y * Qy).sum(-1) - (cs * y).sum(-1)
        return y, w, Av, rDu, pobj

    x = sub.y.to(f64)
    v = sub.v.to(f64)
    y, w, Av, rDu, pobj = recover(x, v, Q64, c64, A64, y064)

    wd = dict(dtype=dtype)
    out = BatchSolution(**{f.name: getattr(sub, f.name).clone()
                           for f in fields(sub)})
    opt = out.status == Status.OPTIMAL
    # y0 + Zx is the full-space iterate for every status (for Abandoned
    # instances it is the best recovered iterate, used to seed fallbacks)
    out.y = y.to(**wd)
    out.w = w.to(**wd)
    out.duFeas = torch.where(opt, rDu.to(**wd), out.duFeas)
    out.dobj = torch.where(opt, pobj.to(**wd) - (out.pobj - out.dobj),
                           out.dobj)
    out.pobj = torch.where(opt, pobj.to(**wd), out.pobj)

    unb = out.status == Status.UNBOUNDED
    if bool(unb.any()):
        # reduced ray x → full-space ray Zx (G(Zx) = 0 by construction)
        out.y = torch.where(unb[:, None], (x @ Z64.T).to(**wd), out.y)
        out.w = torch.where(unb[:, None], torch.nan, out.w)
    infeas = out.status == Status.INFEASIBLE
    if bool(infeas.any()):
        # Farkas pair: extend v with least-squares w solving Gᵀw = Aᵀv
        out.w = torch.where(infeas[:, None], solve_gt(Av).to(**wd), out.w)
        out.y = torch.where(infeas[:, None], torch.nan, out.y)

    # Optimal-in-reduced-space instances whose recovered dual residual
    # misses tolerance get one batched retry at a tighter reduced tolerance
    # (same policy as _solve_eliminated), warm-started.
    retry = torch.nonzero(opt & (rDu >= optTol))[:, 0]
    if retry.numel():
        tight = {**options, "optTol": optTol * 0.02}
        sub2 = _solve_batch(
            Q_red[retry], c_red[retry], A_red[retry], b_red[retry],
            cone_dims, warm_start=(sub.y[retry], None, sub.v[retry]),
            own=False, **direct_args, **tight)
        v2 = sub2.v.to(f64)
        y2, w2, _, rDu2, pobj2 = recover(
            sub2.y.to(f64), v2, Q64[retry], c64[retry], A64[retry],
            y064[retry])
        better = (sub2.status == Status.OPTIMAL) & (rDu2 < rDu[retry])
        take = retry[better]
        out.y[take] = y2[better].to(**wd)
        out.w[take] = w2[better].to(**wd)
        out.v[take] = sub2.v[better]
        out.duFeas[take] = rDu2[better].to(**wd)
        out.prFeas[take] = sub2.prFeas[better]
        out.muFeas[take] = sub2.muFeas[better]
        out.dobj[take] = pobj2[better].to(**wd) - (
            sub2.pobj[better] - sub2.dobj[better])
        out.pobj[take] = pobj2[better].to(**wd)
        out.Iter[take] += sub2.Iter[better]

    # Instances the reduced path (its ladder included) could not finish
    # fall back to the direct saddle path as one sub-batch: the null-space
    # transform can make some problems numerically harder.
    bad_t = torch.as_tensor(bad, device=device)
    stalled = torch.nonzero(_stalled_mask(out.status) & ~bad_t)[:, 0]
    if stalled.numel():
        direct = _solve_batch(
            Q[stalled], c[stalled], A[stalled], b[stalled], cone_dims,
            torch.as_tensor(Gh, dtype=dtype, device=device).expand(
                stalled.numel(), p, n),
            torch.as_tensor(dh, dtype=dtype, device=device)[stalled],
            own=False, **direct_args, **options)
        for f in fields(out):
            getattr(out, f.name)[stalled] = getattr(direct, f.name)

    if bad.any():
        # inconsistent equalities: Infeasible with NaN primal and duals
        out.status[bad_t] = Status.INFEASIBLE
        for f in ("y", "w", "v", "Mu", "prFeas", "duFeas", "muFeas", "pobj",
                  "dobj"):
            getattr(out, f)[bad_t] = torch.nan
        out.Iter[bad_t] = 0
    return out
