"""The port's mixed-precision options against conicip_tpu on the CPU.

``factor_dtype=float32`` (f32 factors, mixed residuals, the last-mile switch
to full-precision factors, the escalation ladder), ``assemble_dtype``,
``twoModeKKT``, ``fastEig``, ``eig_dtype`` and a float32 working dtype.
Each instance is made with numpy from a seed and solved by both packages
with the same options.

An f32 solve lives at the edge of what refinement recovers, and the two
packages round differently (XLA against torch; the reference's full
products are Ozaki-sliced, the port's plain f64), so these solves are held
to: the same status; residuals below ``optTol`` where the reference is
Optimal; ``Iter`` within 2 of the reference's (every difference is
printed); and y as close to the **f64** solution as the reference's own
f32 solve comes, to within 1e-5 relative to max(1, |y|_inf). (Two solves
that stop at ``optTol`` = 1e-6 on different iterates can be 1e-2 apart on
an LP-like instance, so the distance to the f64 solution is bounded by the
reference's, not by a constant.) Where both stop on the same iterate, y
also agrees with the reference's to 1e-5. Every f64 path elsewhere keeps
exact ``Iter`` equality.
"""

import functools

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import conicip_tpu as ct
import conicip_tpu.solver as jax_solver
from conicip_tpu.cones import scaling as jsc
from conicip_tpu.kkt import kktsolver_schur as jax_schur
from conicip_tpu.kkt.spectral import spectral_kktsolver as jax_spectral
import conicip_tpu_torch as pt
import conicip_tpu_torch.solver as torch_solver
from conicip_tpu_torch.cones import scaling as tsc
from conicip_tpu_torch.cones.spec import ConeSpec
from conicip_tpu_torch.kkt import kktsolver_schur as torch_schur
from conicip_tpu_torch.kkt.spectral import spectral_kktsolver as torch_spectral
from conicip_tpu_torch.models import (box_qp_dense, many_small_socs,
                                      mixed_rq_eq, mixed_rqs, small_sdp)
from test_torch_cones import cone_interior

torch.set_num_threads(1)

ITER_BAND = 2
Y_TOL = 1e-5

F32 = dict(torch=torch.float32, jax=jnp.float32)


def readme_box(n=40, eq=False):
    """The README box QP (diag backend), with its simplex equality if eq."""
    H = 0.5 * np.eye(n)
    A = np.vstack([np.eye(n), -np.eye(n)])
    G, d = (np.ones((1, n)), np.array([1.0])) if eq else (None, None)
    return (H, H @ np.arange(1.0, n + 1), A, -np.ones(2 * n),
            [("R", 2 * n)], G, d)


CASES = {
    "box_qp_dense": lambda: box_qp_dense(n=48).args(),
    "readme_box": lambda: readme_box(),
    "readme_box_eq": lambda: readme_box(eq=True),
    "many_small_socs": lambda: many_small_socs(n=60, k=30).args(),
    "mixed_rq_eq": lambda: mixed_rq_eq(n=150).args(),
    "small_sdp": lambda: small_sdp(k=6).args(),
    "mixed_rqs": lambda: mixed_rqs().args(),
}

# option sets, as (port keywords, reference keywords)
VARIANTS = {
    "auto": {},
    "proactive0": dict(lastmileProactive=0.0),
    "unmixed": dict(mixedResiduals=False),
    "direct_saddle": dict(eliminateEqualities=False),
}


def resid(s):
    return max(s.prFeas, s.duFeas, s.muFeas)


def assert_close_to_reference(name, ref, sol, y64, opt_tol=1e-6):
    """The f32 criteria of the module docstring."""
    if sol.Iter != ref.Iter:
        print(f"{name}: Iter {sol.Iter} (port) vs {ref.Iter} (reference)")
    assert sol.status == ref.status, name
    assert abs(sol.Iter - ref.Iter) <= ITER_BAND, name
    if ref.status == "Optimal":
        assert resid(sol) < opt_tol and resid(ref) < opt_tol, name
        scale = max(1.0, np.max(np.abs(y64)))
        yr = np.asarray(ref.y)
        assert (np.max(np.abs(sol.y - y64))
                <= np.max(np.abs(yr - y64)) + Y_TOL * scale), name
        if sol.Iter == ref.Iter:
            assert np.max(np.abs(sol.y - yr)) <= Y_TOL * scale, name


def solve_both(args, **kw):
    """kw values that are dicts with "torch"/"jax" keys differ by package."""
    tkw = {k: v["torch"] if isinstance(v, dict) else v for k, v in kw.items()}
    jkw = {k: v["jax"] if isinstance(v, dict) else v for k, v in kw.items()}
    ref = ct.conic_ip(*args, **jkw)
    sol = pt.solution_to_numpy(pt.conic_ip(*args, device="cpu", **tkw))
    return ref, sol


def y_f64(args, **kw):
    sol = pt.conic_ip(*args, device="cpu", **kw)
    assert sol.status == "Optimal"
    return sol.y.numpy()


@pytest.mark.parametrize("case, variant", [
    *((c, "auto") for c in CASES),
    ("box_qp_dense", "proactive0"), ("many_small_socs", "proactive0"),
    ("mixed_rq_eq", "proactive0"), ("mixed_rqs", "proactive0"),
    ("box_qp_dense", "unmixed"), ("many_small_socs", "unmixed"),
    ("readme_box_eq", "unmixed"),
    ("mixed_rq_eq", "direct_saddle"), ("readme_box_eq", "direct_saddle"),
])
def test_f32_factors_match_jax(case, variant):
    args = CASES[case]()
    ref, sol = solve_both(args, factor_dtype=F32, **VARIANTS[variant])
    assert ref.status == "Optimal"
    assert_close_to_reference(f"{case}/{variant}", ref, sol, y_f64(args))
    assert sol.y.dtype == np.float64


def test_f32_path_takes_elimination_lastmile_and_recertifies():
    """What factor_dtype=float32 brings by default, read from the record of
    the call's runs: the reduced problem (no equality factor), fast steps
    followed by last-mile steps, and full-precision recertifications."""
    args = CASES["mixed_rq_eq"]()
    sol = pt.conic_ip(*args, device="cpu", factor_dtype=torch.float32)
    assert sol.status == "Optimal"
    (run,) = torch_solver.runs
    assert run.kktsolver.keywords == dict(
        factor_dtype=torch.float32, assemble_dtype=None, lastmile=True)
    assert run.fast_steps > 0 and run.slow_steps > 0
    assert 0 < run.recertified < run.fast_steps + run.slow_steps
    assert run.fast_steps + run.slow_steps == run.Iter - 1
    # the full-precision default: one run, every step on the one variant
    pt.conic_ip(*args, device="cpu")
    (run,) = torch_solver.runs
    assert run.kktsolver is torch_schur
    assert (run.slow_steps, run.recertified) == (0, 0)
    # without the proactive trigger a healthy solve may never leave f32
    pt.conic_ip(*CASES["box_qp_dense"](), device="cpu",
                factor_dtype=torch.float32, lastmileProactive=0.0)
    (run,) = torch_solver.runs
    assert run.fast_steps > 0


def test_resolve_factor_dtype():
    resolve = torch_solver.resolve_factor_dtype
    assert resolve("auto") is None
    assert resolve(None) is None
    assert resolve(torch.float32) is torch.float32
    with pytest.raises(ValueError):
        resolve("fast")
    assert "resolve_factor_dtype" in torch_solver.__all__
    # the reference's rule for hardware with native f64
    assert jax_solver.resolve_factor_dtype("auto") is None


def stalling_instance():
    """A separable QP with a wide diagonal spread, one equality and a
    tolerance beyond what an f32 factor reaches: the f32 solve (on the
    reduced, dense problem) stalls, the f64-assembled f32 tier stalls too,
    and the full-precision tier finishes."""
    n = 30
    rng = np.random.default_rng(1)
    Q = np.diag(np.logspace(0, -6, n))
    c = rng.standard_normal(n) * np.logspace(0, -3, n)
    A = np.vstack([np.eye(n), -np.eye(n)])
    return (Q, c, A, -np.ones(2 * n), [("R", 2 * n)], np.ones((1, n)),
            np.array([0.3]))


def config(kktsolver):
    """(factor dtype, assemble dtype, lastmile) of a default-backend
    kktsolver of either package, the dtypes by name."""
    kw = getattr(kktsolver, "keywords", {})

    def name(dt):
        if dt is None:
            return None
        return str(dt).split(".")[-1] if isinstance(dt, torch.dtype) \
            else np.dtype(dt).name

    return (name(kw.get("factor_dtype")), name(kw.get("assemble_dtype")),
            bool(kw.get("lastmile")))


def test_ladder_ends_on_the_tier_the_reference_ends_on(monkeypatch):
    args = stalling_instance()
    tiers = []
    for fn in ("_solve_jit", "_solve_warm_jit"):
        real = getattr(jax_solver, fn)

        def logged(*a, _real=real, **k):
            tiers.append(config(k["kktsolver"]))
            return _real(*a, **k)

        monkeypatch.setattr(jax_solver, fn, logged)
    ref, sol = solve_both(args, factor_dtype=F32, optTol=1e-10)
    mine = [config(r.kktsolver) for r in torch_solver.runs]
    ladder = [("float32", None, True), ("float32", "float64", False),
              (None, None, False)]
    assert tiers == ladder
    assert mine == ladder
    assert [r.status for r in torch_solver.runs][1:] == ["Abandoned",
                                                         "Optimal"]
    assert torch_solver.runs[0].status in ("Abandoned", "Error")
    assert sol.status == ref.status == "Optimal"
    assert_close_to_reference("ladder", ref, sol,
                              y_f64(args, optTol=1e-10), opt_tol=1e-10)


def test_user_kktsolver_never_escalates():
    args = stalling_instance()
    ref, sol = solve_both(
        args, factor_dtype=F32, optTol=1e-10, eliminateEqualities=False,
        kktsolver=dict(
            torch=functools.partial(torch_schur, factor_dtype=torch.float32),
            jax=functools.partial(jax_schur, factor_dtype=jnp.float32)))
    assert len(torch_solver.runs) == 1
    assert sol.status == ref.status
    assert sol.status in ("Abandoned", "Error")
    assert abs(sol.Iter - ref.Iter) <= ITER_BAND


def test_assemble_dtype_matches_jax():
    """f64-assembled, f32-factored Schur solver (the ladder's middle
    tier) as a caller's kktsolver."""
    args = CASES["many_small_socs"]()
    ref, sol = solve_both(
        args, factor_dtype=F32,
        kktsolver=dict(
            torch=functools.partial(torch_schur, factor_dtype=torch.float32,
                                    assemble_dtype=torch.float64),
            jax=functools.partial(jax_schur, factor_dtype=jnp.float32,
                                  assemble_dtype=jnp.float64)))
    assert_close_to_reference("assemble_dtype", ref, sol, y_f64(args))


def ipm_both(args, kk, **opts):
    """ipm_solve of both packages with the same IPMOptions."""
    Q, c, A, b, cones, G, d = args
    n = len(c)
    G = np.zeros((0, n)) if G is None else G
    d = np.zeros(0) if d is None else d
    jst = jax_solver._solve_jit(
        *(jnp.asarray(x) for x in (Q, c, A, b, G, d)),
        spec=ct.ConeSpec(cones), kktsolver=kk["jax"],
        opts=jax_solver.IPMOptions(**opts))
    tst = torch_solver.ipm_solve(
        *(torch.as_tensor(x) for x in (Q, c, A, b, G, d)), ConeSpec(cones),
        kk["torch"], torch_solver.IPMOptions(**opts))
    return (jax_solver.Solution.from_state(jst),
            pt.solution_to_numpy(torch_solver.Solution.from_state(tst)))


LASTMILE = dict(
    torch=functools.partial(torch_schur, factor_dtype=torch.float32,
                            lastmile=True),
    jax=functools.partial(jax_schur, factor_dtype=jnp.float32,
                          lastmile=True))
PLAIN_F32 = dict(
    torch=functools.partial(torch_schur, factor_dtype=torch.float32),
    jax=functools.partial(jax_schur, factor_dtype=jnp.float32))


@pytest.mark.parametrize("name, kk, opts", [
    # the pinned fast variant: the solve runs f32 factors to the end
    ("twoModeKKT_off", LASTMILE, dict(twoModeKKT=False)),
    ("two_mode", LASTMILE, dict(lastmileProactive=50.0)),
    ("fastEig_off", LASTMILE, dict(fastEig=False, lastmileProactive=50.0)),
    ("fastEig_forced", PLAIN_F32, dict(fastEig=True)),
    ("refinedEig", LASTMILE, dict(refinedEig=True, lastmileProactive=50.0)),
])
def test_ipm_options_match_jax(name, kk, opts):
    args = CASES["mixed_rqs"]()
    # 3e-5: what f32 factors and f32 decompositions reach without an
    # escape into full precision (twoModeKKT off, fastEig forced). One
    # iteration further the f32 Cholesky of mat(z), whose eigenvalues then
    # span 1/eps_f32, passes or fails on the last bit: XLA's passes,
    # LAPACK's gives NaN and the forced-f32 solve ends in Error.
    ref, sol = ipm_both(args, kk, optTol=3e-5, mixedResiduals=True,
                        centralityCorrectors=1, **opts)
    assert ref.status == "Optimal"
    assert_close_to_reference(name, ref, sol, y_f64(args), opt_tol=3e-5)


def test_two_mode_factors_only_the_variant_picked(monkeypatch):
    """One generator call per KKT build, in the mode the host chose: fast
    until the last-mile trigger, slow from then on (sticky). The host
    chooses on the eager loop, which this caller's callable is sent to
    here: the device loop takes it too, and on the CPU builds both
    variants each unit, masked."""
    monkeypatch.setattr(torch_solver, "_eager_reason",
                        lambda *a: "the eager loop, which picks on the host")
    modes = []

    def counting(Q, A, G, spec):
        gen = LASTMILE["torch"](Q, A, G, spec)

        def solve3x3gen(F, FinvT, mode="fast"):
            modes.append(mode)
            return gen(F, FinvT, mode=mode)

        return solve3x3gen

    args = CASES["many_small_socs"]()
    sol = pt.conic_ip(*args, device="cpu", factor_dtype=torch.float32,
                      kktsolver=counting, lastmileProactive=50.0)
    assert sol.status == "Optimal"
    (run,) = torch_solver.runs
    assert modes == (["fast"] * (run.fast_steps + 1)
                     + ["slow"] * run.slow_steps)
    assert run.slow_steps > 0
    # pinned: never the slow variant
    del modes[:]
    st = torch_solver.ipm_solve(
        *(torch.as_tensor(x) for x in args[:4]),
        torch.zeros((0, len(args[1])), dtype=torch.float64),
        torch.zeros(0, dtype=torch.float64), ConeSpec(args[4]), counting,
        torch_solver.IPMOptions(twoModeKKT=False, optTol=1e-5))
    assert set(modes) == {"fast"} and len(modes) >= int(st.Iter)


def test_f32_working_dtype_matches_jax():
    """dtype=float32: iterates, factors and residuals all in f32 (mixed
    residuals are then off). optTol 1e-4: f32 rounding of the residuals."""
    args = CASES["box_qp_dense"]()
    ref, sol = solve_both(args, dtype=F32, optTol=1e-4)
    assert np.asarray(ref.y).dtype == np.float32
    assert sol.y.dtype == np.float32
    # both stop on the same iterate, 3e-3 from the f64 solution (optTol
    # 1e-4 on a problem with |y|_inf = 1): held to f32 rounding of y
    assert_close_to_reference("dtype=float32", ref, sol, y_f64(args),
                              opt_tol=1e-4)
    # with f32 factors asked for on top, the same path
    ref2, sol2 = solve_both(args, dtype=F32, factor_dtype=F32, optTol=1e-4)
    assert sol2.status == ref2.status == "Optimal"
    assert abs(sol2.Iter - ref2.Iter) <= ITER_BAND


@pytest.mark.parametrize("dims", [[("S", 6)], [("R", 3), ("Q", 4), ("S", 10)],
                                  [("S", 6), ("S", 6), ("S", 3)]])
def test_eig_dtype_float32_scaling_matches_jax(dims, rng):
    """NT scaling with f32 decompositions: the result comes back in the
    working dtype and agrees with the reference's f32 path, and with the
    f64 scaling, to f32 accuracy (1e-4 relative, through the
    rotation-free quantities λ and FᵀF)."""
    ts, js = ConeSpec(dims), ct.ConeSpec(dims)
    z, s = cone_interior(rng, ts), cone_interior(rng, ts)
    F32t = tsc.nt_scaling(ts, torch.as_tensor(z), torch.as_tensor(s),
                          eig_dtype=torch.float32)
    F64t = tsc.nt_scaling(ts, torch.as_tensor(z), torch.as_tensor(s))
    F32j = jsc.nt_scaling(js, jnp.asarray(z), jnp.asarray(s),
                          eig_dtype=jnp.float32)
    lam = tsc.apply(ts, F32t, torch.as_tensor(z))
    assert lam.dtype == torch.float64
    assert all(sd.S.dtype == torch.float64 for sd in F32t.sdp)
    lam_j = np.asarray(jsc.apply(js, F32j, jnp.asarray(z)))
    lam_64 = tsc.apply(ts, F64t, torch.as_tensor(z)).numpy()
    scale = np.max(np.abs(lam_64))
    assert np.max(np.abs(lam.numpy() - lam_64)) < 1e-4 * scale
    assert np.max(np.abs(lam.numpy() - lam_j)) < 1e-4 * scale
    x = rng.standard_normal(ts.m)
    g32 = tsc.apply_adjoint(ts, F32t, tsc.apply(ts, F32t, torch.as_tensor(x)))
    g64 = tsc.apply_adjoint(ts, F64t, tsc.apply(ts, F64t, torch.as_tensor(x)))
    gj = np.asarray(jsc.apply_adjoint(js, F32j,
                                      jsc.apply(js, F32j, jnp.asarray(x))))
    gs = np.max(np.abs(g64.numpy()))
    assert np.max(np.abs(g32.numpy() - g64.numpy())) < 1e-4 * gs
    assert np.max(np.abs(g32.numpy() - gj)) < 1e-4 * gs


def test_spectral_backend_with_f32_decompositions_matches_jax():
    args = CASES["small_sdp"]()
    ref, sol = solve_both(
        args, kktsolver=dict(torch=torch_spectral(torch.float32),
                             jax=jax_spectral(jnp.float32)))
    assert_close_to_reference("spectral_f32", ref, sol, y_f64(args))
    assert torch_spectral(torch.float32) is torch_spectral(torch.float32)
