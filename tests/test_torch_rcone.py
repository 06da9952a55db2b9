"""The R cones' iteration work (``conicip_tpu_torch/ops/rcone.py``).

Inputs are made with numpy from a seed and fed to the port's plain twins
(the CPU's route) and to the JAX package's functions on R specs
(``conicip_tpu.cones.scaling``, ``conicip_tpu.cones.algebra`` and the step
arithmetic of ``conicip_tpu/solver/ipm.py``), for one instance and for a
stack of three (``jax.vmap`` over the reference), in f64 and f32.
Tolerances: elementwise outputs and the step to 1e-14 relative in f64 and
1e-6 in f32 (each is a few correctly rounded operations, and XLA may fuse
them); the reduced values (μ̄, the fts dots, fts) to 1e-13 in f64 and 1e-5
in f32 of the sum of their terms' magnitudes (another summation order).

Whole R-only solves (the box QP on the diagonal backend with and without
an equality, the dense box QP on Schur with its Gondzio corrector, an LP,
a stack of four box QPs through ``solve_batch``) give the reference's
status and ``Iter`` and y within 1e-8. On the CPU the fused path is bit
for bit the generic ``cones/`` sequence it replaces (``ipm._fused_r``
patched to False), on the device loop and on the eager loop, NaN
directions included. The CUDA kernels are held against these twins on the
card (``tests/test_torch_cuda.py``, ``chip_smoke.py`` ``[rcone]``).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import conicip_tpu as ct
import conicip_tpu.parallel as ct_parallel
from conicip_tpu.cones import algebra as jalg
from conicip_tpu.cones import scaling as jsc
from conicip_tpu.cones.spec import ConeSpec as JSpec
import conicip_tpu_torch as pt
from conicip_tpu_torch.kkt import kktsolver_diag, kktsolver_schur
from conicip_tpu_torch.models import batched_box_qp, box_qp_dense
from conicip_tpu_torch.ops import rcone
from conicip_tpu_torch.solver import ipm
from conicip_tpu_torch.cones.spec import ConeSpec

torch.set_num_threads(1)

M = 37
SPEC = JSpec([("R", M)])
STACKS = [(), (3,)]  # one instance, and a stack
# dtype: (elementwise relative tolerance, reduced values' tolerance)
TOL = {"float64": (1e-14, 1e-13), "float32": (1e-6, 1e-5)}


def t(x):
    return torch.from_numpy(np.asarray(x).copy())


def j(x):
    return jnp.asarray(np.asarray(x))


def ref(fn, bs):
    """The reference's single-instance ``fn``, mapped over a stack."""
    return jax.vmap(fn) if bs else fn


def inputs(bs, dtype, seed):
    """An interior point (v, s), a direction (dv, ds) and two more
    vectors, and per-instance σμ and ã."""
    rng = np.random.default_rng(seed)
    dt = np.dtype(dtype)
    pos = lambda: rng.uniform(0.2, 3.0, size=bs + (M,)).astype(dt)  # noqa
    nrm = lambda: rng.standard_normal(bs + (M,)).astype(dt)  # noqa
    one = lambda lo, hi: rng.uniform(lo, hi, size=bs).astype(dt)  # noqa
    return dict(v=pos(), s=pos(), dv=nrm(), ds=nrm(), x=nrm(), y=nrm(),
                smu=one(0.3, 0.6), atil=one(0.5, 1.0))


def close(got, want, rtol):
    want = np.asarray(want)
    np.testing.assert_allclose(got.numpy(), want, rtol=rtol,
                               atol=rtol * np.abs(want).max())


def close_sum(got, want, terms, tol):
    """A reduced value within ``tol`` of the magnitudes of its terms."""
    bound = tol * np.abs(terms).sum(-1)
    assert np.all(np.abs(got.numpy() - np.asarray(want)) <= bound)


def jscaling(v, s):
    F = jsc.nt_scaling(SPEC, v, s)
    return F, jsc.nt_inv_adjoint(SPEC, F), jsc.apply(SPEC, F, v)


@pytest.mark.parametrize("dtype", TOL)
@pytest.mark.parametrize("bs", STACKS)
def test_scaling_matches_the_reference(bs, dtype):
    el, red = TOL[dtype]
    a = inputs(bs, dtype, 1)

    def want(v, s):
        F, FiT, lam = jscaling(v, s)
        return (F.r_d, FiT.r_d, lam, jalg.cone_prod(SPEC, lam, lam),
                jnp.dot(v, s))

    got = rcone.r_scaling(t(a["v"]), t(a["s"]))
    exp = ref(want, bs)(j(a["v"]), j(a["s"]))
    for g, e in zip(got[:4], exp[:4]):
        assert g.dtype == getattr(torch, dtype) and g.shape == bs + (M,)
        close(g, e, el)
    assert got[4].shape == bs
    close_sum(got[4], exp[4], a["v"] * a["s"], red)


@pytest.mark.parametrize("dtype", TOL)
@pytest.mark.parametrize("bs", STACKS)
def test_reduce4_matches_the_reference(bs, dtype):
    el, _ = TOL[dtype]
    a = inputs(bs, dtype, 2)
    r_d, _, lam, _, _ = rcone.r_scaling(t(a["v"]), t(a["s"]))

    def want(v, s, rs, rv, dv):
        F, _, lam = jscaling(v, s)
        t1 = jsc.apply_adjoint(SPEC, F, jalg.cone_div(SPEC, rs, lam))
        return t1, rv + t1, t1 - jsc.apply_adjoint(SPEC, F,
                                                   jsc.apply(SPEC, F, dv))

    t1, vt = rcone.r_reduce4_pre(t(a["x"]), lam, r_d, t(a["y"]))
    ds = rcone.r_reduce4_post(t1, r_d, t(a["dv"]))
    exp = ref(want, bs)(*map(j, (a["v"], a["s"], a["x"], a["y"], a["dv"])))
    for g, e in zip((t1, vt, ds), exp):
        close(g, e, el)


@pytest.mark.parametrize("dtype", TOL)
@pytest.mark.parametrize("bs", STACKS)
def test_complementarity_vectors_match_the_reference(bs, dtype):
    el, _ = TOL[dtype]
    a = inputs(bs, dtype, 3)
    r_d, rinv, lam, lam2, _ = rcone.r_scaling(t(a["v"]), t(a["s"]))
    e = jnp.ones(M, dtype=dtype)

    def want(v, s, dv, ds, smu, atil):
        F, FiT, lam = jscaling(v, s)
        Fdv, FiTds = jsc.apply(SPEC, F, dv), jsc.apply(SPEC, FiT, ds)
        rls = jalg.cone_prod(SPEC, lam, lam)
        lc = -(jalg.cone_prod(SPEC, FiTds, Fdv)) + smu * e
        k4 = (jalg.cone_prod(SPEC, lam, Fdv)
              + jalg.cone_prod(SPEC, lam, FiTds))
        w = jalg.cone_prod(SPEC, lam - atil * Fdv, lam - atil * FiTds)
        q = jalg.centrality_correction(SPEC, w, 0.1 * smu, 10.0 * smu)
        return rls - lc, k4, -q, w

    dv, ds, smu, atil = t(a["dv"]), t(a["ds"]), t(a["smu"]), t(a["atil"])
    got = (rcone.r_corrector(lam2, r_d, rinv, dv, ds, smu),
           rcone.r_k4(lam, r_d, rinv, dv, ds),
           rcone.r_gondzio(lam, r_d, rinv, dv, ds, atil, smu))
    *exp, w = ref(want, bs)(*map(j, (a["v"], a["s"], a["dv"], a["ds"],
                                      a["smu"], a["atil"])))
    for g, x in zip(got, exp):
        close(g, x, el)
    # the trial hits all three parts of the clip
    lo = 0.1 * a["smu"][..., None]
    hi = 10.0 * a["smu"][..., None]
    w = np.asarray(w)
    assert (w < lo).any() and (w > hi).any() and ((w > lo) & (w < hi)).any()


def jstep(v, s, dv, ds, scale):
    # solver/ipm.py's steps(): each max-step clamped to 1, their minimum
    return jnp.minimum(
        jnp.minimum(jalg.maxstep(SPEC, v, dv * scale), 1.0),
        jnp.minimum(jalg.maxstep(SPEC, s, ds * scale), 1.0))


@pytest.mark.parametrize("dtype", TOL)
@pytest.mark.parametrize("bs", STACKS)
def test_step_and_fts_match_the_reference(bs, dtype):
    el, red = TOL[dtype]
    a = inputs(bs, dtype, 4)
    dt = np.dtype(dtype).type

    def want(v, s, dv, ds):
        alpha = jstep(v, s, dv, ds, dt(1.0))
        d = (jnp.dot(v, s), jnp.dot(v, ds), jnp.dot(dv, s), jnp.dot(dv, ds))
        # the reference's fts (conicip_tpu/solver/ipm.py:399)
        f = d[0] - alpha * d[1] - alpha * d[2] + alpha * alpha * d[3]
        return alpha, jnp.stack(d, -1), f

    args = [t(a[k]) for k in ("v", "s", "dv", "ds")]
    alpha, ok, dots, f = rcone.r_step(*args, fts=True)
    e_alpha, e_dots, e_f = ref(want, bs)(*map(j, (a["v"], a["s"], a["dv"],
                                                   a["ds"])))
    close(alpha, e_alpha, el)
    assert ok.dtype == torch.bool and ok.all()
    terms = np.stack([a["v"] * a["s"], a["v"] * a["ds"], a["dv"] * a["s"],
                      a["dv"] * a["ds"]], -2)
    close_sum(dots, e_dots, terms, red)
    close_sum(f, e_f, terms.reshape(bs + (-1,)), red)
    # the fraction-to-boundary step: the direction scaled first
    inv_dtb = 1.0 / (1.0 - 0.01)
    alpha, ok = rcone.r_step(*args, inv_dtb)
    e_alpha = ref(lambda *x: jstep(*x, dt(inv_dtb)), bs)(
        *map(j, (a["v"], a["s"], a["dv"], a["ds"])))
    close(alpha, e_alpha, el)


@pytest.mark.parametrize("dtype", TOL)
def test_a_nan_or_inf_direction(dtype):
    # where(d > 0, x / d, inf): a NaN entry of the direction is no bound,
    # as in the reference; +inf bounds the step at 0; either makes the
    # direction not finite, which freezes the step in the loop
    el, _ = TOL[dtype]
    a = inputs((3,), dtype, 5)
    dv = a["dv"].copy()
    dv[0, 3] = np.nan
    dv[1, 5] = np.inf
    args = [t(x) for x in (a["v"], a["s"], dv, a["ds"])]
    alpha, ok = rcone.r_step(*args, 1.0)
    e_alpha = jax.vmap(lambda *x: jstep(*x, np.dtype(dtype).type(1.0)))(
        *map(j, (a["v"], a["s"], dv, a["ds"])))
    close(alpha, e_alpha, el)
    assert ok.tolist() == [False, False, True]
    assert alpha[1] == 0.0
    # without the NaN entry the first instance's step is the same
    clean = a["dv"].copy()
    clean[0, 3] = -1.0
    again, _ = rcone.r_step(t(a["v"]), t(a["s"]), t(clean), t(a["ds"]), 1.0)
    assert again[0] == alpha[0]


def test_the_entries_refuse_mixed_dtypes_and_devices():
    a = inputs((), "float64", 6)
    with pytest.raises(ValueError, match="operands"):
        rcone.r_scaling(t(a["v"]), t(a["s"]).float())


# ── whole R-only solves against the reference ──


def box(n, eq=False):
    """The README box QP; with one equality if ``eq``."""
    H = 0.5 * np.eye(n)
    A = np.vstack([np.eye(n), -np.eye(n)])
    G, d = (np.ones((1, n)), np.array([1.0])) if eq else (None, None)
    return (H, H @ np.arange(1.0, n + 1), A, -np.ones(2 * n), [("R", 2 * n)],
            G, d)


def lp(n=20, m=30, seed=7):
    rng = np.random.default_rng(seed)
    A = rng.standard_normal((m, n))
    b = A @ rng.random(n) - rng.random(m)
    return np.zeros((n, n)), -A.T @ rng.random(m), A, b, [("R", m)]


SOLVES = {
    "diag": lambda: box(20),
    "diag_eq": lambda: box(20, eq=True),
    "schur": lambda: box_qp_dense(n=30, seed=3).args(),
    "lp": lp,
}


@pytest.fixture
def scalings(monkeypatch):
    """Calls of the fused scaling (the fused path ran)."""
    calls = []
    real = rcone.r_scaling
    monkeypatch.setattr(rcone, "r_scaling",
                        lambda *a: calls.append(1) or real(*a))
    return calls


@pytest.mark.parametrize("name", SOLVES)
def test_a_solve_matches_the_reference(name, scalings):
    args = SOLVES[name]()
    want = ct.conic_ip(*args)
    got = pt.conic_ip(*args, device="cpu")
    assert scalings
    assert (got.status, got.Iter) == (want.status, want.Iter)
    np.testing.assert_allclose(got.y.numpy(), np.asarray(want.y), rtol=0,
                               atol=1e-8)


def test_a_stack_matches_the_reference(scalings):
    args = batched_box_qp(4, n=30)
    want = ct_parallel.solve_batch(*args)
    got = pt.solve_batch(*args, device="cpu")
    assert scalings
    assert got.status.tolist() == np.asarray(want.status).tolist()
    assert got.Iter.tolist() == np.asarray(want.Iter).tolist()
    np.testing.assert_allclose(got.y.numpy(), np.asarray(want.y), rtol=0,
                               atol=1e-8)


# ── on the CPU, the fused path is the generic path bit for bit ──


def nan_direction(kktsolver, after):
    """``kktsolver`` whose 3x3 solves give a NaN entry of dv from the
    ``after``-th on (a failed factor): the step is frozen there."""
    calls = [0]

    def kkt(Q, A, G, spec):
        gen = kktsolver(Q, A, G, spec)

        def solve3x3gen(F, FinvT):
            solve = gen(F, FinvT)

            def solve3x3(x, y, z):
                dy, dw, dv = solve(x, y, z)
                calls[0] += 1
                if calls[0] > after:
                    dv = dv.clone()
                    dv[..., 0] = float("nan")
                return dy, dw, dv
            return solve3x3
        return solve3x3gen
    return kkt


def eager(*args, **kw):
    """The eager loop: ``ipm_solve`` with no device loop."""
    Q, c, A, b, cones = (torch.as_tensor(np.asarray(x, dtype=np.float64))
                         if i < 4 else x for i, x in enumerate(args[:5]))
    n = c.shape[-1]
    G = torch.zeros(0, n, dtype=torch.float64)
    d = torch.zeros(0, dtype=torch.float64)
    return ipm.ipm_solve(Q, c, A, b, G, d, ConeSpec(cones), **kw)


BITWISE = {
    "diag_eq": lambda: pt.conic_ip(*box(20, eq=True), device="cpu"),
    "diag_f32_mixed": lambda: pt.conic_ip(*box(20), device="cpu",
                                          factor_dtype=torch.float32),
    "schur_f32_lastmile": lambda: pt.conic_ip(
        *box_qp_dense(n=30, seed=5).args(), device="cpu",
        factor_dtype=torch.float32),
    "schur_gondzio_2": lambda: pt.conic_ip(
        *box_qp_dense(n=30, seed=6).args(), device="cpu",
        centralityCorrectors=2),
    "working_f32": lambda: pt.conic_ip(*box(20), device="cpu",
                                       dtype=torch.float32),
    "lp": lambda: pt.conic_ip(*lp(), device="cpu"),
    "stack": lambda: pt.solve_batch(*batched_box_qp(4, n=30), device="cpu"),
    "eager_schur": lambda: eager(
        *box_qp_dense(n=30, seed=8).args(), kktsolver=kktsolver_schur,
        opts=ipm.IPMOptions(centralityCorrectors=1)),
    "nan_direction": lambda: pt.conic_ip(
        *box(20), device="cpu", kktsolver=nan_direction(kktsolver_diag, 4),
        maxIters=8),
    "nan_direction_eager": lambda: eager(
        *box(20)[:5], kktsolver=nan_direction(kktsolver_diag, 4),
        opts=ipm.IPMOptions(maxIters=8)),
}


def fields(sol):
    def arr(x):
        return np.asarray(x.numpy() if isinstance(x, torch.Tensor) else x)
    return [arr(getattr(sol, f)) for f in (
        "y", "w", "v", "status", "Iter", "pobj", "dobj", "prFeas")]


@pytest.mark.parametrize("name", BITWISE)
def test_the_fused_path_is_the_generic_path_bit_for_bit(name, monkeypatch,
                                                        scalings):
    fused = fields(BITWISE[name]())
    assert scalings
    monkeypatch.setattr(ipm, "_fused_r", lambda spec: False)
    calls = len(scalings)
    generic = fields(BITWISE[name]())
    assert len(scalings) == calls
    for a, b in zip(fused, generic):
        assert a.shape == b.shape and a.tobytes() == b.tobytes()
