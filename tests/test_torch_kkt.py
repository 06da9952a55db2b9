"""The port's KKT solvers (conicip_tpu_torch.kkt) against conicip_tpu.kkt.

One ``solve3x3gen(F, FinvT)`` solve through the dense Schur backend (with
and without equalities), through the diagonal backend in its three
equality modes and through the spectral backend on R, Q and S cones, from
the same numpy data on the CPU in f64, must agree with the JAX package at
1e-9 and solve the 3x3 KKT system.
"""

import functools

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import conicip_tpu.cones as jc
import conicip_tpu.kkt as jk
from conicip_tpu.kkt.diag import equality_mode as jax_equality_mode
from conicip_tpu.kkt.spectral import kktsolver_spectral as jax_spectral
from conicip_tpu.kkt.spectral import spectral_applicable as jax_applicable
from conicip_tpu_torch.cones import scaling as tsc
from conicip_tpu_torch.cones.spec import ConeSpec
from conicip_tpu_torch.kkt import (kktsolver_diag, kktsolver_schur, pivot,
                                   separable)
from conicip_tpu_torch.kkt.diag import equality_mode
from conicip_tpu_torch.kkt.spectral import (kktsolver_spectral,
                                            spectral_applicable,
                                            spectral_kktsolver)
from conicip_tpu_torch.ops.control import retry_attempts, retry_while
from test_torch_cones import cone_interior

torch.set_num_threads(1)

N = 8


def t(x):
    return torch.from_numpy(np.asarray(x, dtype=np.float64).copy())


def dense_problem(rng, p):
    B = rng.standard_normal((N, N))
    Q = B @ B.T / N
    A = rng.standard_normal((12, N))
    G = rng.standard_normal((p, N))
    return Q, A, G


def bound_problem(rng, G):
    Q = np.diag(rng.uniform(0.5, 2.0, N))
    A = np.vstack([np.diag(rng.uniform(0.5, 2.0, N)), -np.eye(N)])
    return Q, A, G


def g_for(mode, rng):
    if mode == "none":
        return np.zeros((0, N))
    if mode == "disjoint":
        G = np.zeros((2, N))
        G[0, 1], G[1, 5] = 2.0, -1.0
        return G
    return rng.standard_normal((2, N))


def solve_both(Q, A, G, jax_solver, torch_solver, rng):
    m, p = A.shape[0], G.shape[0]
    z, s = rng.uniform(0.5, 2.0, m), rng.uniform(0.5, 2.0, m)
    ry, rw, rv = (rng.standard_normal(N), rng.standard_normal(p),
                  rng.standard_normal(m))
    cones = [("R", m)]

    js = jc.ConeSpec(cones)
    Fj = jc.nt_scaling(js, jnp.asarray(z), jnp.asarray(s))
    solve_j = jax_solver(jnp.asarray(Q), jnp.asarray(A), jnp.asarray(G), js)(
        Fj, jc.nt_inv_adjoint(js, Fj))
    ref = [np.asarray(u) for u in solve_j(jnp.asarray(ry), jnp.asarray(rw),
                                          jnp.asarray(rv))]

    ts = ConeSpec(cones)
    F = tsc.nt_scaling(ts, t(z), t(s))
    solve_t = torch_solver(t(Q), t(A), t(G), ts)(F, tsc.nt_inv_adjoint(ts, F))
    out = [u.numpy() for u in solve_t(t(ry), t(rw), t(rv))]

    for a, b in zip(out, ref):
        np.testing.assert_allclose(a, b, rtol=1e-9, atol=1e-9)
    # the 3x3 system itself: [Q Gᵀ -Aᵀ; G 0 0; A 0 FᵀF] [a b c] = [y w v]
    a, b, c = out
    W = np.diag(F.r_d.numpy() ** 2)
    np.testing.assert_allclose(Q @ a + G.T @ b - A.T @ c, ry, atol=1e-9)
    np.testing.assert_allclose(G @ a, rw, atol=1e-9)
    np.testing.assert_allclose(A @ a + W @ c, rv, atol=1e-9)


@pytest.mark.parametrize("p", [0, 3])
def test_schur_matches_jax(p, rng):
    Q, A, G = dense_problem(rng, p)
    solve_both(Q, A, G, jk.kktsolver_schur, kktsolver_schur, rng)


@pytest.mark.parametrize("mode", ["none", "disjoint", "woodbury"])
def test_diag_matches_jax(mode, rng):
    Q, A, G = bound_problem(rng, g_for(mode, rng))
    spec = ConeSpec([("R", A.shape[0])])
    assert separable(Q, A, G, spec)
    assert equality_mode(Q, G) == mode
    solve_both(Q, A, G,
               functools.partial(jk.kktsolver_diag, eq_mode=mode),
               functools.partial(kktsolver_diag, eq_mode=mode), rng)


def test_custom_pivot_matches_schur(rng):
    # a user 2x2 solver through pivot: dense solve of [[M, Gᵀ], [G, 0]]
    Q, A, G = dense_problem(rng, 2)

    def kkt2x2_dense(Q_, A_, G_, spec):
        def gen(F, FinvT):
            Atil = tsc.apply_mat(spec, FinvT, A_)
            M = Q_ + Atil.T @ Atil
            p = G_.shape[0]
            K = torch.cat([torch.cat([M, G_.T], 1),
                           torch.cat([G_, torch.zeros(p, p, dtype=M.dtype)], 1)])

            def solve(by, bw):
                x = torch.linalg.solve(K, torch.cat([by, bw]))
                return x[:N], x[N:]

            return solve

        return gen

    solve_both(Q, A, G, jk.kktsolver_schur, pivot(kkt2x2_dense), rng)


def test_structure_checks_match_jax(rng):
    cases = [
        bound_problem(rng, np.zeros((0, N))),
        bound_problem(rng, g_for("disjoint", rng)),
        bound_problem(rng, g_for("woodbury", rng)),
        dense_problem(rng, 0),
        (np.zeros((N, N)), np.eye(N), rng.standard_normal((1, N))),
    ]
    for Q, A, G in cases:
        spec = ConeSpec([("R", A.shape[0])])
        assert equality_mode(Q, G) == jax_equality_mode(Q, G)
        assert separable(Q, A, G, spec) == jk.separable(
            Q, A, G, jc.ConeSpec([("R", A.shape[0])]))
        assert separable(t(Q), t(A), t(G), spec) == separable(Q, A, G, spec)
    assert not separable(np.eye(2), np.eye(2), None,
                         ConeSpec([("Q", 2)]))
    with pytest.raises(ValueError):
        kktsolver_diag(t(np.eye(3)), t(np.eye(3)), t(np.zeros((0, 3))),
                       ConeSpec([("Q", 3)]))


def test_lower_precision_factors_not_ported():
    """Lower-precision factors are ported: both backends take
    ``factor_dtype``, return the working dtype, and agree with their
    full-precision solve to f32 accuracy."""
    Q, A, G = (t(np.eye(3)), t(np.eye(3)), t(np.zeros((0, 3))))
    spec = ConeSpec([("R", 3)])
    F = tsc.nt_scaling(spec, t(np.array([1.0, 2.0, 0.5])),
                       t(np.array([0.7, 0.3, 1.5])))
    FinvT = tsc.nt_inv_adjoint(spec, F)
    rhs = (t(np.array([1.0, -2.0, 0.5])), t(np.zeros(0)),
           t(np.array([0.3, 0.1, -0.4])))
    for backend in (kktsolver_schur, kktsolver_diag):
        full = backend(Q, A, G, spec)(F, FinvT)(*rhs)
        low = backend(Q, A, G, spec, factor_dtype=torch.float32)(F, FinvT)(
            *rhs)
        for u, v in zip(full, low):
            assert v.dtype == torch.float64
            np.testing.assert_allclose(v.numpy(), u.numpy(), rtol=1e-5,
                                       atol=1e-6)


def test_retry_while_escalates_until_good_or_cap():
    # a fixed number of predicated attempts (two at the Schur solver's
    # scale0 1e3, factor 1e3, cap 1e7), each given skip = ~bad(state) on
    # the device, nothing read back to decide them
    seen = []

    def step(scale, skip, state):
        seen.append((scale, bool(skip)))
        return torch.where(skip, state, torch.tensor(scale))

    first = torch.tensor(-1.0)
    assert retry_attempts(1e3, 1e3, 1e7) == 2
    assert retry_attempts(1e3, 1e3, 1e3) == 0
    # healthy first attempt: both attempts skipped, the first kept
    good = torch.tensor(False)
    assert retry_while(lambda s: good, step, first, 1e3, 1e3, 1e7) == -1.0
    assert seen == [(1e3, True), (1e6, True)]
    # always bad: tries 1e3 and 1e6, stops at the cap
    del seen[:]
    bad = torch.tensor(True)
    assert retry_while(lambda s: bad, step, first, 1e3, 1e3, 1e7) == 1e6
    assert seen == [(1e3, False), (1e6, False)]
    # bad until the first retry: the second is skipped
    del seen[:]
    assert retry_while(lambda s: s < 0, step, first, 1e3, 1e3, 1e7) == 1e3
    assert seen == [(1e3, False), (1e6, True)]


def test_schur_ridge_retry_recovers_from_failed_factor(rng, monkeypatch):
    # A first factor that fails (non-finite) must be retried with a larger
    # ridge, and the solve must still be exact to rounding.
    from conicip_tpu_torch.kkt import schur

    calls = []
    real = schur.cholesky

    def flaky(M, **predicate):
        calls.append(predicate.get("skip"))
        L = real(M, **predicate)
        return torch.full_like(L, float("nan")) if len(calls) == 1 else L

    monkeypatch.setattr(schur, "cholesky", flaky)
    Q, A, G = dense_problem(rng, 0)
    solve_both(Q, A, G, jk.kktsolver_schur, kktsolver_schur, rng)
    # the first factor, then two predicated retries: the first taken, the
    # second skipped
    assert len(calls) == 3 and calls[0] is None
    assert [bool(s) for s in calls[1:]] == [False, True]


@pytest.mark.parametrize("cones, q", [
    ([("S", 15)], 0.0), ([("S", 15)], 1.0), ([("S", 15)], 2.5),
    ([("R", 6), ("Q", 5), ("S", 10)], 0.7),
    ([("R", 6), ("Q", 5), ("S", 10)], 1.0),
    ([("Q", 3), ("R", 2), ("Q", 3), ("S", 3), ("S", 3)], 1.3),
])
def test_spectral_satisfies_kkt_equations_and_matches_jax(cones, q, rng):
    # the 3x3 contract with A = I, G empty, Q = qI: q a − c = x and
    # a + FᵀF c = z
    spec, js = ConeSpec(cones), jc.ConeSpec(cones)
    n = spec.m
    z_v, z_s = cone_interior(rng, spec), cone_interior(rng, spec)
    x, z = rng.standard_normal(n), rng.standard_normal(n)
    F = tsc.nt_scaling(spec, t(z_v), t(z_s))
    solve = kktsolver_spectral(t(q * np.eye(n)), t(np.eye(n)),
                               t(np.zeros((0, n))), spec)(
        F, tsc.nt_inv_adjoint(spec, F))
    a, b, c = solve(t(x), t(np.zeros(0)), t(z))
    assert b.shape == (0,)
    np.testing.assert_allclose((q * a - c).numpy(), x, atol=1e-9)
    FtFc = tsc.apply_adjoint(spec, F, tsc.apply(spec, F, c))
    np.testing.assert_allclose((a + FtFc).numpy(), z, atol=1e-8)
    Fj = jc.nt_scaling(js, jnp.asarray(z_v), jnp.asarray(z_s))
    ref = jax_spectral(q * jnp.eye(n), jnp.eye(n), jnp.zeros((0, n)), js)(
        Fj, jc.nt_inv_adjoint(js, Fj))(jnp.asarray(x), jnp.zeros(0),
                                       jnp.asarray(z))
    for u, r in zip((a, c), (ref[0], ref[2])):
        np.testing.assert_allclose(u.numpy(), np.asarray(r), rtol=1e-9,
                                   atol=1e-9)


def test_spectral_applicable_matches_jax():
    n = 10  # one 4 x 4 S cone
    I = np.eye(n)
    Q2, A2 = I.copy(), I.copy()
    Q2[0, 0], A2[0, 1] = 3.0, 0.5
    S = [("S", n)]
    cases = [
        (2.5 * I, I, None, S, True),
        (np.broadcast_to(I, (3, n, n)), np.broadcast_to(I, (3, n, n)), None,
         S, True),
        (I, A2, None, S, False),  # A is not I
        (Q2, I, None, S, False),  # Q is not qI
        (I, I, np.ones((1, n)), S, False),  # equalities
        (np.eye(n + 2), np.eye(n + 2), None, [("R", 2), ("S", n)], True),
        # Q cones need q > 0
        (np.zeros((n + 3, n + 3)), np.eye(n + 3), None, [("Q", 3), ("S", n)],
         False),
        (I, np.vstack([np.zeros((1, n)), I])[:, :n], None, [("Q", n)], False),
    ]
    for Q, A, G, cones, want in cases:
        assert spectral_applicable(Q, A, G, ConeSpec(cones)) is want
        assert jax_applicable(Q, A, G, jc.ConeSpec(cones)) is want
        assert spectral_applicable(t(Q), t(A), None if G is None else t(G),
                                   ConeSpec(cones)) is want
    assert spectral_kktsolver() is spectral_kktsolver(None)
    # "refined" is accepted and is the working-dtype decomposition
    spec = ConeSpec(S)
    rng = np.random.default_rng(0)
    F = tsc.nt_scaling(spec, t(cone_interior(rng, spec)),
                       t(cone_interior(rng, spec)))
    FinvT = tsc.nt_inv_adjoint(spec, F)
    args = (t(I), t(I), t(np.zeros((0, n))), spec)
    rhs = (t(rng.standard_normal(n)), t(np.zeros(0)),
           t(rng.standard_normal(n)))
    for u, v in zip(spectral_kktsolver("refined")(*args)(F, FinvT)(*rhs),
                    spectral_kktsolver(None)(*args)(F, FinvT)(*rhs)):
        assert torch.equal(u, v)


MODE_DIMS = {"R": [("R", 12)], "RQ": [("R", 5), ("Q", 4), ("Q", 3)],
             "RQS": [("R", 3), ("Q", 3), ("S", 6)]}


@pytest.mark.parametrize("dims", list(MODE_DIMS))
@pytest.mark.parametrize("p", [0, 2])
@pytest.mark.parametrize("layer", ["kktsolver_2x2", "pivot"])
def test_mode_variants_match_jax(layer, p, dims, rng):
    """The two-variant ``mode`` contract of a ``lastmile`` generator, at
    the 2x2 layer and through ``pivot``, on one F: the slow variant is the
    full-precision solve (1e-10 of the reference's), the fast variant the
    f32 one (1e-4 relative, of the reference's fast variant and of the
    slow solve), the default mode is the fast one, and without ``lastmile``
    the generator takes no ``mode`` at all."""
    from conicip_tpu_torch.kkt import kktsolver_2x2
    from conicip_tpu_torch.kkt.pivot import accepts_mode

    cones = MODE_DIMS[dims]
    ts, js = ConeSpec(cones), jc.ConeSpec(cones)
    m = ts.m
    B = rng.standard_normal((N, N))
    Q, A, G = B @ B.T / N, rng.standard_normal((m, N)), \
        rng.standard_normal((p, N))
    z, s = cone_interior(rng, ts), cone_interior(rng, ts)
    F = tsc.nt_scaling(ts, t(z), t(s))
    FinvT = tsc.nt_inv_adjoint(ts, F)
    Fj = jc.nt_scaling(js, jnp.asarray(z), jnp.asarray(s))
    FjinvT = jc.nt_inv_adjoint(js, Fj)
    ry, rw, rv = (rng.standard_normal(N), rng.standard_normal(p),
                  rng.standard_normal(m))
    kw = dict(factor_dtype=torch.float32, lastmile=True)
    jkw = dict(factor_dtype=jnp.float32, lastmile=True)
    if layer == "pivot":
        gen = kktsolver_schur(t(Q), t(A), t(G), ts, **kw)
        ref = jk.kktsolver_schur(jnp.asarray(Q), jnp.asarray(A),
                                 jnp.asarray(G), js, **jkw)
        plain = kktsolver_schur(t(Q), t(A), t(G), ts,
                                factor_dtype=torch.float32)
        rhs, jrhs = (t(ry), t(rw), t(rv)), (jnp.asarray(ry), jnp.asarray(rw),
                                            jnp.asarray(rv))
    else:
        gen = kktsolver_2x2(t(Q), t(A), t(G), ts, **kw)
        ref = jk.kktsolver_2x2(jnp.asarray(Q), jnp.asarray(A),
                               jnp.asarray(G), js, **jkw)
        plain = kktsolver_2x2(t(Q), t(A), t(G), ts,
                              factor_dtype=torch.float32)
        rhs, jrhs = (t(ry), t(rw)), (jnp.asarray(ry), jnp.asarray(rw))
    assert accepts_mode(gen) and not accepts_mode(plain)

    def run(g, F_, Fi_, r, **mode):
        return [np.asarray(u) for u in g(F_, Fi_, **mode)(*r)]

    slow = run(gen, F, FinvT, rhs, mode="slow")
    fast = run(gen, F, FinvT, rhs, mode="fast")
    default = run(gen, F, FinvT, rhs)
    single = run(plain, F, FinvT, rhs)
    slow_j = run(ref, Fj, FjinvT, jrhs, mode="slow")
    fast_j = run(ref, Fj, FjinvT, jrhs, mode="fast")
    scale = max(np.max(np.abs(u)) for u in slow_j if u.size)
    for k in range(len(slow)):
        assert slow[k].dtype == fast[k].dtype == np.float64
        np.testing.assert_allclose(slow[k], slow_j[k], rtol=0,
                                   atol=1e-10 * scale)
        np.testing.assert_allclose(fast[k], fast_j[k], rtol=0,
                                   atol=1e-4 * scale)
        np.testing.assert_allclose(fast[k], slow[k], rtol=0,
                                   atol=1e-4 * scale)
        np.testing.assert_array_equal(default[k], fast[k])
        np.testing.assert_array_equal(single[k], fast[k])


# ── stacks of instances ──


def test_retry_while_retries_only_the_bad_instances():
    # instance 1 needs boost 1e3, instance 2 needs 1e6, instance 0 nothing:
    # each ends with the state its own loop gives it
    need = torch.tensor([0.0, 1e3, 1e6])
    seen = []

    def attempt(boost):
        return torch.where(boost >= need, boost, torch.nan)[:, None].repeat(1, 2)

    def step(boost, skip, state):
        seen.append(boost)
        return torch.where(skip[:, None], state, attempt(torch.tensor(boost)))

    out = retry_while(lambda s: ~torch.isfinite(s).all(-1), step,
                      attempt(torch.tensor(1.0)), 1e3, 1e3, 1e7)
    assert seen == [1e3, 1e6]
    assert out[:, 0].tolist() == [1.0, 1e3, 1e6]
    # one instance that never recovers stops at the cap; the rest keep theirs
    need = torch.tensor([0.0, float("inf")])
    out = retry_while(lambda s: ~torch.isfinite(s).all(-1), step,
                      attempt(torch.tensor(1.0)), 1e3, 1e3, 1e7)
    assert out[0, 0] == 1.0 and torch.isnan(out[1]).all()


def stacked_solve(cones, Qs, As, Gs, jax_solver, torch_solver, rng, tol=1e-9):
    """A stacked KKT solve by the port against jax.vmap of the reference's
    on the same stack."""
    import jax

    B, m, n = As.shape
    p = Gs.shape[1]
    ts, js = ConeSpec(cones), jc.ConeSpec(cones)
    z = np.stack([cone_interior(rng, ts) for _ in range(B)])
    s = np.stack([cone_interior(rng, ts) for _ in range(B)])
    ry, rw, rv = (rng.standard_normal((B, n)), rng.standard_normal((B, p)),
                  rng.standard_normal((B, m)))

    def one(Q, A, G, z, s, ry, rw, rv):
        F = jc.nt_scaling(js, z, s)
        return jax_solver(Q, A, G, js)(F, jc.nt_inv_adjoint(js, F))(ry, rw, rv)

    ref = jax.vmap(one)(*(jnp.asarray(x) for x in (Qs, As, Gs, z, s, ry, rw,
                                                     rv)))
    F = tsc.nt_scaling(ts, t(z), t(s))
    out = torch_solver(t(Qs), t(As), t(Gs), ts)(
        F, tsc.nt_inv_adjoint(ts, F))(t(ry), t(rw), t(rv))
    for a, b in zip(out, ref):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=tol,
                                   atol=tol)
    # and each instance equals its own single solve of the port
    for i in range(B):
        Fi = tsc.nt_scaling(ts, t(z[i]), t(s[i]))
        one_out = torch_solver(t(Qs[i]), t(As[i]), t(Gs[i]), ts)(
            Fi, tsc.nt_inv_adjoint(ts, Fi))(t(ry[i]), t(rw[i]), t(rv[i]))
        for a, b in zip(out, one_out):
            np.testing.assert_allclose(a[i].numpy(), b.numpy(), rtol=1e-10,
                                       atol=1e-10)


@pytest.mark.parametrize("p", [0, 3])
@pytest.mark.parametrize("cones", [[("R", 12)], [("R", 4), ("Q", 5),
                                                 ("S", 3)]])
def test_stacked_schur_matches_vmapped_jax(cones, p, rng):
    Qs, As, Gs = (np.stack(x) for x in zip(*(dense_problem(rng, p)
                                             for _ in range(3))))
    stacked_solve(cones, Qs, As, Gs, jk.kktsolver_schur, kktsolver_schur, rng)


@pytest.mark.parametrize("mode", ["none", "disjoint", "woodbury"])
def test_stacked_diag_matches_vmapped_jax(mode, rng):
    G = g_for(mode, rng)
    Qs, As, Gs = (np.stack(x) for x in zip(*(bound_problem(rng, G)
                                             for _ in range(3))))
    from conicip_tpu_torch.kkt.diag import separable_batch
    from conicip_tpu.kkt.diag import separable_batch as jax_separable_batch

    spec = ConeSpec([("R", 16)])
    assert separable_batch(Qs, As, Gs, spec)
    assert jax_separable_batch(Qs, As, Gs, jc.ConeSpec([("R", 16)]))
    assert separable_batch(t(Qs), t(As), t(G), spec)  # tensors, shared G
    Qbad = Qs.copy()
    Qbad[1, 0, 1] = 0.1
    assert not separable_batch(Qbad, As, Gs, spec)
    assert not separable_batch(Qs[0], As, Gs, spec)  # not a stack
    jax_solver = functools.partial(jk.kktsolver_diag, eq_mode=mode) \
        if mode != "none" else jk.kktsolver_diag
    torch_solver = functools.partial(kktsolver_diag, eq_mode=mode) \
        if mode != "none" else kktsolver_diag
    stacked_solve([("R", 16)], Qs, As, Gs, jax_solver, torch_solver, rng)


def test_stacked_spectral_and_lowrank_match_their_single_solves(rng):
    from conicip_tpu_torch.kkt.lowrank import (lowrank_applicable,
                                               lowrank_kktsolver)
    from conicip_tpu_torch.models import batched_mixed_rq_eq

    cones = [("R", 3), ("Q", 4), ("S", 3)]
    n, B = 10, 3
    Qs = np.stack([q * np.eye(n) for q in (0.5, 1.0, 2.0)])
    As = np.stack([np.eye(n)] * B)
    Gs = np.zeros((B, 0, n))
    assert spectral_applicable(Qs, As, None, ConeSpec(cones))
    assert spectral_applicable(t(Qs), t(As), None, ConeSpec(cones))
    assert not spectral_applicable(Qs, 2 * As, None, ConeSpec(cones))
    stacked_solve(cones, Qs, As, Gs, jax_spectral, kktsolver_spectral, rng)

    Q, c, A, b, cones, G, d = batched_mixed_rq_eq(3, n=12, n_q=5, p=2)
    Gs = np.broadcast_to(G, (3,) + G.shape).copy()
    assert lowrank_applicable(Q, A, G, ConeSpec(cones))
    assert lowrank_applicable(t(Q), t(A), t(G), ConeSpec(cones))
    assert not lowrank_applicable(Q + 0.1, A, G, ConeSpec(cones))
    from conicip_tpu.kkt.lowrank import lowrank_kktsolver as jax_lowrank

    stacked_solve(cones, Q, A, Gs, jax_lowrank(), lowrank_kktsolver(), rng)
