"""Null-space elimination of equalities in the port
(conicip_tpu_torch.reduce, conic_ip(eliminateEqualities=True)) against
conicip_tpu.

The reduction is defined up to a rotation of the null-space basis Z, so the
bases are compared through ``ZZᵀ`` and the reduced problems through their
optimum; the identities ``GZ = 0`` and ``G y0 = d`` hold to 1e-12. Whole
solves run in both packages on the CPU in f64 from the same numpy data and
must agree in status and ``Iter`` and in y/w/v to 1e-6 (NaN patterns equal
on certificates).
"""

import numpy as np
import pytest
import torch

import conicip_tpu as ct
from conicip_tpu.reduce import eliminate_equalities as jax_eliminate
from conicip_tpu.reduce import equality_basis as jax_basis
import conicip_tpu_torch as pt
from conicip_tpu_torch.models import mixed_rq_eq
from conicip_tpu_torch.reduce import (EqualityBasis, eliminate_equalities,
                                      equality_basis)
from miles import load_miles, mpb_to_conicip
from test_torch_ipm import assert_same, both

torch.set_num_threads(1)


def eq_problem(rng, n=60, p=5):
    B = rng.standard_normal((n, n))
    Q = B.T @ B + np.eye(n)
    c = rng.standard_normal(n)
    G = rng.standard_normal((p, n))
    d = G @ np.abs(rng.standard_normal(n))
    return Q, c, np.eye(n), np.zeros(n), G, d


def test_reduction_matches_jax(rng):
    Q, c, A, b, G, d = eq_problem(rng)
    red = eliminate_equalities(Q, c, A, b, G, d)
    ref = jax_eliminate(Q, c, A, b, G, d)
    assert red.consistent and ref.consistent
    assert np.max(np.abs(G @ red.Z)) < 1e-12
    assert np.max(np.abs(G @ red.y0 - d)) < 1e-12 * (1 + np.linalg.norm(d))
    np.testing.assert_allclose(red.Z.T @ red.Z, np.eye(55), atol=1e-12)
    np.testing.assert_allclose(red.Z @ red.Z.T, ref.Z @ ref.Z.T, atol=1e-10)
    np.testing.assert_allclose(red.y0, ref.y0, atol=1e-10)
    # reduced operands in the full space, where the rotation drops out
    for mine, theirs in ((red.Z @ red.Q @ red.Z.T, ref.Z @ ref.Q @ ref.Z.T),
                         (red.Z @ red.c, ref.Z @ ref.c),
                         (red.A @ red.Z.T, ref.A @ ref.Z.T),
                         (red.b, ref.b)):
        np.testing.assert_allclose(mine, theirs, atol=1e-10)
    # the reduced problems share their optimum
    x = pt.conic_ip(red.Q, red.c, red.A, red.b, [("R", 60)], device="cpu")
    xr = ct.conic_ip(ref.Q, ref.c, ref.A, ref.b, [("R", 60)])
    assert x.status == xr.status == "Optimal" and x.Iter == xr.Iter
    np.testing.assert_allclose(red.recover_y(x.y.numpy()),
                               ref.recover_y(np.asarray(xr.y)), atol=1e-6)
    v = np.abs(rng.standard_normal(60))
    y = red.recover_y(x.y.numpy())
    np.testing.assert_allclose(red.recover_w(y, v), ref.recover_w(y, v),
                               atol=1e-8)
    np.testing.assert_allclose(red.recover_w_cert(v), ref.recover_w_cert(v),
                               atol=1e-8)


def test_equality_basis_matches_jax_and_batches(rng):
    G = rng.standard_normal((4, 12))
    G = np.vstack([G, G[0] + G[1]])  # rank 4 of 5 rows
    eb, ref = equality_basis(G), jax_basis(G)
    assert isinstance(eb, EqualityBasis)
    assert (eb.rank, eb.p, eb.n) == (ref.rank, ref.p, ref.n) == (4, 5, 12)
    np.testing.assert_allclose(eb.Z @ eb.Z.T, ref.Z @ ref.Z.T, atol=1e-10)
    assert equality_basis(np.zeros((0, 12))) is None
    Y = rng.standard_normal((3, 12))
    D = Y @ G.T  # consistent right-hand sides
    y0 = eb.particular(D)
    np.testing.assert_allclose(y0, ref.particular(D), atol=1e-10)
    np.testing.assert_allclose(y0 @ G.T, D, atol=1e-12)
    np.testing.assert_allclose(eb.particular(D[0]), y0[0], atol=1e-12)
    W = rng.standard_normal((3, 5))
    rhs = W @ G
    w = eb.solve_gt(rhs)
    np.testing.assert_allclose(w, ref.solve_gt(rhs), atol=1e-10)
    np.testing.assert_allclose(w @ G, rhs, atol=1e-10)
    np.testing.assert_allclose(eb.solve_gt(rhs[1]), w[1], atol=1e-12)
    # a NaN row gives NaN duals for that row only, and never raises
    rhs[1] = np.nan
    w = eb.solve_gt(rhs)
    assert np.all(np.isnan(w[1, eb.piv[:4]]))
    assert np.all(np.isfinite(w[[0, 2]]))


def instances(rng):
    Q, c, A, b, G, d = eq_problem(rng)
    R60 = [("R", 60)]
    out = {"r_cone_qp": ((Q, c, A, b, R60, G, d), dict(optTol=1e-8))}
    out["mixed_rq_eq"] = (mixed_rq_eq().args(), {})
    out["rank_deficient_G"] = (
        (Q, c, A, b, R60, np.vstack([G, G[0:1]]),
         np.concatenate([d, d[0:1]])), {})
    out["inconsistent_G"] = (
        (Q, c, A, b, R60, np.vstack([G[0], G[0]]), np.array([1.0, 2.0])), {})
    n = 6
    Gfull = rng.standard_normal((n, n))
    y_pin = np.abs(rng.standard_normal(n)) + 0.5
    out["Z_empty"] = ((np.eye(n), rng.standard_normal(n), np.eye(n),
                       np.zeros(n), [("R", n)], Gfull, Gfull @ y_pin), {})
    out["unbounded"] = ((np.zeros((2, 2)), np.array([1.0, 0.0]),
                         np.eye(2)[0:1], np.zeros(1), [("R", 1)],
                         np.array([[0.0, 1.0]]), np.zeros(1)), {})
    # y1 + y2 = -1 with y >= 0: the reduced problem has a Farkas certificate
    out["infeasible"] = ((np.eye(3), np.ones(3), np.eye(3), np.zeros(3),
                          [("R", 3)], np.array([[1.0, 1.0, 0.0]]),
                          np.array([-1.0])), {})
    m = 20
    B = rng.standard_normal((m, m))
    As = np.vstack([np.eye(m), rng.standard_normal((5, m))])
    bs = np.concatenate([-np.ones(m), -10 * np.ones(5)])
    bs[m] = -20.0
    Gs = rng.standard_normal((3, m))
    out["soc_cones"] = ((B.T @ B / m + np.eye(m), rng.standard_normal(m), As,
                         bs, [("R", m), ("Q", 5)], Gs,
                         Gs @ rng.standard_normal(m) * 0.1), {})
    return out


EXPECT = {"r_cone_qp": "Optimal", "mixed_rq_eq": "Optimal",
          "rank_deficient_G": "Optimal", "inconsistent_G": "Infeasible",
          "Z_empty": "Optimal", "unbounded": "Unbounded",
          "infeasible": "Infeasible", "soc_cones": "Optimal"}


@pytest.mark.parametrize("name", list(EXPECT))
def test_eliminated_solve_matches_jax(name, rng):
    args, kw = instances(rng)[name]
    ref, sol = both(*args, eliminateEqualities=True, **kw)
    assert ref.status == EXPECT[name]
    assert_same(ref, sol, kw.get("optTol", 1e-6))
    G, d = args[5], args[6]
    if sol.status == "Optimal":
        assert np.max(np.abs(G @ sol.y - d)) < 1e-9 * (1 + np.linalg.norm(d))
        np.testing.assert_allclose(
            [sol.duFeas, sol.pobj, sol.dobj],
            [ref.duFeas, ref.pobj, ref.dobj], rtol=1e-6, atol=1e-9)
    if name == "inconsistent_G":
        assert sol.Iter == 0 and np.all(np.isnan(sol.v))
    if name == "unbounded":
        assert abs(sol.y[1]) < 1e-8 and np.all(np.isnan(sol.w))
    if name == "infeasible":
        assert np.all(np.isnan(sol.y)) and np.all(np.isfinite(sol.w))


def test_eliminated_warm_start_matches_jax(rng):
    Q, c, A, b, G, d = eq_problem(rng)
    args = (Q, c, A, b, [("R", 60)], G, d)
    first = ct.conic_ip(*args, eliminateEqualities=True)
    shifted = (Q, c + 0.01 * rng.standard_normal(60)) + args[2:]
    warm = (np.asarray(first.y), np.asarray(first.w), np.asarray(first.v))
    ref, sol = both(*shifted, eliminateEqualities=True, warm_start=warm)
    assert_same(ref, sol, 1e-6)
    cold = pt.conic_ip(*shifted, eliminateEqualities=True, device="cpu")
    assert sol.Iter < cold.Iter
    # a warm start of the wrong length is ignored, as in the reference
    ref, sol = both(*shifted, eliminateEqualities=True,
                    warm_start=(np.zeros(3), None, warm[2]))
    assert_same(ref, sol, 1e-6)
    assert sol.Iter == cold.Iter


def test_elimination_is_the_default_only_with_f32_factors(rng, monkeypatch):
    import conicip_tpu_torch.solver as solver

    calls = []
    real = solver._solve_eliminated
    monkeypatch.setattr(solver, "_solve_eliminated",
                        lambda *a, **k: calls.append(1) or real(*a, **k))
    args = eq_problem(rng, n=12, p=2)
    args = args[:4] + ([("R", 12)],) + args[4:]
    pt.conic_ip(*args, device="cpu")
    assert not calls
    pt.conic_ip(*args, device="cpu", factor_dtype=torch.float32)
    assert len(calls) == 1
    pt.conic_ip(*args, device="cpu", factor_dtype=torch.float32,
                kktsolver=pt.kktsolver_schur)
    pt.conic_ip(*args[:5], device="cpu", factor_dtype=torch.float32)
    assert len(calls) == 1


@pytest.mark.parametrize("i, status", [(1, "Optimal"), (2, "Infeasible"),
                                       (3, "Optimal")])
def test_miles_through_the_preprocessor_matches_jax(i, status):
    args = mpb_to_conicip(*load_miles(i))
    ref = ct.preprocess_conic_ip(*args)
    sol = pt.solution_to_numpy(pt.preprocess_conic_ip(*args, device="cpu"))
    assert sol.status == ref.status == status
    assert sol.Iter == ref.Iter
    if status == "Optimal":
        # LPs whose optimum has entries in the hundreds: y is held to 1e-5
        # of its own scale, the residuals to optTol
        scale = 1.0 + np.max(np.abs(ref.y))
        np.testing.assert_allclose(sol.y, np.asarray(ref.y), rtol=0,
                                   atol=1e-5 * scale)
        assert max(sol.prFeas, sol.duFeas, sol.muFeas) < 1e-6
    else:
        assert_same(ref, sol, 1e-6)
