"""The port's qr, lu and lowrank KKT backends against conicip_tpu.kkt.

From the same numpy data on the CPU in f64: one ``solve3x3`` on one NT
scaling must agree with the reference's to 1e-9 relative and solve the 3x3
KKT system; the whole solve with the backend as ``kktsolver=`` must give the
same status and ``Iter`` and y/w/v to 1e-6. The low-rank family's generator
is held draw for draw against the reference's.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import conicip_tpu.cones as jc
import conicip_tpu.kkt as jk
from conicip_tpu.cones import scaling as jsc
from conicip_tpu.kkt.lowrank import lowrank_applicable as jax_applicable
from conicip_tpu.kkt.lowrank import lowrank_kktsolver as jax_lowrank
from conicip_tpu.models.generators import \
    batched_mixed_rq_eq as jax_batched_mixed_rq_eq
from conicip_tpu_torch.cones import scaling as tsc
from conicip_tpu_torch.cones.spec import ConeSpec
from conicip_tpu_torch.kkt import kktsolver_lu, kktsolver_qr
from conicip_tpu_torch.kkt.lowrank import (lowrank_applicable,
                                           lowrank_kktsolver)
from conicip_tpu_torch.models import batched_mixed_rq_eq
from test_torch_cones import cone_interior
from test_torch_ipm import assert_same, both
from test_torch_kkt import t

torch.set_num_threads(1)


def family(n=20, n_q=7, p=3, seed=0):
    Q, c, A, b, cones, G, d = batched_mixed_rq_eq(2, n=n, seed=seed, n_q=n_q,
                                                  p=p)
    return Q[0], c[0], A[0], b[0], cones, G, d[0]


def rank_deficient_q(rng, n=12, p=2):
    # Q of rank 3, positive definite only with the cone rows: the Schur
    # matrix alone would do, but Q + AᵀA is what qr is built for
    h = rng.standard_normal((3, n))
    Q = h.T @ h
    c = rng.standard_normal(n)
    A = np.vstack([np.eye(n), -np.eye(n)])
    b = -np.ones(2 * n)
    G = rng.standard_normal((p, n))
    return Q, c, A, b, [("R", 2 * n)], G, 0.1 * G @ np.ones(n)


BACKENDS = {
    "qr": (kktsolver_qr, jk.kktsolver_qr),
    "lu": (kktsolver_lu, jk.kktsolver_lu),
    "lowrank": (lowrank_kktsolver(), jax_lowrank()),
}


@pytest.mark.parametrize("kw", [dict(batch=2, n=20, seed=0, n_q=7, p=3),
                                dict(batch=3, n=24, seed=1, n_q=9, p=4),
                                dict(batch=1)])
def test_batched_generator_matches_jax_draw_for_draw(kw):
    got, ref = batched_mixed_rq_eq(**kw), jax_batched_mixed_rq_eq(**kw)
    assert got[4] == ref[4]
    for x, y in zip(got[:4] + got[5:], ref[:4] + ref[5:]):
        assert x.shape == y.shape and np.array_equal(x, y)


def test_lowrank_applicable_matches_jax():
    Q, c, A, b, cones, G, d = family()
    spec, js = ConeSpec(cones), jc.ConeSpec(cones)
    A2, Q2 = np.array(A), np.array(Q)
    A2[0, 1] = 0.5  # non-identity R rows
    Q2[0, 1] = 0.1  # non-diagonal Q
    Gdef = np.vstack([G, G[0:1]])  # rank-deficient G
    cases = [(Q, A, G, True), (Q, A, None, True), (Q, A2, G, False),
             (Q2, A, G, False), (Q, A, Gdef, False),
             (-Q, A, G, False)]
    for Qi, Ai, Gi, want in cases:
        assert lowrank_applicable(Qi, Ai, Gi, spec) is want
        assert jax_applicable(Qi, Ai, Gi, js) is want
        assert lowrank_applicable(t(Qi), t(Ai), None if Gi is None else t(Gi),
                                  spec) is want
    assert not lowrank_applicable(Q, A, G, spec, max_rank=9)
    sdp = [("R", 2), ("S", 6)]
    assert not lowrank_applicable(np.eye(8), np.eye(8), None, ConeSpec(sdp))
    assert not jax_applicable(np.eye(8), np.eye(8), None, jc.ConeSpec(sdp))
    assert lowrank_kktsolver() is lowrank_kktsolver()


def one_solve(name, Q, A, G, cones, rng):
    spec, js = ConeSpec(cones), jc.ConeSpec(cones)
    n, m, p = Q.shape[0], A.shape[0], G.shape[0]
    z_v, z_s = cone_interior(rng, spec), cone_interior(rng, spec)
    rhs = (rng.standard_normal(n), rng.standard_normal(p),
           rng.standard_normal(m))
    mine, theirs = BACKENDS[name]
    F = tsc.nt_scaling(spec, t(z_v), t(z_s))
    got = mine(t(Q), t(A), t(G), spec)(F, tsc.nt_inv_adjoint(spec, F))(
        *(t(x) for x in rhs))
    Fj = jsc.nt_scaling(js, jnp.asarray(z_v), jnp.asarray(z_s))
    ref = theirs(jnp.asarray(Q), jnp.asarray(A), jnp.asarray(G), js)(
        Fj, jsc.nt_inv_adjoint(js, Fj))(*(jnp.asarray(x) for x in rhs))
    for u, r in zip(got, ref):
        r = np.asarray(r)
        assert u.dtype == torch.float64 and u.shape == r.shape
        np.testing.assert_allclose(u.numpy(), r, rtol=1e-9,
                                   atol=1e-9 * (1 + np.max(np.abs(r), initial=0)))
    # the 3x3 contract: Qa + Gᵀb − Aᵀc = x ; Ga = y ; Aa + FᵀFc = z
    a, bb, cc = (u.numpy() for u in got)
    np.testing.assert_allclose(Q @ a + G.T @ bb - A.T @ cc, rhs[0], atol=1e-8)
    np.testing.assert_allclose(G @ a, rhs[1], atol=1e-8)
    FtFc = tsc.apply_adjoint(spec, F, tsc.apply(spec, F, got[2])).numpy()
    np.testing.assert_allclose(A @ a + FtFc, rhs[2], atol=1e-7)


@pytest.mark.parametrize("with_g", [True, False])
@pytest.mark.parametrize("name", list(BACKENDS))
def test_one_solve_matches_jax_on_the_lowrank_family(name, with_g, rng):
    Q, c, A, b, cones, G, d = family()
    if not with_g:
        G = np.zeros((0, Q.shape[0]))
    one_solve(name, Q, A, G, cones, rng)


@pytest.mark.parametrize("name", ["qr", "lu"])
def test_one_solve_matches_jax_on_rank_deficient_q(name, rng):
    Q, c, A, b, cones, G, d = rank_deficient_q(rng)
    one_solve(name, Q, A, G, cones, rng)


@pytest.mark.parametrize("name", ["qr", "lu"])
def test_one_solve_matches_jax_on_mixed_cones(name, rng):
    cones = [("R", 3), ("Q", 4), ("S", 6)]
    n = 9
    B = rng.standard_normal((n, n))
    one_solve(name, B @ B.T / n + np.eye(n), rng.standard_normal((13, n)),
              rng.standard_normal((2, n)), cones, rng)


def backend_kw(name):
    mine, theirs = BACKENDS[name]
    return dict(jax_kw=dict(kktsolver=theirs), torch_kw=dict(kktsolver=mine))


@pytest.mark.parametrize("shape", [dict(n=20, n_q=7, p=3, seed=0),
                                   dict(n=24, n_q=9, p=4, seed=1)])
@pytest.mark.parametrize("name", list(BACKENDS))
def test_whole_solve_matches_jax_on_the_lowrank_family(name, shape):
    args = family(**shape)
    ref, sol = both(*args, **backend_kw(name))
    assert ref.status == "Optimal"
    assert_same(ref, sol, 1e-6)
    # ... and the dense default (one corrector more per iteration, so
    # another 1e-6-optimal point) agrees on the optimum to 1e-4
    dense, _ = both(*args)
    np.testing.assert_allclose(sol.y, np.asarray(dense.y), atol=1e-4)


@pytest.mark.parametrize("name", ["qr", "lu"])
def test_whole_solve_matches_jax_on_rank_deficient_q(name, rng):
    ref, sol = both(*rank_deficient_q(rng), **backend_kw(name))
    assert ref.status == "Optimal"
    assert_same(ref, sol, 1e-6)


def test_lu_factor_dtype_and_singular_system(rng):
    Q, c, A, b, cones, G, d = family()
    spec = ConeSpec(cones)
    F = tsc.nt_scaling(spec, t(cone_interior(rng, spec)),
                       t(cone_interior(rng, spec)))
    FinvT = tsc.nt_inv_adjoint(spec, F)
    rhs = (t(rng.standard_normal(20)), t(rng.standard_normal(3)),
           t(rng.standard_normal(27)))
    full = kktsolver_lu(t(Q), t(A), t(G), spec)(F, FinvT)(*rhs)
    low = kktsolver_lu(t(Q), t(A), t(G), spec, factor_dtype=torch.float32)(
        F, FinvT)(*rhs)
    for u, v in zip(full, low):
        assert v.dtype == torch.float64
        np.testing.assert_allclose(v.numpy(), u.numpy(), rtol=1e-3, atol=1e-4)
    # a singular saddle (two equal equality rows) raises nothing: the step
    # comes back non-finite for the IPM's guard
    G2 = np.vstack([G[0], G[0]])
    out = kktsolver_lu(t(Q), t(A), t(G2), spec)(F, FinvT)(
        rhs[0], t(np.array([1.0, 2.0])), rhs[2])
    assert not all(bool(torch.isfinite(u).all()) for u in out) or \
        max(float(u.abs().max()) for u in out) > 1e8
