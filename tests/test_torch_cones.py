"""The port's cone layer (conicip_tpu_torch.cones) against conicip_tpu.cones.

Inputs are made with numpy from a seed and fed to both packages on the CPU
in f64. Each operation must agree elementwise at 1e-12 and satisfy the
identities that tests/test_cones.py checks for the JAX package, on R specs,
on the interleaved MIXED spec and on pure Q and pure S specs. Where an S
cone goes through an eigen- or singular-value decomposition the two
packages call different LAPACK builds, which round differently: those
results agree at 1e-10 relative, and the f32 eigenvalues of the λ-frame
max-step at 1e-5.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import conicip_tpu.cones as jc
from conicip_tpu.cones import algebra as jalg
from conicip_tpu.cones import scaling as jsc
from conicip_tpu.cones import segment as jseg
from conicip_tpu.cones import symm as jsymm
from conicip_tpu_torch.cones import algebra as talg
from conicip_tpu_torch.cones import scaling as tsc
from conicip_tpu_torch.cones import segment as tseg
from conicip_tpu_torch.cones import symm as tsymm
from conicip_tpu_torch.cones.spec import ConeSpec, tri_dim, tri_indices, tri_order

torch.set_num_threads(1)

SPECS = [
    [("R", 7)],
    [("R", 3), ("R", 4)],
    [("R", 0)],
]
# interleaved orders: every group is several runs
MIXED = [("R", 4), ("Q", 3), ("Q", 5), ("Q", 3), ("S", tri_dim(3)), ("R", 2)]
TOL = dict(rtol=1e-12, atol=1e-12)


def t(x):
    return torch.from_numpy(np.asarray(x, dtype=np.float64).copy())


def j(x):
    return jnp.asarray(np.asarray(x, dtype=np.float64))


def interior(rng, m):
    return rng.uniform(0.5, 2.0, size=m)


@pytest.mark.parametrize("dims", SPECS + [MIXED, [("S", 6), ("Q", 1)]])
def test_spec_matches_jax(dims):
    ts, js = ConeSpec(dims), jc.ConeSpec(dims)
    assert (ts.m, ts.conedim, ts.nr, ts.only_r) == (js.m, js.conedim, js.nr,
                                                      js.only_r)
    np.testing.assert_array_equal(ts.r_idx, js.r_idx)
    assert ts.r_runs == js.r_runs
    np.testing.assert_array_equal(ts.identity, js.identity)
    # the reference's ``contig`` (start of a single run, else None) from runs
    def contig(g):
        return g.runs[0][0] if len(g.runs) == 1 else None

    assert [(g.dim, contig(g)) for g in ts.soc_groups] == [
        (g.dim, g.contig) for g in js.soc_groups]
    assert [(g.order, contig(g)) for g in ts.sdp_groups] == [
        (g.order, g.contig) for g in js.sdp_groups]
    for a, b in zip(ts.soc_groups + ts.sdp_groups,
                    js.soc_groups + js.sdp_groups):
        np.testing.assert_array_equal(a.idx, b.idx)
    assert ts == ConeSpec(dims) and hash(ts) == hash(ConeSpec(dims))


def test_tri_helpers_match_jax():
    from conicip_tpu.cones.spec import tri_indices as jtri

    for d in (1, 2, 5):
        assert tri_order(tri_dim(d)) == d
        for a, b in zip(tri_indices(d), jtri(d)):
            np.testing.assert_array_equal(a, b)
    with pytest.raises(ValueError):
        tri_order(5)
    with pytest.raises(ValueError):
        ConeSpec([("X", 3)])
    with pytest.raises(ValueError):
        ConeSpec([("R", -1)])


def test_segment_runs_match_jax(rng):
    spec_dims = [("R", 3), ("Q", 3), ("R", 2), ("S", 3), ("R", 1)]
    ts, js = ConeSpec(spec_dims), jc.ConeSpec(spec_dims)
    assert len(ts.r_runs) == 3
    x = rng.standard_normal(ts.m)
    X = rng.standard_normal((ts.m, 4))
    val = rng.standard_normal(ts.nr)
    VAL = rng.standard_normal((ts.nr, 4))
    np.testing.assert_array_equal(tseg.take_r(ts, t(x)).numpy(),
                                  np.asarray(jseg.take_r(js, j(x))))
    np.testing.assert_array_equal(tseg.take_rows_r(ts, t(X)).numpy(),
                                  np.asarray(jseg.take_rows_r(js, j(X))))
    np.testing.assert_array_equal(
        tseg.put_r(ts, t(x), t(val)).numpy(),
        np.asarray(jseg.put_r(js, j(x), j(val))))
    np.testing.assert_array_equal(
        tseg.put_rows_r(ts, t(X), t(VAL)).numpy(),
        np.asarray(jseg.put_rows_r(js, j(X), j(VAL))))


@pytest.mark.parametrize("dims", SPECS[:2])
def test_scaling_matches_jax(dims, rng):
    ts, js = ConeSpec(dims), jc.ConeSpec(dims)
    z, s = interior(rng, ts.m), interior(rng, ts.m)
    x = rng.standard_normal(ts.m)
    X = rng.standard_normal((ts.m, 5))
    F, Fj = tsc.nt_scaling(ts, t(z), t(s)), jsc.nt_scaling(js, j(z), j(s))
    FiT, FiTj = tsc.nt_inv_adjoint(ts, F), jsc.nt_inv_adjoint(js, Fj)
    assert F.soc == () and F.sdp == ()
    np.testing.assert_allclose(F.r_d.numpy(), np.asarray(Fj.r_d), **TOL)
    np.testing.assert_allclose(FiT.r_d.numpy(), np.asarray(FiTj.r_d), **TOL)
    for name in ("apply", "apply_adjoint"):
        for G, Gj in ((F, Fj), (FiT, FiTj)):
            np.testing.assert_allclose(
                getattr(tsc, name)(ts, G, t(x)).numpy(),
                np.asarray(getattr(jsc, name)(js, Gj, j(x))), **TOL)
    for name in ("apply_mat", "apply_adjoint_mat"):
        np.testing.assert_allclose(
            getattr(tsc, name)(ts, F, t(X)).numpy(),
            np.asarray(getattr(jsc, name)(js, Fj, j(X))), **TOL)
    # defining property F z = F⁻ᵀ s = λ, λ interior
    lam1 = tsc.apply(ts, F, t(z))
    np.testing.assert_allclose(lam1.numpy(), tsc.apply(ts, FiT, t(s)).numpy(),
                               atol=1e-12)
    assert float(talg.maxstep_to_cone(ts, lam1)) == 0.0
    # F⁻ᵀ is the inverse transpose; apply_mat is the columnwise apply
    Fd = np.diag(F.r_d.numpy())
    np.testing.assert_allclose(np.diag(FiT.r_d.numpy()), np.linalg.inv(Fd).T,
                               atol=1e-12)
    np.testing.assert_allclose(tsc.apply_mat(ts, F, t(X)).numpy(), Fd @ X,
                               atol=1e-12)
    F32 = tsc.cast(F, torch.float32)
    assert F32.r_d.dtype == torch.float32


def test_identity_scaling(rng):
    ts = ConeSpec([("R", 6)])
    F = tsc.nt_identity(ts, torch.float64, "cpu")
    x = t(rng.standard_normal(6))
    assert F.r_d.dtype == torch.float64
    np.testing.assert_array_equal(tsc.apply(ts, F, x).numpy(), x.numpy())
    np.testing.assert_array_equal(
        np.asarray(jsc.nt_identity(jc.ConeSpec([("R", 6)])).r_d), F.r_d.numpy())


@pytest.mark.parametrize("dims", SPECS[:2])
def test_algebra_matches_jax(dims, rng):
    ts, js = ConeSpec(dims), jc.ConeSpec(dims)
    x, y = interior(rng, ts.m), interior(rng, ts.m)
    d = rng.standard_normal(ts.m)
    for name in ("cone_prod", "cone_div"):
        np.testing.assert_allclose(
            getattr(talg, name)(ts, t(x), t(y)).numpy(),
            np.asarray(getattr(jalg, name)(js, j(x), j(y))), **TOL)
    assert float(talg.maxstep(ts, t(x), t(d))) == pytest.approx(
        float(jalg.maxstep(js, j(x), j(d))), rel=1e-12)
    for v in (x, d):
        assert float(talg.maxstep_to_cone(ts, t(v))) == pytest.approx(
            float(jalg.maxstep_to_cone(js, j(v))), rel=1e-12)
    w = rng.uniform(0.0, 3.0, ts.m)
    np.testing.assert_allclose(
        talg.centrality_correction(ts, t(w), 0.5, 1.5).numpy(),
        np.asarray(jalg.centrality_correction(js, j(w), 0.5, 1.5)), **TOL)
    # prod/div round trip and the identity element
    p = talg.cone_prod(ts, t(x), t(y))
    np.testing.assert_allclose(talg.cone_div(ts, p, t(y)).numpy(), x,
                               atol=1e-12)
    e = torch.from_numpy(ts.identity.copy())
    np.testing.assert_allclose(talg.cone_prod(ts, e, t(x)).numpy(), x,
                               atol=1e-12)


def test_maxstep_r():
    ts = ConeSpec([("R", 3)])
    x = t([1.0, 2.0, 3.0])
    d = t([0.5, -1.0, 3.0])
    assert float(talg.maxstep(ts, x, d)) == pytest.approx(1.0)
    assert float(talg.maxstep(ts, x, -d - 1.0)) == np.inf
    assert float(talg.maxstep(ConeSpec([("R", 0)]), x[:0], d[:0])) == np.inf


def test_maxstep_boundary_consistency(rng):
    ts = ConeSpec([("R", 5)])
    x = interior(rng, 5)
    d = rng.standard_normal(5)
    d[0] = abs(d[0]) + 0.1  # at least one blocking coordinate
    a = float(talg.maxstep(ts, t(x), t(d)))
    xb = x - (a * (1 - 1e-9)) * d
    assert float(talg.maxstep_to_cone(ts, t(xb))) == 0.0
    xa = x - (a * (1 + 1e-6)) * d
    assert float(talg.maxstep_to_cone(ts, t(xa))) < 0.0




CONIC = [MIXED, [("Q", 4), ("Q", 2), ("Q", 4)],
         [("S", tri_dim(2)), ("S", tri_dim(4)), ("S", tri_dim(2))]]
DECOMP = dict(rtol=1e-10, atol=1e-12)


def cone_interior(rng, spec):
    """A strictly interior point of every cone block."""
    x = np.zeros(spec.m)
    x[spec.r_idx] = rng.uniform(0.5, 2.0, spec.nr)
    for g in spec.soc_groups:
        tail = 0.3 * rng.standard_normal((g.count, g.dim - 1))
        head = np.linalg.norm(tail, axis=1) + rng.uniform(0.5, 1.5, g.count)
        x[g.idx] = np.concatenate([head[:, None], tail], axis=1)
    for g in spec.sdp_groups:
        d = g.order
        B = rng.standard_normal((g.count, d, d))
        rows, cols, scale = tri_indices(d)
        x[g.idx] = (B @ B.transpose(0, 2, 1) / d + np.eye(d))[:, rows, cols] * scale
    return x


def sym(rng, *shape):
    B = rng.standard_normal(shape)
    return B + np.swapaxes(B, -1, -2)


@pytest.mark.parametrize("d", [1, 3, 5])
def test_symm_matches_jax(d, rng):
    X, Y = sym(rng, 2, 3, d, d), sym(rng, 2, 3, d, d)
    vx = tsymm.vecm(t(X))
    np.testing.assert_allclose(vx.numpy(), np.asarray(jsymm.vecm(j(X))), **TOL)
    np.testing.assert_allclose(tsymm.mat(vx).numpy(), X, **TOL)
    x = rng.standard_normal((4, tri_dim(d)))
    np.testing.assert_allclose(tsymm.mat(t(x)).numpy(),
                               np.asarray(jsymm.mat(j(x))), **TOL)
    # vecm(X)·vecm(Y) = tr(XY)
    np.testing.assert_allclose(
        torch.sum(vx * tsymm.vecm(t(Y)), dim=-1).numpy(),
        np.trace(X @ Y, axis1=-2, axis2=-1), rtol=1e-12)


def test_symm_single_aliases_match_jax(rng):
    # the reference's unbatched names: exported, the same functions, and
    # equal to the reference's on one matrix
    for name in ("vecm_single", "mat_single"):
        assert name in tsymm.__all__ and name in jsymm.__all__
    assert tsymm.vecm_single is tsymm.vecm and tsymm.mat_single is tsymm.mat
    X = sym(rng, 4, 4)
    vx = tsymm.vecm_single(t(X))
    np.testing.assert_allclose(vx.numpy(),
                               np.asarray(jsymm.vecm_single(j(X))), **TOL)
    np.testing.assert_allclose(tsymm.mat_single(vx).numpy(),
                               np.asarray(jsymm.mat_single(j(vx.numpy()))),
                               **TOL)


@pytest.mark.parametrize("dims", CONIC)
def test_group_segments_match_jax(dims, rng):
    ts, js = ConeSpec(dims), jc.ConeSpec(dims)
    x = rng.standard_normal(ts.m)
    X = rng.standard_normal((ts.m, 3))
    for g, gj in zip(ts.soc_groups + ts.sdp_groups,
                     js.soc_groups + js.sdp_groups):
        np.testing.assert_array_equal(tseg.take_group(g, t(x)).numpy(),
                                      np.asarray(jseg.take_group(gj, j(x))))
        np.testing.assert_array_equal(
            tseg.take_rows_group(g, t(X)).numpy(),
            np.asarray(jseg.take_rows_group(gj, j(X))))
        val = rng.standard_normal(gj.idx.shape)
        VAL = rng.standard_normal(gj.idx.shape + (3,))
        np.testing.assert_array_equal(
            tseg.put_group(g, t(x), t(val)).numpy(),
            np.asarray(jseg.put_group(gj, j(x), j(val))))
        np.testing.assert_array_equal(
            tseg.put_rows_group(g, t(X), t(VAL)).numpy(),
            np.asarray(jseg.put_rows_group(gj, j(X), j(VAL))))


@pytest.mark.parametrize("dims", CONIC)
def test_conic_algebra_matches_jax(dims, rng):
    ts, js = ConeSpec(dims), jc.ConeSpec(dims)
    x, y = cone_interior(rng, ts), cone_interior(rng, ts)
    d = rng.standard_normal(ts.m)
    p = talg.cone_prod(ts, t(x), t(y))
    np.testing.assert_allclose(p.numpy(), np.asarray(jalg.cone_prod(js, j(x), j(y))),
                               **TOL)
    np.testing.assert_allclose(talg.cone_div(ts, t(x), t(y)).numpy(),
                               np.asarray(jalg.cone_div(js, j(x), j(y))), **DECOMP)
    # round trip y ∘ (p ÷ y) = p ÷ y ∘ y = x, and the identity element
    np.testing.assert_allclose(talg.cone_div(ts, p, t(y)).numpy(), x, atol=1e-10)
    # e ∘ x = x on R and Q; the S product XY + YX gives 2x there
    e = torch.from_numpy(ts.identity.copy())
    ex = x.copy()
    for g in ts.sdp_groups:
        ex[g.idx] *= 2.0
    np.testing.assert_allclose(talg.cone_prod(ts, e, t(x)).numpy(), ex, **TOL)
    for v in (x, d):
        assert float(talg.maxstep(ts, t(x), t(v))) == pytest.approx(
            float(jalg.maxstep(js, j(x), j(v))), rel=1e-10)
        assert float(talg.maxstep_to_cone(ts, t(v))) == pytest.approx(
            float(jalg.maxstep_to_cone(js, j(v))), rel=1e-10)
    assert float(talg.maxstep_to_cone(ts, t(x))) == 0.0
    w = talg.cone_prod(ts, t(x), t(d))
    np.testing.assert_allclose(
        talg.centrality_correction(ts, w, 0.5, 1.5).numpy(),
        np.asarray(jalg.centrality_correction(js, j(w.numpy()), 0.5, 1.5)),
        **DECOMP)


def test_maxstep_lands_on_the_boundary(rng):
    ts = ConeSpec(MIXED)
    x = cone_interior(rng, ts)
    d = rng.standard_normal(ts.m)
    a = float(talg.maxstep(ts, t(x), t(d)))
    assert 0 < a < np.inf
    assert float(talg.maxstep_to_cone(ts, t(x - a * (1 - 1e-9) * d))) == 0.0
    assert float(talg.maxstep_to_cone(ts, t(x - a * (1 + 1e-6) * d))) < 0.0


def test_lyap_solve_matches_jax(rng):
    k, d = 3, 4
    B = rng.standard_normal((k, d, d))
    Y = B @ B.transpose(0, 2, 1) + np.eye(d)
    X = sym(rng, k, d, d)
    O = talg.lyap_solve(t(Y), t(X)).numpy()
    np.testing.assert_allclose(O, np.asarray(jalg.lyap_solve(j(Y), j(X))),
                               **DECOMP)
    np.testing.assert_allclose(Y @ O + O @ Y, X, atol=1e-12)
    # the diagonal case (U = None) of the λ-frame, and given factors
    w = rng.uniform(0.5, 2.0, (k, d))
    Od = talg.lyap_solve(None, t(X), y_eig=(t(w), None)).numpy()
    np.testing.assert_allclose(
        Od, np.asarray(jalg.lyap_solve(None, j(X), y_eig=(j(w), None))), **TOL)
    D = np.apply_along_axis(np.diag, -1, w)
    np.testing.assert_allclose(D @ Od + Od @ D, X, atol=1e-12)
    wY, UY = np.linalg.eigh(Y)
    np.testing.assert_allclose(talg.lyap_solve(None, t(X), y_eig=(t(wY), t(UY))).numpy(),
                               O, atol=1e-10)


@pytest.mark.parametrize("dims", CONIC)
def test_conic_scaling_matches_jax(dims, rng):
    ts, js = ConeSpec(dims), jc.ConeSpec(dims)
    z, s = cone_interior(rng, ts), cone_interior(rng, ts)
    F, Fj = tsc.nt_scaling(ts, t(z), t(s)), jsc.nt_scaling(js, j(z), j(s))
    FiT, FiTj = tsc.nt_inv_adjoint(ts, F), jsc.nt_inv_adjoint(js, Fj)
    np.testing.assert_allclose(F.r_d.numpy(), np.asarray(Fj.r_d), **TOL)
    for G, Gj in ((F, Fj), (FiT, FiTj)):
        for a, b in zip(G.soc, Gj.soc):
            for f in ("d", "u", "alpha"):
                np.testing.assert_allclose(getattr(a, f).numpy(),
                                           np.asarray(getattr(b, f)), **TOL)
        for a, b in zip(G.sdp, Gj.sdp):
            # S is fixed up to the signs of the singular vectors; the scaled
            # point's spectrum and P = S Sᵀ are not
            np.testing.assert_allclose(a.lam.numpy(), np.asarray(b.lam), **DECOMP)
            P, Pj = a.S @ a.S.mT, np.asarray(b.S @ jnp.swapaxes(b.S, -1, -2))
            np.testing.assert_allclose(P.numpy(), Pj, **DECOMP)
            np.testing.assert_allclose((a.S @ a.Sinv).numpy(),
                                       np.broadcast_to(np.eye(a.S.shape[-1]),
                                                       a.S.shape), atol=1e-12)
    np.testing.assert_allclose(tsc.dense_gram(ts, F).numpy(),
                               np.asarray(jsc.dense_gram(js, Fj)), **DECOMP)
    F32 = tsc.cast(F, torch.float32)
    assert all(f.dtype == torch.float32 for blk in F32.soc + F32.sdp
               for f in vars(blk).values())


@pytest.mark.parametrize("dims", CONIC)
def test_nt_property_and_applies(dims, rng):
    ts = ConeSpec(dims)
    z, s = cone_interior(rng, ts), cone_interior(rng, ts)
    x, y = rng.standard_normal(ts.m), rng.standard_normal(ts.m)
    F = tsc.nt_scaling(ts, t(z), t(s))
    FiT = tsc.nt_inv_adjoint(ts, F)
    # F z = F⁻ᵀ s = λ, λ interior, and mat(λ) = diag(lam) on S blocks
    lam = tsc.apply(ts, F, t(z))
    np.testing.assert_allclose(lam.numpy(), tsc.apply(ts, FiT, t(s)).numpy(),
                               atol=1e-12)
    assert float(talg.maxstep_to_cone(ts, lam)) == 0.0
    for g, sd in zip(ts.sdp_groups, F.sdp):
        np.testing.assert_allclose(
            tsymm.mat(tseg.take_group(g, lam)).numpy(),
            torch.diag_embed(sd.lam).numpy(), atol=1e-12)
    # the adjoint, and F⁻ᵀ as the inverse transpose
    Fx = tsc.apply(ts, F, t(x))
    np.testing.assert_allclose(float(Fx @ t(y)),
                               float(t(x) @ tsc.apply_adjoint(ts, F, t(y))),
                               rtol=1e-12)
    np.testing.assert_allclose(tsc.apply_adjoint(ts, FiT, Fx).numpy(), x,
                               atol=1e-12)
    # apply_mat is the columnwise apply; FᵀF column by column is dense_gram
    X = rng.standard_normal((ts.m, 5))
    for mat_fn, vec_fn in ((tsc.apply_mat, tsc.apply),
                           (tsc.apply_adjoint_mat, tsc.apply_adjoint)):
        cols = torch.stack([vec_fn(ts, F, t(X[:, i])) for i in range(5)], 1)
        np.testing.assert_allclose(mat_fn(ts, F, t(X)).numpy(), cols.numpy(),
                                   atol=1e-12)
    I = torch.eye(ts.m, dtype=torch.float64)
    FtF = tsc.apply_adjoint_mat(ts, F, tsc.apply_mat(ts, F, I))
    np.testing.assert_allclose(tsc.dense_gram(ts, F).numpy(), FtF.numpy(),
                               rtol=1e-12, atol=1e-12)


@pytest.mark.parametrize("dims", CONIC)
def test_dense_is_the_operator_itself(dims, rng):
    """``dense(F)`` is F as a matrix: its columns are ``apply`` on the unit
    vectors, its Gram matrix is ``dense_gram``, and on R and Q blocks
    (whose scaling has no rotation freedom) it equals the reference's."""
    ts, js = ConeSpec(dims), jc.ConeSpec(dims)
    z, s = cone_interior(rng, ts), cone_interior(rng, ts)
    F = tsc.nt_scaling(ts, t(z), t(s))
    D = tsc.dense(ts, F)
    I = torch.eye(ts.m, dtype=torch.float64)
    np.testing.assert_allclose(D.numpy(), tsc.apply_mat(ts, F, I).numpy(),
                               atol=1e-12)
    np.testing.assert_allclose((D.T @ D).numpy(),
                               tsc.dense_gram(ts, F).numpy(), rtol=1e-12,
                               atol=1e-12)
    assert tsc.dense(ts, F, torch.float32).dtype == torch.float32
    Dj = np.asarray(jsc.dense(js, jsc.nt_scaling(js, j(z), j(s))))
    rq = np.concatenate([ts.r_idx] + [g.idx.ravel() for g in ts.soc_groups])
    rq = rq.astype(int)
    np.testing.assert_allclose(D.numpy()[np.ix_(rq, rq)], Dj[np.ix_(rq, rq)],
                               **TOL)
    # S blocks: compared through FᵀF, which the rotation leaves alone
    np.testing.assert_allclose((D.T @ D).numpy(), Dj.T @ Dj, **DECOMP)


@pytest.mark.parametrize("dims", CONIC)
def test_maxstep_multi_matches_jax_and_the_direct_frame(dims, rng):
    ts, js = ConeSpec(dims), jc.ConeSpec(dims)
    z, s = cone_interior(rng, ts), cone_interior(rng, ts)
    dv, ds = rng.standard_normal(ts.m), rng.standard_normal(ts.m)
    F = tsc.nt_scaling(ts, t(z), t(s))
    FiT = tsc.nt_inv_adjoint(ts, F)
    lam = tsc.apply(ts, F, t(z))
    Fdv, FiTds = tsc.apply(ts, F, t(dv)), tsc.apply(ts, FiT, t(ds))
    eigs = tuple((sd.lam, None) for sd in F.sdp)
    got = talg.maxstep_multi(ts, lam, (Fdv, FiTds), x_eigs=eigs)
    # congruence invariance: maxstep(z, dv) = maxstep(λ, F dv), and
    # maxstep(s, ds) = maxstep(λ, F⁻ᵀ ds)
    direct = (talg.maxstep(ts, t(z), t(dv)), talg.maxstep(ts, t(s), t(ds)))
    ref = jalg.maxstep_multi(
        js, j(lam.numpy()), (j(Fdv.numpy()), j(FiTds.numpy())),
        x_eigs=tuple((j(sd.lam.numpy()), None) for sd in F.sdp))
    ref_full = jalg.maxstep_multi(js, j(z), (j(dv),))
    for a, b, c in zip(got, direct, ref):
        assert float(a) == pytest.approx(float(b), rel=1e-5)
        assert float(a) == pytest.approx(float(c), rel=1e-5)
    assert float(talg.maxstep_multi(ts, t(z), (t(dv),))[0]) == pytest.approx(
        float(ref_full[0]), rel=1e-5)
    if not ts.sdp_groups:  # no f32 eigenvalues: exact
        assert [float(a) for a in got] == pytest.approx(
            [float(b) for b in direct], rel=1e-12)
    eig_t = talg.sdp_eighs(ts, t(z))
    eig_j = jalg.sdp_eighs(js, j(z))
    for (w, _), (wj, _) in zip(eig_t, eig_j):
        np.testing.assert_allclose(w.numpy(), np.asarray(wj), **DECOMP)


def test_bad_points_give_nan_not_exceptions(rng):
    # an indefinite mat(z): NaN factors for that cone, finite elsewhere
    ts = ConeSpec([("S", tri_dim(3)), ("S", tri_dim(3)), ("Q", 3)])
    z, s = cone_interior(rng, ts), cone_interior(rng, ts)
    z[0] = -5.0  # first S cone: a negative diagonal entry
    F = tsc.nt_scaling(ts, t(z), t(s))
    sd = F.sdp[0]
    for f in (sd.S, sd.Sinv, sd.lam):
        assert torch.isnan(f[0]).all() and torch.isfinite(f[1]).all()
    assert torch.isfinite(F.soc[0].u).all()
    # non-finite input reaches every decomposition without raising
    x = t(z)
    x[1] = float("nan")  # first S cone
    x[13] = float("inf")  # the Q cone
    assert torch.isnan(talg.maxstep_to_cone(ts, x))
    assert torch.isnan(talg.cone_div(ts, t(s), x)[:6]).all()
    assert torch.isnan(talg.centrality_correction(ts, x, 0.1, 1.0)[:6]).all()
    w, U = talg.sdp_eighs(ts, x)[0]
    assert torch.isnan(w[0]).all() and torch.isfinite(w[1]).all()
    # as in the reference, a cone whose mat(x) is not PD (NaN included)
    # allows any step, and a non-finite Q cone makes the step NaN
    js = jc.ConeSpec(ts.cone_dims)
    x_s_only = t(z)
    x_s_only[1] = float("nan")
    for xx in (x, x_s_only):
        for a, b in ((talg.maxstep(ts, xx, t(s)),
                      jalg.maxstep(js, j(xx), j(s))),
                     (talg.maxstep_multi(ts, xx, (t(s),))[0],
                      jalg.maxstep_multi(js, j(xx), (j(s),))[0])):
            assert float(a) == pytest.approx(float(b), rel=1e-12, nan_ok=True)
    assert np.isfinite(float(talg.maxstep(ts, x_s_only, t(s))))


# ── stacks of instances: every function against a loop over instances ──

STACK = 3


def stack_of(fn, *xs):
    """fn through the JAX package, instance by instance, stacked."""
    return np.stack([np.asarray(fn(*(j(x[i]) for x in xs)))
                     for i in range(STACK)])


@pytest.mark.parametrize("dims", CONIC + [SPECS[1]])
def test_stacked_algebra_matches_jax_per_instance(dims, rng):
    ts, js = ConeSpec(dims), jc.ConeSpec(dims)
    x = np.stack([cone_interior(rng, ts) for _ in range(STACK)])
    y = np.stack([cone_interior(rng, ts) for _ in range(STACK)])
    d = rng.standard_normal((STACK, ts.m))
    tx, ty, td = t(x), t(y), t(d)
    cases = [
        (talg.cone_prod(ts, tx, ty), lambda a, b: jalg.cone_prod(js, a, b),
         (x, y)),
        (talg.cone_div(ts, tx, ty), lambda a, b: jalg.cone_div(js, a, b),
         (x, y)),
        (talg.maxstep(ts, tx, td), lambda a, b: jalg.maxstep(js, a, b),
         (x, d)),
        (talg.maxstep_to_cone(ts, td), lambda a: jalg.maxstep_to_cone(js, a),
         (d,)),
    ]
    for got, fn, xs in cases:
        np.testing.assert_allclose(got.numpy(), stack_of(fn, *xs), **DECOMP)
    # a step length is one value per instance, and the single call's
    for i in range(STACK):
        assert torch.equal(talg.maxstep(ts, tx, td)[i],
                           talg.maxstep(ts, tx[i], td[i]))
    both_steps = talg.maxstep_multi(ts, tx, (td, -td))
    assert both_steps[0].shape == (STACK,)
    # the stacked eigenvalue call of maxstep_multi runs in f32
    np.testing.assert_allclose(both_steps[0].numpy(),
                               talg.maxstep(ts, tx, td).numpy(), rtol=1e-4)
    lo, hi = t(rng.uniform(0.1, 0.2, STACK)), t(rng.uniform(2.0, 3.0, STACK))
    q = talg.centrality_correction(ts, tx, lo, hi)
    for i in range(STACK):
        np.testing.assert_allclose(
            q[i].numpy(),
            np.asarray(jalg.centrality_correction(js, j(x[i]), float(lo[i]),
                                                  float(hi[i]))), **DECOMP)


@pytest.mark.parametrize("dims", CONIC)
def test_stacked_scaling_matches_jax_per_instance(dims, rng):
    ts, js = ConeSpec(dims), jc.ConeSpec(dims)
    z = np.stack([cone_interior(rng, ts) for _ in range(STACK)])
    s = np.stack([cone_interior(rng, ts) for _ in range(STACK)])
    x = rng.standard_normal((STACK, ts.m))
    A = rng.standard_normal((STACK, ts.m, 4))
    F = tsc.nt_scaling(ts, t(z), t(s))
    Fi = tsc.nt_inv_adjoint(ts, F)

    def via_jax(i):
        Fj = jsc.nt_scaling(js, j(z[i]), j(s[i]))
        Fij = jsc.nt_inv_adjoint(js, Fj)
        return (jsc.apply(js, Fj, j(x[i])), jsc.apply_adjoint(js, Fij, j(x[i])),
                jsc.apply_mat(js, Fij, j(A[i])), jsc.dense_gram(js, Fj))

    ref = [np.stack([np.asarray(via_jax(i)[k]) for i in range(STACK)])
           for k in range(4)]
    got = (tsc.apply(ts, F, t(x)), tsc.apply_adjoint(ts, Fi, t(x)),
           tsc.apply_mat(ts, Fi, t(A)), tsc.dense_gram(ts, F))
    # the S-cone factors differ by SVD signs; FᵀF, F x on the NT pair and
    # F⁻ᵀ through FᵀF do not. Compare what is sign-free.
    np.testing.assert_allclose(got[3].numpy(), ref[3], rtol=1e-9, atol=1e-10)
    lam = tsc.apply(ts, F, t(z))
    np.testing.assert_allclose(lam.numpy(),
                               tsc.apply(ts, Fi, t(s)).numpy(), **DECOMP)
    if not ts.sdp_groups:
        for g, r in zip(got[:3], ref[:3]):
            np.testing.assert_allclose(g.numpy(), r, **DECOMP)
    # FᵀF x two ways: through the stacked dense Gram and the structured applies
    FtFx = tsc.apply_adjoint(ts, F, tsc.apply(ts, F, t(x)))
    np.testing.assert_allclose(
        FtFx.numpy(), (got[3] @ t(x)[..., None])[..., 0].numpy(), **DECOMP)
    # the identity scaling with a batch shape applies as the identity
    I = tsc.nt_identity(ts, batch_shape=(STACK,))
    np.testing.assert_allclose(tsc.apply(ts, I, t(x)).numpy(), x, rtol=1e-15,
                               atol=1e-15)
    np.testing.assert_allclose(tsc.dense(ts, I).numpy(),
                               np.broadcast_to(np.eye(ts.m),
                                               (STACK, ts.m, ts.m)))


def test_a_nan_instance_does_not_reach_its_neighbours(rng):
    ts = ConeSpec(MIXED)
    x = np.stack([cone_interior(rng, ts) for _ in range(STACK)])
    s = np.stack([cone_interior(rng, ts) for _ in range(STACK)])
    d = rng.standard_normal((STACK, ts.m))
    bad = x.copy()
    bad[1] = np.nan
    for fn in (lambda a: talg.maxstep(ts, a, t(d)),
               lambda a: talg.maxstep_to_cone(ts, a),
               lambda a: talg.cone_div(ts, t(d), a),
               lambda a: tsc.apply(ts, tsc.nt_scaling(ts, a, t(s)), t(d))):
        good, hurt = fn(t(x)), fn(t(bad))
        assert torch.equal(hurt[[0, 2]], good[[0, 2]])
        assert not bool(torch.isfinite(hurt[1]).all())


def test_a_decomposition_the_library_gives_up_on_stays_in_its_entry(
        rng, monkeypatch):
    # torch.linalg raises for the whole stack when one entry does not
    # converge; the wrappers isolate that entry by halving and NaN-fill it,
    # as the reference's decompositions return NaN for such an entry
    from conicip_tpu_torch.ops import batched

    A = sym(rng, 2, 3, 4, 4).astype(np.float32)
    poison = torch.from_numpy(A[1, 2].copy())
    real = torch.linalg.eigvalsh
    calls = []

    def flaky(X):
        calls.append((tuple(X.shape), X.dtype))
        if bool((X == poison).all(-1).all(-1).any()):
            raise torch.linalg.LinAlgError("linalg.eigh: (Batch element 5)")
        return real(X)

    monkeypatch.setattr(torch.linalg, "eigvalsh", flaky)
    w = batched.safe_eigvalsh(torch.from_numpy(A))
    assert torch.isnan(w[1, 2]).all()
    keep = np.ones((2, 3), bool)
    keep[1, 2] = False
    np.testing.assert_allclose(w.numpy()[keep], np.linalg.eigvalsh(A)[keep],
                               rtol=1e-5, atol=1e-5)
    # halved down to the entry alone, and never in another precision
    assert ((1, 4, 4), torch.float32) in calls
    assert {dt for _, dt in calls} == {torch.float32}
