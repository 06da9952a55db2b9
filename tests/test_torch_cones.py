"""The port's cone layer (conicip_tpu_torch.cones) against conicip_tpu.cones.

Inputs are made with numpy from a seed and fed to both packages on the CPU
in f64. Each R-cone operation must agree elementwise at 1e-12 and satisfy
the identities that tests/test_cones.py checks for the JAX package.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import conicip_tpu.cones as jc
from conicip_tpu.cones import algebra as jalg
from conicip_tpu.cones import scaling as jsc
from conicip_tpu.cones import segment as jseg
from conicip_tpu_torch.cones import algebra as talg
from conicip_tpu_torch.cones import scaling as tsc
from conicip_tpu_torch.cones import segment as tseg
from conicip_tpu_torch.cones.spec import ConeSpec, tri_dim, tri_indices, tri_order

torch.set_num_threads(1)

SPECS = [
    [("R", 7)],
    [("R", 3), ("R", 4)],
    [("R", 0)],
]
# parsed only: the port computes on R cones
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
    assert [(g.dim, g.contig) for g in ts.soc_groups] == [
        (g.dim, g.contig) for g in js.soc_groups]
    assert [(g.order, g.contig) for g in ts.sdp_groups] == [
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


def test_q_and_s_cones_are_rejected():
    spec = ConeSpec(MIXED)
    x = torch.ones(spec.m, dtype=torch.float64)
    with pytest.raises(NotImplementedError):
        tsc.nt_scaling(spec, x, x)
    with pytest.raises(NotImplementedError):
        talg.cone_prod(spec, x, x)
    with pytest.raises(NotImplementedError):
        talg.maxstep(spec, x, x)
