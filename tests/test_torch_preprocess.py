"""The port's preprocessor (conicip_tpu_torch.preprocess) against
conicip_tpu.preprocess.

The same numpy data goes through both packages on the CPU in f64. ``imcols``
must keep the same set of rows and give the same consistency flag (the
pivot order may differ on ties, the kept set may not);
``preprocess_conic_ip`` must give the same status and ``Iter``, y and v to
1e-6 and the same zero-inflated ``w``.
"""

import numpy as np
import pytest
import torch

from conicip_tpu.preprocess import imcols as jax_imcols
from conicip_tpu.preprocess import preprocess_conic_ip as jax_preprocess
import conicip_tpu_torch as pt
from conicip_tpu_torch import native
from conicip_tpu_torch.preprocess import imcols, preprocess_conic_ip
from test_torch_ipm import assert_same

torch.set_num_threads(1)

OPT_TOL = 1e-7


def systems(rng):
    A = rng.standard_normal((5, 10))
    b = rng.standard_normal(5)
    return {
        "full_rank": (A, b),
        "redundant": (np.vstack([A, A[0:1] + A[1:2]]),
                      np.concatenate([b, b[0:1] + b[1:2]])),
        "inconsistent": (np.vstack([A, A[0:1]]),
                         np.concatenate([b, b[0:1] + 100])),
        "empty": (np.zeros((0, 5)), np.zeros(0)),
        "duplicated_rows": (np.vstack([A, A]), np.concatenate([b, b])),
    }


@pytest.mark.parametrize("name", ["full_rank", "redundant", "inconsistent",
                                  "empty", "duplicated_rows"])
def test_imcols_matches_jax(name, rng):
    A, b = systems(rng)[name]
    R, consistent = imcols(A, b)
    R_ref, consistent_ref = jax_imcols(A, b)
    assert consistent == consistent_ref
    assert len(R) == len(R_ref) == (np.linalg.matrix_rank(A) if A.size else 0)
    if name != "duplicated_rows":  # a tie: either copy of a row may be kept
        assert set(R.tolist()) == set(R_ref.tolist())
    # tensors and scipy.sparse are accepted like arrays
    Rt, ct_ = imcols(torch.from_numpy(A.copy()), torch.from_numpy(b.copy()))
    assert (Rt.tolist(), ct_) == (R.tolist(), consistent)


@pytest.mark.parametrize("name", ["full_rank", "redundant", "inconsistent",
                                  "duplicated_rows"])
def test_native_and_scipy_paths_give_the_same_ranks(name, rng, monkeypatch):
    A, b = systems(rng)[name]
    first = imcols(A, b)
    assert native.backend() in ("native", "scipy")
    monkeypatch.setattr(native, "pivoted_qr_rank", lambda M: None)
    second = imcols(A, b)
    assert len(first[0]) == len(second[0])
    assert first[1] == second[1]


def test_native_loader_builds_into_the_ports_directory():
    if not native.available():
        pytest.skip("no host C++ compiler: the scipy path is in use")
    rdiag, piv = native.pivoted_qr_rank(np.array([[1.0, 2.0], [2.0, 4.0],
                                                  [0.0, 1.0]]))
    assert rdiag.shape == (2,) and sorted(piv.tolist()) == [0, 1]
    assert rdiag[1] > 1e-8
    built = list(native._BUILD.glob("pivoted_qr-*.so"))
    assert built and all(p.parent.name == "_build" for p in built)


def instances(rng):
    n = 10
    h = rng.standard_normal(n)
    H = np.outer(h, h) + 1e-6 * np.eye(n)
    c = np.arange(1.0, n + 1)
    G1 = rng.random((6, n))
    out = {
        "redundant_primal": ((H, H @ c, np.eye(n), np.zeros(n), [("R", n)],
                              np.vstack([G1, G1]), np.zeros(12)),
                             dict(optTol=OPT_TOL)),
        "folded_inequalities": (
            (H, H @ c, np.vstack([np.eye(n), G1, -G1]), np.zeros(n + 12),
             [("R", n + 12)], G1, np.zeros(6)), dict(optTol=OPT_TOL)),
        "rank_deficient_dual": (
            (np.zeros((2 * n, 2 * n)), -np.ones(2 * n),
             np.hstack([np.eye(n), np.eye(n)]), np.zeros(n), [("R", n)]),
            dict(optTol=OPT_TOL)),
    }
    G = np.zeros((2, n))
    G[:, 0] = 1.0
    H0 = np.outer(h, h)
    out["inconsistent_equalities"] = (
        (H0, H0 @ c, np.eye(n), np.zeros(n), [("R", n)], G,
         np.array([1.0, -1.0])), dict(optTol=OPT_TOL))
    m = 4
    A = np.vstack([np.zeros((1, m)), np.eye(m)[:3], np.eye(m)])
    out["soc_passthrough"] = (
        (np.eye(m), -np.ones(m), A, np.zeros(2 * m) - np.eye(2 * m)[0],
         [("Q", 4), ("R", m)]), dict(optTol=1e-6))
    return out


@pytest.mark.parametrize("name", ["redundant_primal", "folded_inequalities",
                                  "rank_deficient_dual",
                                  "inconsistent_equalities",
                                  "soc_passthrough"])
def test_preprocess_conic_ip_matches_jax(name, rng):
    args, kw = instances(rng)[name]
    ref = jax_preprocess(*args, **kw)
    got = preprocess_conic_ip(*args, device="cpu", **kw)
    assert got.w.device.type == "cpu" and got.w.dtype == torch.float64
    sol = pt.solution_to_numpy(got)
    p = 0 if len(args) < 6 else args[5].shape[0]
    assert sol.w.shape == (p,) == np.asarray(ref.w).shape
    if name == "redundant_primal":
        # duplicated rows: which copy survives is the pivoted QR's choice,
        # the zero pattern differs with it but never the row pair's sum
        assert sol.status == ref.status == "Optimal"
        assert sol.Iter == ref.Iter
        np.testing.assert_allclose(sol.y, ref.y, atol=1e-6)
        np.testing.assert_allclose(sol.v, ref.v, atol=1e-6)
        np.testing.assert_allclose(sol.w[:6] + sol.w[6:],
                                   ref.w[:6] + ref.w[6:], atol=1e-6)
        assert np.count_nonzero(sol.w) <= 6
    else:
        assert_same(ref, sol, kw["optTol"])
    if name == "inconsistent_equalities":
        assert sol.status == "Infeasible" and sol.Iter == 0
        assert np.all(np.isnan(sol.y)) and np.all(np.isnan(sol.w))


def test_preprocess_verbose_reports_its_repairs(rng, capsys):
    args, kw = instances(rng)["redundant_primal"]
    preprocess_conic_ip(*args, device="cpu", verbose=True, **kw)
    out = capsys.readouterr().out
    assert "PREPROCESSOR" in out
    assert "Removing 6 redundant primal constraints" in out
