"""End to end on Q and S cones: conicip_tpu_torch.conic_ip against
conicip_tpu.conic_ip.

Each instance is made with numpy from a seed and solved by both packages on
the CPU in f64 (the port with ``device="cpu"``). Both must give the same
status and the same ``Iter``, y/w/v within 1e-6 (NaN patterns equal on
certificates), and, when Optimal, residuals below optTol: on the automatic
backend, which must be the same kind in both packages, and on the Schur
backend.
"""

import numpy as np
import pytest
import torch

import conicip_tpu as ct
from conicip_tpu.kkt import kktsolver_schur as jax_schur
from conicip_tpu.kkt.diag import kktsolver_diag as jax_diag
from conicip_tpu.solver import _auto_kktsolver as jax_auto
import conicip_tpu_torch as pt
from conicip_tpu_torch import models
from conicip_tpu_torch.kkt import kktsolver_diag as torch_diag
from conicip_tpu_torch.kkt import kktsolver_schur as torch_schur
from conicip_tpu_torch.kkt.spectral import spectral_kktsolver
from conicip_tpu_torch.solver import _auto_kktsolver as torch_auto
from conicip_tpu_torch.cones.spec import ConeSpec
from test_torch_ipm import assert_same, both

torch.set_num_threads(1)

FAMILIES = {
    "single_soc": lambda: models.single_soc(n=40),
    "many_small_socs": lambda: models.many_small_socs(n=60, k=20),
    "small_sdp": lambda: models.small_sdp(k=4),
    "mixed_rqs": lambda: models.mixed_rqs(),
    "mixed_rq_eq": lambda: models.mixed_rq_eq(n=30),
}
AUTO_KIND = {"single_soc": "schur", "many_small_socs": "schur",
             "small_sdp": "spectral", "mixed_rqs": "spectral",
             "mixed_rq_eq": "schur"}


def kind(solver, schur, diag):
    if solver is schur:
        return "schur"
    if getattr(solver, "func", None) is diag:
        return "diag"
    return "spectral"


def schur_kw():
    return dict(jax_kw=dict(kktsolver=jax_schur),
                torch_kw=dict(kktsolver=torch_schur))


@pytest.mark.parametrize("family", list(FAMILIES))
def test_auto_backend_matches_jax(family):
    P = FAMILIES[family]()
    Q, c, A, b, cones, G, d = P.args()
    got = torch_auto(Q, A, G, ConeSpec(cones), None)
    ref = jax_auto(Q, A, G, ct.ConeSpec(cones), None)
    assert kind(got, torch_schur, torch_diag) == AUTO_KIND[family]
    assert kind(ref, jax_schur, jax_diag) == AUTO_KIND[family]
    if AUTO_KIND[family] == "spectral":
        assert got is spectral_kktsolver()
    ref_sol, sol = both(*P.args())
    assert_same(ref_sol, sol, 1e-6)


@pytest.mark.parametrize("family", ["small_sdp", "mixed_rqs"])
def test_a_solve_on_the_jacobi_kernels_arithmetic_gives_the_references(
        family, monkeypatch):
    # the port's S-cone decompositions routed to tests/jacobi_model.py, the
    # CUDA Jacobi kernels' arithmetic (their rotations, ordering,
    # convergence tests and sort, not LAPACK's algorithm): the solve takes
    # the reference's path, status and Iter. The reference solves are the
    # ones test_auto_backend_matches_jax compiled just before.
    import jacobi_model as model
    from conicip_tpu_torch.cones import algebra, scaling
    from conicip_tpu_torch.ops import batched

    calls = []

    def routed(fn):
        def run(A):
            calls.append(fn.__name__)
            out = fn(A.detach().numpy())
            return (torch.from_numpy(out) if isinstance(out, np.ndarray)
                    else tuple(torch.from_numpy(o) for o in out))
        return run

    for name, fn in (("safe_eigh", model.eigh),
                     ("safe_eigvalsh", model.eigvalsh),
                     ("safe_svd", model.svd)):
        monkeypatch.setattr(batched, name, routed(fn))
        for mod in (algebra, scaling):
            if hasattr(mod, name):
                monkeypatch.setattr(mod, name, routed(fn))
    P = FAMILIES[family]()
    ref = ct.conic_ip(*P.args())
    sol = pt.conic_ip(*P.args(), device="cpu")
    assert {"eigh", "svd"} <= set(calls)
    assert sol.status == ref.status == "Optimal"
    assert sol.Iter == ref.Iter


@pytest.mark.parametrize("family", list(FAMILIES))
def test_schur_backend_matches_jax(family):
    ref, sol = both(*FAMILIES[family]().args(), **schur_kw())
    assert_same(ref, sol, 1e-6)


def tri(d):
    return d * (d + 1) // 2


def ipm_conic_instance(name):
    """The tests/test_ipm_conic.py instances (rng fixture: default_rng(0))."""
    rng = np.random.default_rng(0)
    if name == "projection_onto_sphere":
        n = 2
        A = np.vstack([np.zeros((1, n)), np.eye(n)])
        b = np.concatenate([[-1.0], np.zeros(n)])
        return (np.eye(n), np.ones(n), A, b, [("Q", n + 1)]), 1e-7
    if name == "combined_r_and_q":
        n = 10
        A = np.vstack([np.eye(n), np.zeros((1, n)), np.eye(n)])
        b = np.concatenate([np.zeros(n), [-1.0], np.zeros(n)])
        return (np.eye(n), np.arange(1.0, n + 1), A, b,
                [("R", n), ("Q", n + 1)]), 1e-7
    if name == "psd_projection":
        n = 21
        C = np.diag([1.0, 1, 1, -1, -1, -1])
        rows, cols = np.triu_indices(6)
        c = C[rows, cols] * np.where(rows == cols, 1.0, np.sqrt(2.0))
        return (np.eye(n), c, np.eye(n), np.zeros(n), [("S", n)]), 1e-7
    if name == "soc_nonneg_mix":
        n = 4
        A = np.vstack([np.zeros((1, n)), np.eye(n)[:3], np.eye(n)])
        b = np.concatenate([[-1.0], np.zeros(3), np.zeros(n)])
        return (np.eye(n), -np.ones(n), A, b, [("Q", 4), ("R", n)]), 1e-6
    if name == "mixed_r_q_s":
        n = 6 + 10 + tri(4)
        rng.uniform(0.5, 1.5, n)  # the reference test draws y0 first
        c = rng.standard_normal(n) * 0.1
        return (np.eye(n), c, np.eye(n), np.zeros(n),
                [("R", 6), ("Q", 10), ("S", tri(4))], np.ones((1, n)),
                np.array([1.0])), 1e-6
    if name == "many_small_socs":
        k, dim = 50, 3
        n = k * dim
        return (np.eye(n), rng.standard_normal(n), np.eye(n), np.zeros(n),
                [("Q", dim)] * k), 1e-6
    raise KeyError(name)


@pytest.mark.parametrize("name", [
    "projection_onto_sphere", "combined_r_and_q", "psd_projection",
    "soc_nonneg_mix", "mixed_r_q_s", "many_small_socs"])
def test_ipm_conic_instances_match_jax(name):
    args, tol = ipm_conic_instance(name)
    ref, sol = both(*args, optTol=tol, **schur_kw())
    assert ref.status == "Optimal"
    assert_same(ref, sol, tol)


def test_infeasible_soc_certificates_match_jax():
    # ‖y‖ ≤ 1 and y₁ ≥ 2 cannot both hold
    n = 3
    A = np.vstack([np.zeros((1, n)), np.eye(n), np.eye(n)[:1]])
    b = np.concatenate([[-1.0], np.zeros(n), [2.0]])
    ref, sol = both(np.eye(n), np.ones(n), A, b, [("Q", n + 1), ("R", 1)])
    assert ref.status == "Infeasible"
    assert_same(ref, sol, 1e-6)
    assert np.isnan(sol.y).all() and np.isfinite(sol.v).all()


@pytest.mark.parametrize("family, backend, expect", [
    ("small_sdp", None, 1),  # auto spectral: 1, like auto Schur
    ("single_soc", None, 1),
    ("small_sdp", "schur", 0),  # a user callback: 0
])
def test_default_centrality_correctors(family, backend, expect, monkeypatch):
    from conicip_tpu_torch import solver

    seen = {}

    def spy(real):
        def call(*args, **kw):
            seen["opts"] = args[8]
            return real(*args, **kw)
        return call

    # the eager loop (a user callback) is ipm_solve, the device loop (the
    # automatic backends) graph.solve: both take ipm_solve's arguments
    monkeypatch.setattr(solver, "ipm_solve", spy(solver.ipm_solve))
    monkeypatch.setattr(solver.graph, "solve", spy(solver.graph.solve))
    kw = {} if backend is None else dict(kktsolver=torch_schur)
    sol = pt.conic_ip(*FAMILIES[family]().args(), device="cpu", **kw)
    assert sol.status == "Optimal"
    assert seen["opts"].centralityCorrectors == expect
