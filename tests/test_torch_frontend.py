"""The frontends: conicip_tpu_torch.frontend against conicip_tpu.frontend.

Every instance of tests/test_frontend.py and tests/test_conic_form.py is
built twice from the same numpy data, once with each package's frontend
(the port with ``device="cpu"``), and must give the same termination status
and ``Iter``, the objective within 1e-8·(1+|obj|), and primal, duals and
slack within 1e-6 (NaN patterns equal). One mid-size instance per cone
family, built through ``Optimizer`` from the shared generators, is also
held against the port's direct ``conic_ip`` (same status and ``Iter``, y
within 1e-9).
"""

import subprocess
import sys
import textwrap

import numpy as np
import pytest
import torch

import conicip_tpu as ct
import conicip_tpu.frontend as ref_fe
import conicip_tpu_torch as pt
import conicip_tpu_torch.frontend as pt_fe
from conicip_tpu_torch import models
from conicip_tpu_torch.cones.spec import tri_order

torch.set_num_threads(1)

ATOL = 1e-6


def close(a, b, what=""):
    np.testing.assert_allclose(np.asarray(a), np.asarray(b), rtol=0,
                               atol=ATOL, equal_nan=True, err_msg=what)


def same_objective(a, b):
    if np.isnan(a) and np.isnan(b):
        return
    assert abs(a - b) <= 1e-8 * (1 + abs(b))


# ── Optimizer: the instances of tests/test_frontend.py ──


def simple_lp(F, **kw):
    model = F.Optimizer(optTol=1e-6, **kw)
    x = model.add_variables(2)
    model.set_objective("min", {x[0]: 1.0, x[1]: 1.0})
    model.add_constraint(np.ones((1, 2)), np.zeros(1), F.GreaterThan(1.0))
    model.add_constraint(np.eye(2)[0:1], np.zeros(1), F.GreaterThan(0.0))
    model.add_constraint(np.eye(2)[1:2], np.zeros(1), F.GreaterThan(0.0))
    return model, x


def soc(F, **kw):
    model = F.Optimizer(optTol=1e-6, **kw)
    x = model.add_variables(3)
    model.set_objective("min", {x[2]: 1.0})
    e = np.eye(3)
    model.add_constraint(e[0:1], np.zeros(1), F.EqualTo(1.0))
    model.add_constraint(e[1:2], np.zeros(1), F.EqualTo(1.0))
    model.variables_in([x[2], x[0], x[1]], F.SecondOrderCone(3))
    return model, x


def max_sense(F, **kw):
    model = F.Optimizer(optTol=1e-6, **kw)
    x = model.add_variables(2)
    model.set_objective("max", {x[0]: 1.0, x[1]: 2.0})
    model.add_constraint(np.ones((1, 2)), np.zeros(1), F.LessThan(1.0))
    model.add_constraint(np.eye(2)[0:1], np.zeros(1), F.GreaterThan(0.0))
    model.add_constraint(np.eye(2)[1:2], np.zeros(1), F.GreaterThan(0.0))
    return model, x


def constant_and_duals(F, **kw):
    model = F.Optimizer(optTol=1e-7, **kw)
    x = model.add_variables(2)
    model.set_objective("min", {x[0]: 1.0, x[1]: 1.0}, constant=5.0)
    model.add_constraint(np.ones((1, 2)), np.zeros(1), F.GreaterThan(1.0))
    model.add_constraint(np.eye(2)[0:1], np.zeros(1), F.GreaterThan(0.0))
    model.add_constraint(np.eye(2)[1:2], np.zeros(1), F.GreaterThan(0.0))
    return model, x


def quadratic_min(F, **kw):
    m = F.Optimizer(optTol=1e-8, **kw)
    x = m.add_variables(2)
    m.set_objective("min", {x[0]: -1.0, x[1]: -2.0},
                    quadratic={(0, 0): 1.0, (1, 1): 1.0})
    m.variables_in(x, F.Nonnegatives(2))
    m.add_constraint(np.ones((1, 2)), np.zeros(1), F.GreaterThan(1.0))
    return m, x


def quadratic_max(F, **kw):
    m = F.Optimizer(optTol=1e-8, **kw)
    y = m.add_variable()
    m.set_objective("max", {y: 1.0}, quadratic={(0, 0): -1.0})
    m.add_constraint(np.ones((1, 1)), np.zeros(1), F.GreaterThan(0.0))
    return m, [y]


def psd_triangle(F, **kw):
    rng = np.random.default_rng(3)
    k = 4
    B = rng.standard_normal((k, k))
    m = pt.vecm(torch.as_tensor(0.5 * (B + B.T))).numpy()
    dim = k * (k + 1) // 2
    model = F.Optimizer(optTol=1e-7, **kw)
    x = model.add_variables(dim)
    model.set_objective("min", {i: -m[i] for i in range(dim)},
                        quadratic=np.eye(dim))
    model.variables_in(x, F.PSDTriangle(k))
    return model, x


def every_set(F, **kw):
    # Zeros, Nonpositives and a dense objective vector, which the cases
    # above leave out: min −x0 − x1 + x2, x0 + x1 − 1 ∈ {0}, x − 2 ≤ 0,
    # x ≥ 0
    model = F.Optimizer(optTol=1e-7, **kw)
    x = model.add_variables(3)
    model.set_objective("min", np.array([-1.0, -1.0, 1.0]))
    model.add_constraint(np.array([[1.0, 1.0, 0.0]]), -np.ones(1), F.Zeros(1))
    model.add_constraint(np.eye(3), -2.0 * np.ones(3), F.Nonpositives(3))
    model.variables_in(x, F.Nonnegatives(3))
    return model, x


def infeasible_lp(F, **kw):
    model = F.Optimizer(**kw)
    x = model.add_variable()
    model.set_objective("min", {x: 1.0})
    model.add_constraint(np.ones((1, 1)), np.zeros(1), F.GreaterThan(1.0))
    model.add_constraint(np.ones((1, 1)), np.zeros(1), F.LessThan(0.0))
    return model, [x]


def unbounded_lp(F, **kw):
    model = F.Optimizer(**kw)
    x = model.add_variables(2)
    model.set_objective("min", {x[0]: -1.0, x[1]: 1.0})
    model.variables_in(x, F.Nonnegatives(2))
    return model, x


OPTIMIZER_CASES = {
    "simple_lp": (simple_lp, "OPTIMAL"),
    "soc": (soc, "OPTIMAL"),
    "max_sense": (max_sense, "OPTIMAL"),
    "constant_and_duals": (constant_and_duals, "OPTIMAL"),
    "quadratic_min": (quadratic_min, "OPTIMAL"),
    "quadratic_max": (quadratic_max, "OPTIMAL"),
    "psd_triangle": (psd_triangle, "OPTIMAL"),
    "every_set": (every_set, "OPTIMAL"),
    "infeasible_lp": (infeasible_lp, "INFEASIBLE"),
    "unbounded_lp": (unbounded_lp, "DUAL_INFEASIBLE"),
}


def assert_models_agree(ref, rx, mine, x):
    assert mine.termination_status() == ref.termination_status()
    assert mine.sol.status == ref.sol.status
    assert mine.sol.Iter == ref.sol.Iter
    same_objective(mine.objective_value(), ref.objective_value())
    close(mine.variable_primal(x), ref.variable_primal(rx), "primal")
    for vi, rvi in zip(x, rx):
        close(mine.variable_primal(vi), ref.variable_primal(rvi), "primal")
    assert len(mine._constraints) == len(ref._constraints) > 0
    for ci in range(len(ref._constraints)):
        dual = mine.constraint_dual(ci)
        assert isinstance(dual, np.ndarray)
        close(dual, ref.constraint_dual(ci), f"dual of constraint {ci}")


@pytest.mark.parametrize("case", sorted(OPTIMIZER_CASES))
def test_optimizer_matches_reference(case):
    build, status = OPTIMIZER_CASES[case]
    ref, rx = build(ref_fe)
    mine, x = build(pt_fe, device="cpu")
    assert rx == x
    ref.optimize()
    sol = mine.optimize()
    assert sol is mine.sol
    assert mine.termination_status() == status
    assert_models_agree(ref, rx, mine, x)


def test_status_before_optimize():
    for model in (ref_fe.Optimizer(), pt_fe.Optimizer(device="cpu")):
        assert model.termination_status() == "OPTIMIZE_NOT_CALLED"
        for getter in (model.objective_value,
                       lambda: model.variable_primal(0),
                       lambda: model.constraint_dual(0)):
            with pytest.raises(RuntimeError):
                getter()
    assert (vars(pt_fe.TerminationStatus).keys()
            == vars(ref_fe.TerminationStatus).keys())


def test_iteration_limit_status():
    ref, _ = simple_lp(ref_fe)
    mine, _ = simple_lp(pt_fe, device="cpu")
    for model in (ref, mine):
        model.maxIters = 2
        model.optimize()
    assert (mine.termination_status() == ref.termination_status()
            == "ITERATION_LIMIT")


@pytest.mark.parametrize("F, kw", [(ref_fe, {}), (pt_fe, dict(device="cpu"))],
                         ids=["reference", "port"])
def test_optimizer_rejects_bad_input(F, kw):
    model = F.Optimizer(**kw)
    model.add_variables(2)
    with pytest.raises(ValueError, match="sense"):
        model.set_objective("minimize", {0: 1.0})
    with pytest.raises(TypeError, match="unsupported constraint set"):
        model.add_constraint(np.ones((1, 2)), np.zeros(1), "GreaterThan")
    with pytest.raises(ValueError, match="single affine row"):
        model.add_constraint(np.ones((2, 2)), np.zeros(2), F.EqualTo(1.0))
    with pytest.raises(ValueError, match="set has dim 3"):
        model.add_constraint(np.ones((2, 2)), np.zeros(2), F.Nonnegatives(3))
    with pytest.raises(ValueError, match="set has dim 3"):
        model.add_constraint(np.ones((3, 2)), np.zeros(2),
                             F.SecondOrderCone(3))
    assert F.PSDTriangle(4).dim == 10


def test_solution_stays_on_the_device_and_getters_are_host_values():
    model, x = constant_and_duals(pt_fe, device="cpu", dtype=torch.float64)
    assert model.sol is None
    sol = model.optimize()
    for t in (sol.y, sol.w, sol.v):
        assert isinstance(t, torch.Tensor) and t.device.type == "cpu"
    assert isinstance(model.objective_value(), float)
    assert isinstance(model.variable_primal(x[0]), float)
    assert isinstance(model.variable_primal(x), np.ndarray)
    assert isinstance(model.variable_primal(np.array(x)), np.ndarray)
    assert isinstance(model.constraint_dual(0), np.ndarray)
    # one host copy per solve, which the getters read
    assert isinstance(model._host.y, np.ndarray)
    np.testing.assert_array_equal(model._host.y, sol.y.numpy())
    # a second solve replaces both
    model.set_objective("min", {x[0]: 2.0, x[1]: 1.0})
    again = model.optimize()
    assert again is model.sol and again is not sol
    np.testing.assert_array_equal(model._host.y, again.y.numpy())
    assert model.variable_primal(x[1]) == pytest.approx(1.0, abs=1e-4)


@pytest.mark.parametrize("entry", ["Optimizer", "solve_conic_form",
                                   "preprocess_conic_ip"])
def test_default_device_is_the_card_and_nothing_falls_back(entry):
    # without device="cpu" the entry points go to the card; where there is
    # none they raise
    if torch.cuda.is_available():
        pytest.skip("needs a machine without a GPU")
    with pytest.raises((RuntimeError, AssertionError), match="(?i)cuda"):
        if entry == "Optimizer":
            simple_lp(pt_fe)[0].optimize()
        elif entry == "solve_conic_form":
            pt_fe.solve_conic_form(*lp_with_equalities()[:4])
        else:
            pt.preprocess_conic_ip(np.eye(2), np.ones(2), np.eye(2),
                                   np.zeros(2), [("R", 2)])


# ── Optimizer on one mid-size instance per cone family ──

SET_OF_CONE = {"R": "Nonnegatives", "Q": "SecondOrderCone"}


def optimizer_model(F, P, **kw):
    """The generator problem ``P`` (min ½yᵀQy − cᵀy, Ay ≥_K b, Gy = d) as
    an Optimizer model: one constraint per cone block, Q as ``quadratic``."""
    n = P.Q.shape[0]
    model = F.Optimizer(**kw)
    x = model.add_variables(n)
    model.set_objective("min", -np.asarray(P.c), quadratic=P.Q)
    row = 0
    for kind, dim in P.cone_dims:
        cset = (F.PSDTriangle(tri_order(dim)) if kind == "S"
                else getattr(F, SET_OF_CONE[kind])(dim))
        model.add_constraint(P.A[row:row + dim], -P.b[row:row + dim], cset)
        row += dim
    if P.G is not None and P.G.shape[0]:
        model.add_constraint(P.G, -P.d, F.Zeros(P.G.shape[0]))
    return model, x


def small_mixed_rq_eq():
    # mixed_rq_eq's own SOC block has 51 rows whatever n; the batched
    # generator's family takes the block sizes
    Q, c, A, b, cones, G, d = models.batched_mixed_rq_eq(1, n=40, n_q=11, p=4)
    return models.Problem("mixed_rq_eq(n=40,n_q=11,p=4)", Q[0], c[0], A[0],
                          b[0], cones, G, d[0])


FAMILIES = {
    "box_qp_dense": lambda: models.box_qp_dense(n=64),
    "single_soc": lambda: models.single_soc(n=60),
    "small_sdp": lambda: models.small_sdp(k=6),
    "mixed_rq_eq": small_mixed_rq_eq,
}


@pytest.mark.parametrize("family", sorted(FAMILIES))
def test_optimizer_on_generator_families(family):
    P = FAMILIES[family]()
    ref, rx = optimizer_model(ref_fe, P)
    mine, x = optimizer_model(pt_fe, P, device="cpu")
    ref.optimize()
    mine.optimize()
    assert mine.termination_status() == "OPTIMAL"
    assert_models_agree(ref, rx, mine, x)
    direct = pt.conic_ip(*P.args(), device="cpu")
    assert (mine.sol.status, mine.sol.Iter) == (direct.status, direct.Iter)
    assert float((mine.sol.y - direct.y).abs().max()) <= 1e-9
    np.testing.assert_allclose(mine.variable_primal(x), direct.y.numpy(),
                               rtol=0, atol=1e-9)
    # the duals come back per constraint, in the direct solve's row order
    row = 0
    for ci, (_, dim) in enumerate(P.cone_dims):
        np.testing.assert_allclose(mine.constraint_dual(ci),
                                   direct.v[row:row + dim].numpy(),
                                   rtol=0, atol=1e-9)
        row += dim
    if P.G is not None and P.G.shape[0]:
        np.testing.assert_allclose(
            mine.constraint_dual(len(P.cone_dims)), direct.w.numpy(),
            rtol=0, atol=1e-9)
    same_objective(mine.objective_value(), direct.pobj)


# ── solve_conic_form: the instances of tests/test_conic_form.py ──


def lp_with_equalities():
    c = np.array([1.0, 2.0])
    A = np.array([[1.0, 1.0], [-1.0, 0.0], [0.0, -1.0]])
    b = np.array([1.0, 0.0, 0.0])
    return c, A, b, dict(zero=1, nonneg=2), {}


def socp_norm():
    rng = np.random.default_rng(3)
    n = 5
    c = rng.standard_normal(n)
    A = np.zeros((n + 1, n))
    A[1:, :] = -np.eye(n)
    b = np.zeros(n + 1)
    b[0] = 1.0
    return c, A, b, dict(soc=(n + 1,)), {}


def sdp_scaled_lower_triangle():
    rng = np.random.default_rng(5)
    k = 4
    Csym = rng.standard_normal((k, k))
    Csym = 0.5 * (Csym + Csym.T)
    c = np.array([Csym[i, j] * (1.0 if i == j else np.sqrt(2.0))
                  for j in range(k) for i in range(j, k)])
    t = k * (k + 1) // 2
    diag_idx = np.cumsum([0] + [k - j for j in range(k - 1)])
    A = np.zeros((1 + t, t))
    A[0, diag_idx] = 1.0
    A[1:, :] = -np.eye(t)
    b = np.zeros(1 + t)
    b[0] = 1.0
    return c, A, b, dict(zero=1, psd=(k,)), {}


def quadratic_P():
    return (np.array([-1.0, 1.0]), -np.eye(2), np.zeros(2), dict(nonneg=2),
            dict(P=np.eye(2)))


def infeasible_aliases():
    return (np.array([1.0]), np.array([[-1.0], [1.0]]),
            np.array([-1.0, 0.0]), {"l": 2}, {})


def mixed_rows_order():
    c = np.array([-1.0, 0.0])
    A = np.array([[1.0, 0.0], [0.0, 0.0], [-1.0, 0.0], [0.0, -1.0]])
    b = np.array([3.0, 5.0, 0.0, 0.0])
    return c, A, b, dict(nonneg=1, soc=(3,)), {}


def only_equalities():
    # m = 0: no cone row, two vacuous R rows are padded and dropped again.
    # min ½|x|² + cᵀx on x0 + x1 + x2 = 1
    return (np.array([1.0, 2.0, 3.0]), np.ones((1, 3)), np.array([1.0]),
            {"f": 1}, dict(P=np.eye(3)))


def only_equalities_unbounded():
    # m = 0 and no curvature: a free direction along the equality
    return np.array([1.0, 2.0]), np.ones((1, 2)), np.array([1.0]), {"z": 1}, {}


def unpreprocessed():
    c, A, b, dims, _ = lp_with_equalities()
    return c, A, b, dims, dict(preprocess=False, optTol=1e-8)


CONIC_FORM_CASES = {
    "lp_with_equalities": (lp_with_equalities, "Optimal"),
    "socp_norm": (socp_norm, "Optimal"),
    "sdp_scaled_lower_triangle": (sdp_scaled_lower_triangle, "Optimal"),
    "quadratic_P": (quadratic_P, "Optimal"),
    "infeasible_aliases": (infeasible_aliases, "Infeasible"),
    "mixed_rows_order": (mixed_rows_order, "Optimal"),
    "only_equalities": (only_equalities, "Optimal"),
    "only_equalities_unbounded": (only_equalities_unbounded, None),
    "unpreprocessed": (unpreprocessed, "Optimal"),
}


def assert_results_agree(ref, res):
    assert res.status == ref.status
    assert res.solution.Iter == ref.solution.Iter
    same_objective(res.obj, ref.obj)
    for f in ("x", "y", "s"):
        mine = getattr(res, f)
        assert isinstance(mine, np.ndarray) and mine.dtype == np.float64
        assert mine.shape == getattr(ref, f).shape
        close(mine, getattr(ref, f), f)
    assert isinstance(res.solution, pt.Solution)
    assert isinstance(res.solution.y, torch.Tensor)


@pytest.mark.parametrize("case", sorted(CONIC_FORM_CASES))
def test_conic_form_matches_reference(case):
    make, status = CONIC_FORM_CASES[case]
    c, A, b, dims, kw = make()
    ref = ref_fe.solve_conic_form(c, A, b, dims, **kw)
    res = pt_fe.solve_conic_form(c, A, b, dims, device="cpu", **kw)
    if status is not None:
        assert res.status == status
    assert_results_agree(ref, res)
    assert res.y.shape == (A.shape[0],)
    if res.status == "Optimal":
        np.testing.assert_allclose(res.s, b - A @ res.x, atol=1e-12)
    else:
        assert np.all(np.isnan(res.s)) and np.isnan(res.obj)


def test_conic_form_takes_dims_objects_sparse_and_tensors():
    from scipy import sparse

    c, A, b, dims, _ = mixed_rows_order()
    ref = ref_fe.solve_conic_form(c, A, b, ref_fe.ConeDims(**dims))

    class Duck:
        zero, nonneg, soc, psd = 0, 1, [3], None
        exp = 0

    for form in (pt_fe.ConeDims(**dims), dict(l=1, q=[3]), Duck()):
        assert_results_agree(ref, pt_fe.solve_conic_form(
            c, sparse.csr_matrix(A), b, form, device="cpu"))
    assert_results_agree(ref, pt_fe.solve_conic_form(
        torch.as_tensor(c), torch.as_tensor(A), torch.as_tensor(b),
        pt_fe.ConeDims(**dims), device="cpu"))
    mine = pt_fe.ConeDims(2, 3, [4], [3])
    theirs = ref_fe.ConeDims(2, 3, [4], [3])
    assert (mine.cone_rows, mine.total_rows, mine.cone_dims()) == (
        theirs.cone_rows, theirs.total_rows, theirs.cone_dims())
    # solver options pass through: a KKT backend picked by hand
    by_qr = pt_fe.solve_conic_form(c, A, b, dims, device="cpu",
                                   kktsolver=pt.kktsolver_qr)
    assert by_qr.status == "Optimal"
    close(by_qr.x, ref.x)


@pytest.mark.parametrize("F, kw", [(ref_fe, {}), (pt_fe, dict(device="cpu"))],
                         ids=["reference", "port"])
def test_conic_form_rejects_bad_input(F, kw):
    class FakeDims:
        zero, nonneg, soc, psd = 0, 1, (), ()
        exp = 2
        p3d = ()

    class PowerDims(FakeDims):
        exp = 0
        p3d = (0.5,)

    for dims in (FakeDims(), PowerDims()):
        with pytest.raises(ValueError, match="exponential"):
            F.solve_conic_form(np.zeros(1), np.zeros((1, 1)), np.zeros(1),
                               dims, **kw)
    with pytest.raises(ValueError, match=r"expected \(3, 2\)"):
        F.solve_conic_form(np.zeros(2), np.zeros((2, 2)), np.zeros(2),
                           dict(zero=1, nonneg=2), **kw)


# ── the CVXPY bridge ──


def test_cvxpy_bridge_imports_without_cvxpy():
    from conicip_tpu_torch.frontend import cvxpy_solver

    assert cvxpy_solver.__all__ == ["ConicIPSolver", "CONICIP_TPU_TORCH"]
    try:
        import cvxpy  # noqa: F401
    except ImportError:
        with pytest.raises(ImportError, match="cvxpy is required"):
            cvxpy_solver.ConicIPSolver()
    else:
        assert cvxpy_solver.ConicIPSolver(device="cpu").name() == (
            cvxpy_solver.CONICIP_TPU_TORCH)


def cvxpy_problems(cp):
    x = cp.Variable(2)
    yield "lp", cp.Problem(cp.Minimize(x[0] + 2 * x[1]),
                           [x[0] + x[1] == 1, x >= 0]), x
    x = cp.Variable(3)
    yield "socp", cp.Problem(cp.Minimize(np.array([1.0, -2.0, 0.5]) @ x),
                             [cp.norm(x, 2) <= 1]), x
    rng = np.random.default_rng(7)
    C = rng.standard_normal((3, 3))
    X = cp.Variable((3, 3), symmetric=True)
    yield "sdp", cp.Problem(cp.Minimize(cp.trace(0.5 * (C + C.T) @ X)),
                            [X >> 0, cp.trace(X) == 1]), X
    x = cp.Variable(1)
    yield "infeasible", cp.Problem(cp.Minimize(x[0]), [x >= 1, x <= 0]), x


@pytest.mark.parametrize("which", ["lp", "socp", "sdp", "infeasible"])
def test_cvxpy_bridge_matches_reference(which):
    cp = pytest.importorskip("cvxpy")
    from conicip_tpu.frontend.cvxpy_solver import ConicIPSolver as RefSolver
    from conicip_tpu_torch.frontend.cvxpy_solver import ConicIPSolver

    prob, var = next((p, v) for name, p, v in cvxpy_problems(cp)
                     if name == which)
    prob.solve(solver=RefSolver(optTol=1e-7))
    ref = (prob.status, prob.value,
           None if var.value is None else np.array(var.value))
    prob.solve(solver=ConicIPSolver(optTol=1e-7, device="cpu"))
    assert prob.status == ref[0]
    if ref[2] is not None:
        same_objective(prob.value, ref[1])
        close(var.value, ref[2])


# ── names and imports ──


def test_every_public_name_of_the_reference_exists():
    import conicip_tpu.frontend as rf

    lazy = ("conic_ip", "Solution", "IPMOptions", "kktsolver_schur",
            "kktsolver_qr", "kktsolver_lu", "pivot", "kktsolver_2x2",
            "kktsolver_diag", "separable", "preprocess_conic_ip", "imcols",
            "Optimizer", "solve_batch", "BatchSolution", "kktsolver_schur_tp",
            "make_mesh")
    for name in lazy:  # the list above is the reference's lazy table
        assert getattr(ct, name) is not None
    public = set(ct.__all__) | set(lazy) | {"Id"}
    missing = {name for name in public if not hasattr(pt, name)}
    assert missing == set()
    assert set(rf.__all__) == set(pt_fe.__all__)
    for name in rf.__all__:
        assert hasattr(pt_fe, name)
    assert pt.Optimizer is pt_fe.Optimizer
    eye = pt.Id(3, device="cpu")
    assert eye.dtype == torch.float64 and eye.device.type == "cpu"
    np.testing.assert_array_equal(eye.numpy(), np.asarray(ct.Id(3)))
    assert pt.Id(2, device="cpu", dtype=torch.float32).dtype == torch.float32



# The reference's subpackages that declare ``__all__`` (``conicip_tpu.native``
# declares none), and the names of theirs the port leaves out on purpose:
# ROADMAP.md's "Do not port" list (the v5e's emulated-f64 and Ozaki
# helpers, ``cond_once``) and the CVXPY name constant, which the port
# renames ``CONICIP_TPU_TORCH``.
SUBPACKAGES = ("cones", "frontend", "kkt", "models", "ops", "parallel",
               "solver")
NOT_PORTED = {"blocked_cholesky", "blocked_tri_inv", "PreciseMatvec",
              "cond_once", "CONICIP_TPU"}


@pytest.mark.parametrize("sub", SUBPACKAGES)
def test_every_subpackage_exports_the_references_names(sub):
    import importlib

    ref = importlib.import_module(f"conicip_tpu.{sub}")
    port = importlib.import_module(f"conicip_tpu_torch.{sub}")
    missing = {name for name in ref.__all__
               if name not in NOT_PORTED and not hasattr(port, name)}
    assert missing == set()
    assert set(ref.__all__) - NOT_PORTED <= set(port.__all__)
    # what a name is in the reference, it is in the port: a function
    # shadows a submodule of the same name (ops.cholesky)
    for name in set(ref.__all__) - NOT_PORTED:
        assert callable(getattr(port, name)) == callable(getattr(ref, name))


def test_the_reference_exports_of_kkt_and_ops_import():
    from conicip_tpu_torch.kkt import separable_batch
    from conicip_tpu_torch.kkt.diag import separable_batch as defined
    from conicip_tpu_torch.ops import CholFactor, cho_solve, cholesky
    from conicip_tpu_torch.ops.cholesky import cholesky as factor

    assert separable_batch is defined and cholesky is factor
    B = np.random.default_rng(0).standard_normal((5, 5))
    M = torch.from_numpy(B @ B.T + 5 * np.eye(5))
    b = torch.arange(5, dtype=torch.float64)
    x = cho_solve(cholesky(M), b)
    torch.testing.assert_close(M @ x, b, rtol=0, atol=1e-12)
    torch.testing.assert_close(CholFactor(M).solve(b), x, rtol=0, atol=0)
    spec = pt.ConeSpec([("R", 4)])
    Q = np.stack([np.diag([1.0, 2.0])] * 3)
    A = np.stack([np.vstack([np.eye(2), -np.eye(2)])] * 3)
    assert separable_batch(Q, A, None, spec)
    assert not separable_batch(Q, A + 0.5, None, spec)


IMPORTS = {
    "frontend": """
        import conicip_tpu_torch.frontend
        import conicip_tpu_torch.frontend.cvxpy_solver
        from conicip_tpu_torch import Id, Optimizer
    """,
    # what chip_smoke.py imports at the top and inside its phases
    "chip_smoke": """
        import chip_smoke
        from conicip_tpu_torch import (conic_ip, kktsolver_lu, kktsolver_qr,
                                       models, native, preprocess_conic_ip,
                                       solve_batch)
        from conicip_tpu_torch.frontend import (ConeDims, Optimizer,
                                                solve_conic_form)
        from conicip_tpu_torch.kkt.lowrank import lowrank_kktsolver
        from conicip_tpu_torch.ops import cholesky_kernel
        from conicip_tpu_torch.ops.build import find_nvcc, load_library
        from conicip_tpu_torch.parallel import batch, checkpoint
    """,
}


@pytest.mark.parametrize("what", sorted(IMPORTS))
def test_the_port_imports_no_jax(what):
    import pathlib

    root = pathlib.Path(__file__).parent.parent
    code = textwrap.dedent(IMPORTS[what]) + textwrap.dedent("""
        import sys
        bad = sorted(m for m in sys.modules
                     if m.split(".")[0] in ("jax", "jaxlib", "conicip_tpu"))
        assert not bad, bad
        print("clean")
    """)
    out = subprocess.run([sys.executable, "-c", code], cwd=root,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip().endswith("clean")
