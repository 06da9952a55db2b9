"""End to end: conicip_tpu_torch.conic_ip against conicip_tpu.conic_ip.

Each instance is made with numpy from a seed and solved by both packages on
the CPU in f64 (the port with ``device="cpu"``, so its Cholesky runs the
plain PyTorch version). Both must give the same status and the same
``Iter``, y/w/v within 1e-6 (NaN patterns equal on certificates), and, when
Optimal, residuals below optTol.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import conicip_tpu as ct
from conicip_tpu.kkt import kktsolver_schur as jax_schur
from conicip_tpu.kkt import pivot as jax_pivot
import conicip_tpu_torch as pt
from conicip_tpu_torch.kkt import kktsolver_schur as torch_schur
from conicip_tpu_torch.kkt import pivot as torch_pivot
from conicip_tpu_torch.models import box_qp_dense, box_qp_sparse

torch.set_num_threads(1)

OPT_TOL = 1e-7


def both(*args, jax_kw=None, torch_kw=None, **kw):
    """Solve with both packages; return (jax_solution, numpy_port_solution)."""
    ref = ct.conic_ip(*args, **kw, **(jax_kw or {}))
    sol = pt.conic_ip(*args, device="cpu", **kw, **(torch_kw or {}))
    assert sol.y.device.type == "cpu" and sol.y.dtype == torch.float64
    return ref, pt.solution_to_numpy(sol)


def assert_same(ref, sol, opt_tol):
    assert sol.status == ref.status
    assert sol.Iter == ref.Iter
    for f in ("y", "w", "v"):
        np.testing.assert_allclose(getattr(sol, f), np.asarray(getattr(ref, f)),
                                   rtol=0, atol=1e-6, equal_nan=True,
                                   err_msg=f)
    if ref.status == "Optimal":
        for s in (ref, sol):
            assert max(s.prFeas, s.duFeas, s.muFeas) < opt_tol


def schur_kw():
    return dict(jax_kw=dict(kktsolver=jax_schur),
                torch_kw=dict(kktsolver=torch_schur))


def box(n):
    H = 0.5 * np.eye(n)
    c = np.arange(1.0, n + 1)
    A = np.vstack([np.eye(n), -np.eye(n)])
    return H, H @ c, A, -np.ones(2 * n), [("R", 2 * n)]


def simplex(H):
    n = H.shape[0]
    c = np.arange(1.0, n + 1)
    return (H, H @ c, np.eye(n), np.zeros(n), [("R", n)], np.ones((1, n)),
            np.array([1.0]))


def rank1(rng, n=10, reg=1e-8):
    h = rng.standard_normal(n)
    return np.outer(h, h) + reg * np.eye(n)


def instance(name):
    """The tests/test_ipm_r.py instances (rng fixture: default_rng(0))."""
    rng = np.random.default_rng(0)
    n = 10
    c = np.arange(1.0, n + 1)
    if name == "box":
        return box(100), {}
    if name == "simplex":
        return simplex(np.eye(n)), {}
    if name == "simplex_dense_h":
        return simplex(rank1(rng)), {}
    if name == "abandoned":
        return simplex(np.eye(n)), dict(maxIters=2)
    if name == "infeasible":
        H = rank1(rng, reg=0.0)
        A = np.vstack([np.eye(n), -np.eye(n)])
        return (H, H @ c, A, np.ones(2 * n), [("R", 2 * n)]), {}
    if name == "infeasible_equalities":
        H = rank1(rng, reg=0.0)
        G = np.zeros((1, n))
        G[0, 0] = 1.0
        return (H, H @ c, np.eye(n), np.zeros(n), [("R", n)], G,
                np.array([-1.0])), {}
    if name == "unbounded":
        return (np.zeros((n, n)), c, np.eye(n), np.zeros(n), [("R", n)]), {}
    raise KeyError(name)


EXPECT = {
    "box": "Optimal",
    "simplex": "Optimal",
    "simplex_dense_h": "Optimal",
    "abandoned": "Abandoned",
    "infeasible": "Infeasible",
    "infeasible_equalities": "Infeasible",
    "unbounded": "Unbounded",
}


@pytest.mark.parametrize("name", list(EXPECT))
def test_schur_instances_match_jax(name):
    args, kw = instance(name)
    ref, sol = both(*args, optTol=OPT_TOL, **kw, **schur_kw())
    assert ref.status == EXPECT[name]
    assert_same(ref, sol, OPT_TOL)


def test_custom_pivot_plugin_matches_jax():
    # A problem-specific diagonal 2x2 solver that reads F.r_d, written once
    # per package: the callback contract is the same on tensors.
    n = 200
    H, c, A, b, cones = box(n)

    def make(diag):
        def kktsolver_2x2_box(Q, A_, G, spec):
            Hd = diag(Q)

            def solve2x2gen(F, FinvT):
                vinv = 1.0 / (F.r_d * F.r_d)
                invHD = 1.0 / (Hd + vinv[:n] + vinv[n:])

                def solve2x2(rhs, rhs2):
                    return invHD * rhs, rhs2[:0]

                return solve2x2

            return solve2x2gen

        return kktsolver_2x2_box

    ref, sol = both(H, c, A, b, cones, optTol=OPT_TOL,
                    jax_kw=dict(kktsolver=jax_pivot(make(jnp.diag))),
                    torch_kw=dict(kktsolver=torch_pivot(make(torch.diagonal))))
    assert ref.status == "Optimal"
    assert_same(ref, sol, OPT_TOL)


def test_box_qp_dense_auto_schur_matches_jax():
    # dense Q: the auto backend is the Schur solver with 1 Gondzio corrector
    ref, sol = both(*box_qp_dense(n=64, seed=42).args())
    assert ref.status == "Optimal"
    assert_same(ref, sol, 1e-6)


@pytest.mark.parametrize("eq", ["none", "disjoint", "woodbury"])
def test_readme_box_qp_auto_diag_matches_jax(eq):
    # the README quick start at n=100 is separable: the auto backend is the
    # diagonal solver, in each equality mode
    H, c, A, b, cones = box(100)
    G, d = {
        "none": (None, None),
        "disjoint": (np.eye(100)[:1], np.array([0.5])),
        "woodbury": (np.ones((1, 100)), np.array([1.0])),
    }[eq]
    ref, sol = both(H, c, A, b, cones, G, d)
    assert ref.status == "Optimal"
    assert_same(ref, sol, 1e-6)


def test_box_qp_sparse_matches_jax():
    ref, sol = both(*box_qp_sparse(n=50, seed=1).args())
    assert_same(ref, sol, 1e-6)


def test_warm_start_across_packages():
    # warm starts carried both ways through interop solve the same thing
    P = box_qp_dense(n=40, seed=7)
    P2 = box_qp_dense(n=40, seed=8)
    first = ct.conic_ip(*P.args())
    warm_t = pt.warm_from_numpy(np.asarray(first.y), np.asarray(first.w),
                                np.asarray(first.v), device="cpu")
    ref = ct.conic_ip(*P2.args(), warm_start=first)
    sol = pt.solution_to_numpy(
        pt.conic_ip(*P2.args(), warm_start=warm_t, device="cpu"))
    assert ref.status == "Optimal"
    assert_same(ref, sol, 1e-6)

    first_t = pt.conic_ip(*P.args(), device="cpu")
    ref2 = ct.conic_ip(*P2.args(), warm_start=pt.warm_to_numpy(first_t))
    sol2 = pt.solution_to_numpy(
        pt.conic_ip(*P2.args(), warm_start=first_t, device="cpu"))
    assert_same(ref2, sol2, 1e-6)
    assert ref2.Iter == ref.Iter

    # non-finite warm data falls back to a cold start in both
    bad = (np.full(40, np.nan), None, np.asarray(first.v))
    assert_same(ct.conic_ip(*P2.args(), warm_start=bad),
                pt.solution_to_numpy(pt.conic_ip(*P2.args(), warm_start=bad,
                                                 device="cpu")), 1e-6)


def test_problem_from_numpy_round_trip():
    P = box_qp_dense(n=20, seed=3)
    args = pt.problem_from_numpy(*P.args(), device="cpu")
    assert all(a is None or isinstance(a, (torch.Tensor, list)) for a in args)
    sol = pt.conic_ip(*args, device="cpu")
    ref = pt.conic_ip(*P.args(), device="cpu")
    assert (sol.status, sol.Iter, sol.pobj) == (ref.status, ref.Iter, ref.pobj)


def test_not_ported_options_raise():
    """No option of the reference is left unported: the ones that used to
    raise now solve, to the reference's status and iterate."""
    H, c, A, b, cones = box(5)
    for kw, jkw in ((dict(factor_dtype=torch.float32),
                     dict(factor_dtype=jnp.float32)),
                    (dict(mixedResiduals=True),) * 2,
                    (dict(eliminateEqualities=True),) * 2):
        ref = ct.conic_ip(H, c, A, b, cones, **jkw)
        sol = pt.solution_to_numpy(
            pt.conic_ip(H, c, A, b, cones, device="cpu", **kw))
        assert_same(ref, sol, 1e-6)


def test_bad_input():
    n = 10
    with pytest.raises(ValueError):
        pt.conic_ip(np.zeros((n, n)), np.arange(1.0, n + 1), np.eye(n + 2),
                    np.zeros(n), [("R", n)], device="cpu")


def test_verbose_prints_table(capsys):
    args, _ = instance("simplex")
    pt.conic_ip(*args, verbose=True, device="cpu")
    out = capsys.readouterr().out
    assert "INTERIOR POINT SOLVER" in out and "Below Tolerance" in out


@pytest.mark.parametrize("cutoff", [0, 2])
def test_ipm_solve_stall_cutoff_matches_jax(cutoff):
    # stallCutoff is an ipm_solve option (conic_ip does not expose it):
    # both packages must end Abandoned, or not, at the same iterate
    from conicip_tpu.solver.ipm import IPMOptions as JaxOptions
    from conicip_tpu.solver.ipm import ipm_solve as jax_ipm_solve
    from conicip_tpu.cones import ConeSpec as JaxSpec
    from conicip_tpu_torch.cones import ConeSpec
    from conicip_tpu_torch.solver.ipm import IPMOptions, ipm_solve

    H, c, A, b, cones, G, d = simplex(np.eye(10))
    ref = ct.Solution.from_state(jax_ipm_solve(
        *(jnp.asarray(x) for x in (H, c, A, b, G, d)), JaxSpec(cones),
        jax_schur, JaxOptions(optTol=1e-9, stallCutoff=cutoff)))
    st = ipm_solve(*(torch.from_numpy(x.copy()) for x in (H, c, A, b, G, d)),
                   ConeSpec(cones), torch_schur,
                   IPMOptions(optTol=1e-9, stallCutoff=cutoff))
    sol = pt.solution_to_numpy(pt.Solution.from_state(st))
    if cutoff == 0:
        assert ref.status == "Abandoned"
    assert_same(ref, sol, 1e-9)


def test_port_imports_neither_jax_nor_the_jax_package():
    """In a fresh interpreter, importing the port and every module of it
    loads neither ``jax`` nor ``conicip_tpu``."""
    import os
    import subprocess
    import sys

    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    code = (
        "import importlib, pkgutil, sys\n"
        "import conicip_tpu_torch as pt\n"
        "for m in pkgutil.walk_packages(pt.__path__, 'conicip_tpu_torch.'):\n"
        "    importlib.import_module(m.name)\n"
        "import conicip_tpu_torch.parallel as par\n"
        "for name in ('solve_batch', 'solve_batch_resumable', 'load_snapshot',\n"
        "             'SnapshotInfo', 'BatchSolution', 'make_batched_solver',\n"
        "             'make_batched_warm_solver'):\n"
        "    assert name in par.__all__ and hasattr(par, name), name\n"
        "for mod in ('parallel.batch', 'parallel.checkpoint'):\n"
        "    assert 'conicip_tpu_torch.' + mod in sys.modules, mod\n"
        "bad = [m for m in sys.modules if m == 'jax' or m.startswith('jax.')\n"
        "       or m == 'conicip_tpu' or m.startswith('conicip_tpu.')]\n"
        "assert not bad, bad\n"
        "print(len([m for m in sys.modules if m.startswith('conicip_tpu_torch')]))\n"
    )
    out = subprocess.run([sys.executable, "-c", code], cwd=root, timeout=120,
                         capture_output=True, text=True)
    assert out.returncode == 0, out.stderr
    assert int(out.stdout) > 20


def test_conic_ip_takes_the_reference_keywords():
    """Same keyword list and defaults as ``conicip_tpu.conic_ip`` (the port
    adds ``device``), and the reference's public names exist."""
    import inspect

    ref = inspect.signature(ct.conic_ip).parameters
    mine = inspect.signature(pt.conic_ip).parameters
    assert list(mine)[:len(ref)] == list(ref)
    assert list(mine)[len(ref):] == ["device"]
    for name, par in ref.items():
        assert mine[name].default == par.default, name
        assert mine[name].kind == par.kind, name
    for name in ("preprocess_conic_ip", "imcols", "kktsolver_qr",
                 "kktsolver_lu", "IPMOptions"):
        assert callable(getattr(pt, name)) and callable(getattr(ct, name))
    assert callable(pt.solver.resolve_factor_dtype)
    fields = lambda cls: {f.name: f.default  # noqa: E731
                          for f in cls.__dataclass_fields__.values()}
    assert fields(pt.IPMOptions) == fields(ct.IPMOptions)
    # the batched entry points: the reference's parameters in its order,
    # with its kinds and defaults (``mesh`` carries a JAX annotation there)
    import conicip_tpu.parallel as ct_par
    import conicip_tpu_torch.parallel as pt_par

    for name in ("solve_batch", "solve_batch_resumable"):
        ref = inspect.signature(getattr(ct_par, name)).parameters
        mine = inspect.signature(getattr(pt_par, name)).parameters
        assert [k for k in mine if k != "device"] == list(ref), name
        for key, par in ref.items():
            assert mine[key].kind == par.kind, (name, key)
            assert mine[key].default == par.default, (name, key)
    assert pt.solve_batch is pt_par.solve_batch
