"""A caller's kktsolver on the device loop, on the CPU.

The reference traces whatever kktsolver ``conic_ip`` is given into one
compiled program (``_solve_jit``), and its ``kktsolver_schur_tp`` retries a
failed factor with ``lax.cond``. In the port the package's own kktsolvers,
passed by hand, and ``kktsolver_schur_tp`` take the device loop
(``ipm.run_chunks`` here; captured CUDA graphs on the card), the retry
being ``control.cond``. These tests hold

- ``kktsolver_schur_tp`` over the in-process gloo world of one, on its
  three factor routes, to the eager loop on the same operands (y bit for
  bit, status, ``Iter``, KKT builds, refinement trips) and to the
  reference's ``conicip_tpu.parallel.kktsolver_schur_tp`` on a JAX mesh of
  one CPU device (status and ``Iter`` exact, y to 1e-8);
- a KKT build whose first factor is not finite: ``control.cond`` runs the
  retry masked and on the host with the same W, dscale, Y, and a whole
  solve that retries every build gives the eager loop's bits;
- each of the package's backends passed by hand on the device loop, equal
  to its eager solve; a caller's own callable, and the TP solver over gloo
  on CUDA tensors, keep the eager loop, each for its reason;
- two spawned ranks (``parallel.mesh.spawn_world``) agreeing bit for bit.

Run as a script, this file is one rank of that world.
"""

import argparse
import contextlib
import functools
import os
import sys
import tempfile
from pathlib import Path

import numpy as np
import pytest
import torch

import conicip_tpu_torch as pt
from conicip_tpu_torch import models
from conicip_tpu_torch.cones.spec import ConeSpec
from conicip_tpu_torch.ops import control
from conicip_tpu_torch.parallel import distributed
from conicip_tpu_torch.solver import graph, ipm
from conicip_tpu_torch.solver import runs as solver_runs
from conicip_tpu_torch.solver.state import Solution, Status
from test_torch_distributed import TP_SPECS, tp_problem as tp_data

torch.set_num_threads(1)

REPO = Path(__file__).resolve().parents[1]
ROUTES = {"default": {}, "shard_scaling=False": dict(shard_scaling=False),
          "distributed_factor=False": dict(distributed_factor=False)}


def tp_problem(cones=TP_SPECS["rqs_eq"][0], p=TP_SPECS["rqs_eq"][1], n=19):
    """The reference's TP test problem (tests/test_parallel.py) as
    ``conic_ip``'s arguments; by default every cone kind and equalities."""
    Q, c, A, b, G, d = tp_data(n, cones, p)
    return Q, c, A, b, cones, G, d


def with_indefinite_block(Q, c, A, b, cones, G, d, delta=1e-12):
    """Two free variables whose 2x2 block of Q has the eigenvalue -delta:
    beyond the distributed factor's base ridge, within its retry's, so
    every KKT build's first factor fails. Their gradient is 0."""
    n = Q.shape[0]
    Q2 = np.zeros((n + 2, n + 2))
    Q2[:n, :n] = Q
    Q2[n:, n:] = [[1.0, 1.0 + delta], [1.0 + delta, 1.0]]
    return (Q2, np.r_[c, 0.0, 0.0], np.hstack([A, np.zeros((A.shape[0], 2))]),
            b, cones, np.hstack([G, np.zeros((G.shape[0], 2))]), d)


@pytest.fixture(scope="module")
def mesh(tmp_path_factory):
    import torch.distributed as dist

    from conicip_tpu_torch.parallel.mesh import start_rank

    init = "file://" + str(tmp_path_factory.mktemp("one") / "rendezvous")
    start_rank(0, 1, init, "cpu", timeout=60)
    yield pt.make_mesh((1,), ("tp",), device_type="cpu")
    dist.destroy_process_group()


def both_loops(args, kktsolver, **kw):
    """conic_ip on the device loop, and the eager loop (ipm_solve without
    a device loop) on the operands conic_ip handed graph.solve: the two
    solutions and runs."""
    real, seen = graph.solve, {}

    def spy(*a, **k):
        seen["call"] = (a, k)
        return real(*a, **k)

    graph.solve = spy
    try:
        sol = pt.conic_ip(*args, kktsolver=kktsolver, device="cpu", **kw)
    finally:
        graph.solve = real
    (run,) = solver_runs
    a, k = seen["call"]
    est = {}
    eager = Solution.from_state(ipm.ipm_solve(*a, warm=k["warm"], stats=est))
    return sol, run, eager, est


@pytest.fixture
def factor_calls(monkeypatch):
    """The distributed factor's calls, by ridge (one per KKT build, two
    where the retry ran)."""
    calls = []
    real = distributed._factor_body

    def spy(ax, M_blk, G_pad, ridge, n_pad, p):
        out = real(ax, M_blk, G_pad, ridge, n_pad, p)
        calls.append(float(ridge))
        return out

    monkeypatch.setattr(distributed, "_factor_body", spy)
    return calls


def assert_same_solve(sol, run, eager, est):
    assert run.loop == "chunks" and est["loop"] == "eager"
    assert (sol.status, sol.Iter) == (eager.status, eager.Iter)
    assert torch.equal(sol.y, eager.y) and torch.equal(sol.v, eager.v)
    assert run.trips == est["trips"]


@functools.lru_cache(maxsize=None)
def reference(route):
    """The reference's kktsolver_schur_tp on a JAX mesh of one CPU
    device."""
    import jax

    import conicip_tpu as ct
    from conicip_tpu.parallel import kktsolver_schur_tp, make_mesh

    Q, c, A, b, cones, G, d = tp_problem()
    jmesh = make_mesh((1,), ("tp",), devices=jax.devices()[:1])
    sol = ct.conic_ip(Q, c, A, b, cones, G=G, d=d, optTol=1e-7,
                      kktsolver=kktsolver_schur_tp(jmesh, "tp",
                                                   **ROUTES[route]))
    return sol.status, int(sol.Iter), np.asarray(sol.y)


@pytest.mark.parametrize("route", list(ROUTES))
def test_tp_device_loop_equals_the_eager_loop_and_the_reference(
        mesh, route, factor_calls):
    kkt = pt.kktsolver_schur_tp(mesh, "tp", **ROUTES[route])
    Q, c, A, b, cones, G, d = tp_problem()
    sol, run, eager, est = both_loops((Q, c, A, b, cones, G, d), kkt,
                                      optTol=1e-7)
    assert_same_solve(sol, run, eager, est)
    # KKT builds: the device loop's cold start and one per unit, as many
    # as the eager loop's; each factors once on the eager loop, and twice
    # on the device loop, whose retry runs masked
    builds = run.cold_start + ipm.POLL * (run.polls - 1)
    assert builds == est["cold_start"] + est["fast_steps"]
    if route == "distributed_factor=False":
        assert factor_calls == []  # the whole factor, predicated retry
    else:
        assert len(factor_calls) == 2 * builds + builds
    status, iters, y = reference(route)
    assert (sol.status, sol.Iter) == (status, iters)
    np.testing.assert_allclose(sol.y.numpy(), y, rtol=0, atol=1e-8)


def indefinite(n, delta):
    """``ones - delta·I``: unit diagonal, the eigenvalue -delta n - 1
    times."""
    return torch.ones(n, n, dtype=torch.float64) - delta * torch.eye(
        n, dtype=torch.float64)


@pytest.mark.parametrize("loop", ["masked", "on_host"])
@pytest.mark.parametrize("delta", [1e-12, -1.0])
def test_a_failed_first_factor_takes_the_retry(mesh, loop, delta):
    # delta = 1e-12: not finite at the base ridge, finite at the retry's;
    # delta = -1: ones + I, finite at once
    from conicip_tpu_torch.parallel.mesh import MeshAxis

    ax = MeshAxis(mesh, "tp")
    n, p = 8, 2
    M = indefinite(n, delta)
    G = torch.from_numpy(np.random.default_rng(0).standard_normal((p, n)))
    ridge0 = 30.0 * torch.finfo(torch.float64).eps
    first = distributed._factor_body(ax, M, G, ridge0, n, p)
    retry = distributed._factor_body(ax, M, G, 1e5 * ridge0, n, p)
    failed = delta > 0
    assert bool(first[3]) is not failed and bool(retry[3])
    with control.bound(getattr(ipm, loop)):
        got = distributed._factor_retried(ax, M, G, ridge0, n, p)
    want = retry[:3] if failed else first[:3]
    assert all(torch.equal(g, w) for g, w in zip(got, want))


def test_cond_merges_by_its_predicate():
    old = (torch.zeros(3), torch.ones(()))
    new = (torch.full((3,), 2.0), torch.full((), 5.0))
    ran = []

    def body():
        ran.append(1)
        return new

    for pred, want in ((torch.tensor(True), new), (torch.tensor(False), old)):
        for branch in (ipm.masked, ipm.on_host, None):
            with (control.bound(branch) if branch else
                  contextlib.nullcontext()):
                got = control.cond(pred, body, old)
            assert all(torch.equal(g, w) for g, w in zip(got, want))
    # masked runs the body always; on the host (bound, or unbound) only
    # where the predicate holds
    assert len(ran) == 3 + 1


@pytest.mark.parametrize("route", ["default", "distributed_factor=False"])
def test_a_solve_that_retries_every_build_equals_the_eager_loop(
        mesh, route, factor_calls):
    kkt = pt.kktsolver_schur_tp(mesh, "tp", **ROUTES[route])
    args = with_indefinite_block(*tp_problem())
    sol, run, eager, est = both_loops(args, kkt, optTol=1e-7)
    assert_same_solve(sol, run, eager, est)
    assert sol.status == "Optimal" and bool((sol.y[-2:] == 0).all())
    if route == "default":
        builds = run.cold_start + ipm.POLL * (run.polls - 1)
        # on each loop every build's first factor fails and retries
        assert factor_calls.count(30.0 * np.finfo(float).eps) == 2 * builds
        assert len(factor_calls) == 4 * builds
    # the reference's answer on the problem without the block
    status, iters, y = reference("default")
    assert sol.status == status
    np.testing.assert_allclose(sol.y[:-2].numpy(), y, rtol=0, atol=1e-6)


def backend_cases():
    """(name, kktsolver, problem args) of the package's backends passed by
    hand, each on a problem it applies to."""
    from conicip_tpu_torch.kkt import (kktsolver_diag, kktsolver_lu,
                                       kktsolver_qr, kktsolver_schur)
    from conicip_tpu_torch.kkt.lowrank import lowrank_kktsolver
    from conicip_tpu_torch.kkt.spectral import spectral_kktsolver

    rng = np.random.default_rng(3)
    n = 12
    box = (np.diag(1.0 + rng.random(n)), rng.standard_normal(n),
           np.vstack([np.eye(n), -np.eye(n)]), -np.ones(2 * n),
           [("R", 2 * n)])
    rq = tp_problem([("R", 10), ("Q", 5)], 2, n=10)
    Q, c, A, b, cones, G, d = models.batched_mixed_rq_eq(1, n=20, n_q=6, p=2)
    low = (Q[0], c[0], A[0], b[0], cones, G, d[0])
    return {
        "schur": (kktsolver_schur, box),
        "schur partial": (functools.partial(kktsolver_schur,
                                            factor_dtype=torch.float64), rq),
        "diag": (kktsolver_diag, box),
        "qr": (kktsolver_qr, rq),
        "lu": (functools.partial(kktsolver_lu, factor_dtype=None), rq),
        "spectral": (spectral_kktsolver(None),
                     models.small_sdp(k=3).args()[:5]),
        "lowrank": (lowrank_kktsolver(), low),
    }


@pytest.mark.parametrize("name", list(backend_cases()))
def test_the_packages_backends_passed_by_hand_take_the_device_loop(name):
    kkt, args = backend_cases()[name]
    assert pt.solver._eager_reason(kkt, ipm.IPMOptions(), "cpu") is None
    sol, run, eager, est = both_loops(args, kkt)
    assert_same_solve(sol, run, eager, est)
    assert sol.status == "Optimal"


def test_a_callers_own_callable_and_gloo_on_cuda_keep_the_eager_loop(mesh):
    from conicip_tpu_torch.kkt import kktsolver_schur

    def mine(Q, A, G, spec):
        return kktsolver_schur(Q, A, G, spec)

    args = tp_problem()
    sol = pt.conic_ip(*args, kktsolver=mine, device="cpu", optTol=1e-7)
    (run,) = solver_runs
    assert run.loop == "eager" and sol.status == "Optimal"
    opts = ipm.IPMOptions()
    assert "caller's own" in pt.solver._eager_reason(mine, opts, "cpu")
    assert "verbose" in pt.solver._eager_reason(
        kktsolver_schur, ipm.IPMOptions(verbose=True), "cpu")
    # the world of one runs over gloo: on the CPU the device loop takes it,
    # on CUDA tensors gloo's staging through host memory keeps it eager
    tp = pt.kktsolver_schur_tp(mesh, "tp")
    assert pt.solver._eager_reason(tp, opts, "cpu") is None
    assert "gloo" in pt.solver._eager_reason(tp, opts, "cuda")


def test_the_public_batched_solvers_take_the_device_loop():
    from conicip_tpu_torch.kkt import kktsolver_qr
    from conicip_tpu_torch.parallel import batch as pbatch

    Q, c, A, b, cones, G, d = models.batched_mixed_rq_eq(3, n=20, n_q=6,
                                                         p=2)
    T = lambda x: torch.as_tensor(x, dtype=torch.float64)  # noqa: E731
    ops = [T(x) for x in (Q, c, A, b, G, d)]
    solve = pbatch.make_batched_solver(ConeSpec(cones), kktsolver_qr,
                                       ipm.IPMOptions(), batch_G=False)
    st = solve(*ops)
    run = pbatch.runs[-1]
    assert run.loop == "chunks" and st.status.tolist() == [Status.OPTIMAL] * 3
    eager = ipm.ipm_solve(ops[0], ops[1], ops[2], ops[3], ops[4], ops[5],
                          ConeSpec(cones), kktsolver_qr, ipm.IPMOptions())
    assert torch.equal(st.y, eager.y) and torch.equal(st.Iter, eager.Iter)


# ── two spawned ranks ──


def rank_main(rank, init, out):
    """One rank of the spawned world: the TP solve on the device loop and
    on the eager loop, saved to ``out/rank<k>.pt``."""
    import torch.distributed as dist

    from conicip_tpu_torch.parallel.mesh import start_rank

    start_rank(rank, 2, init, "cpu", timeout=60)
    try:
        tp = pt.make_mesh((2,), ("tp",), device_type="cpu")
        kkt = pt.kktsolver_schur_tp(tp, "tp")
        sol, run, eager, est = both_loops(tp_problem(), kkt, optTol=1e-7)
        torch.save(dict(y=sol.y, eager_y=eager.y, status=sol.status,
                        Iter=sol.Iter, loop=run.loop, eager_loop=est["loop"]),
                   os.path.join(out, f"rank{rank}.pt"))
    finally:
        dist.destroy_process_group()


def test_two_spawned_ranks_agree_bit_for_bit():
    from conicip_tpu_torch.parallel.mesh import spawn_world

    env = dict(os.environ)
    env["PYTHONPATH"] = os.pathsep.join(
        [str(REPO)] + [p for p in [env.get("PYTHONPATH")] if p])
    with tempfile.TemporaryDirectory() as out:
        world = spawn_world(
            lambda k, init: [sys.executable, __file__, "--rank", str(k),
                             "--init", init, "--out", out], 2, 120.0, env=env)
        assert world.ok, "\n".join(world.err)
        got = [torch.load(os.path.join(out, f"rank{k}.pt"))
               for k in range(2)]
    a, b = got
    assert (a["loop"], a["eager_loop"]) == ("chunks", "eager")
    assert a["status"] == b["status"] == "Optimal" and a["Iter"] == b["Iter"]
    assert torch.equal(a["y"], b["y"]) and torch.equal(a["y"], a["eager_y"])
    assert torch.equal(b["y"], b["eager_y"])
    status, iters, y = reference("default")
    assert (a["status"], a["Iter"]) == (status, iters)
    np.testing.assert_allclose(a["y"].numpy(), y, rtol=0, atol=1e-8)


if __name__ == "__main__":
    parser = argparse.ArgumentParser()
    parser.add_argument("--rank", type=int, required=True)
    parser.add_argument("--init", required=True)
    parser.add_argument("--out", required=True)
    a = parser.parse_args()
    torch.set_num_threads(1)
    rank_main(a.rank, a.init, a.out)
