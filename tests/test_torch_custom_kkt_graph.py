"""A caller's own kktsolver and verbose output on the device loop, on the CPU.

The reference's ``_solve_jit`` traces whatever kktsolver it is given into
one compiled loop and prints its verbose rows from inside it. The port runs
a caller's callable on the device loop too (on CUDA captured graphs; here
the same chunks run eagerly, ``ipm.run_chunks``), and prints the eager
loop's verbose text from the device loop's polls. These tests hold

- ``examples/torch/custom_kkt.py``'s box 2x2 solver against
  ``examples/custom_kkt.py``'s JAX solver on the same seeded instance,
  through ``conic_ip`` and the batched entry points (same status and
  ``Iter``, y/w/v within 1e-6);
- a caller's dense Schur solver on ``ops.cholesky`` / ``ops.cho_solve``
  through ``solve_batch`` against the same solver written on the JAX
  package's ops;
- a callable that reads the device (it still solves here);
- the device loop's verbose text against the eager loop's;
- the guard that finds a read before a capture (its mechanics, with
  PyTorch's sync debug mode stood in for), the eager loop it sends a run
  to, and the cases that still keep the eager loop.
"""

import ast
import contextlib
import io
import pathlib

import numpy as np
import pytest
import torch

import conicip_tpu as ct
import conicip_tpu.ops as ct_ops
import conicip_tpu.parallel as ct_parallel
from conicip_tpu.solver.state import Vec4 as JaxVec4
import conicip_tpu_torch as pt
from conicip_tpu_torch import models
from conicip_tpu_torch import ops as pt_ops
from conicip_tpu_torch import solver as pt_solver
from conicip_tpu_torch import trace
from conicip_tpu_torch.cones.spec import ConeSpec
from conicip_tpu_torch.ops import control
from conicip_tpu_torch.parallel import batch as pt_batch
from conicip_tpu_torch.solver import _default_kktsolver, graph, ipm
from conicip_tpu_torch.solver.state import Vec4
from test_torch_ipm import assert_same

torch.set_num_threads(1)

# the tolerance of tests/test_torch_graph.py's parity tests
OPT_TOL = 1e-6
ROOT = pathlib.Path(__file__).parent.parent
N = 40


def port_example_box():
    """``examples/torch/custom_kkt.py``'s solver, made once by the example
    (the loader ``python -m conicip_tpu_torch.trace --kkt custom`` uses)."""
    return trace.example_box_kktsolver()


def jax_example_box(n):
    """``examples/custom_kkt.py``'s ``box_kktsolver_2x2`` (which reads the
    module's ``n``) at order ``n``, under ``conicip_tpu.pivot``; the
    example's own solves at n = 300 are not run."""
    path = ROOT / "examples" / "custom_kkt.py"
    tree = ast.parse(path.read_text())
    fn = next(node for node in tree.body if isinstance(node, ast.FunctionDef)
              and node.name == "box_kktsolver_2x2")
    ns = {"n": n}
    exec(compile(ast.Module([fn], []), str(path), "exec"), ns)
    return ct.pivot(ns["box_kktsolver_2x2"])


def box_instance(n=N, seed=3):
    """A box QP with diagonal Q (the examples' structure), from a seed."""
    rng = np.random.default_rng(seed)
    Q = np.diag(1.0 + rng.random(n))
    c = rng.standard_normal(n)
    A = np.vstack([np.eye(n), -np.eye(n)])
    return Q, c, A, -np.ones(2 * n), [("R", 2 * n)]


def box_stack(B=3, n=N):
    """B box instances stacked, (Q, c, A, b, cones)."""
    parts = [box_instance(n, seed) for seed in range(B)]
    return tuple(np.stack([p[i] for p in parts]) for i in range(4)) + (
        parts[0][4],)


def dense_schur_2x2_torch(Q, A, G, spec):
    """A caller's dense Schur 2x2 solver (R cones, no equalities) on the
    port's public ops."""
    def gen(F, FinvT):
        winv = 1.0 / (F.r_d * F.r_d)
        L = pt_ops.cholesky(Q + A.mT @ (winv[..., :, None] * A))
        return lambda by, bw: (pt_ops.cho_solve(L, by), bw)
    return gen


def dense_schur_2x2_jax(Q, A, G, spec):
    """The same solver on the JAX package's public ops."""
    def gen(F, FinvT):
        winv = 1.0 / (F.r_d * F.r_d)
        L = ct_ops.cholesky(Q + A.T @ (winv[:, None] * A))
        return lambda by, bw: (ct_ops.cho_solve(L, by), bw)
    return gen


def eager_loop(monkeypatch):
    """Send every run of conic_ip and solve_batch to the eager loop."""
    def rule(*args):
        return "the eager loop, for comparison"
    monkeypatch.setattr(pt_solver, "_eager_reason", rule)
    monkeypatch.setattr(pt_batch, "_eager_reason", rule)


def stdout_of(fn):
    with contextlib.redirect_stdout(io.StringIO()) as out:
        fn()
    return out.getvalue()


# ── a caller's kktsolver, against the reference ──


def test_the_examples_box_solver_on_the_chunked_loop_matches_jax():
    args = box_instance()
    ref = ct.conic_ip(*args, kktsolver=jax_example_box(N))
    sol = pt.conic_ip(*args, kktsolver=port_example_box(), device="cpu")
    (run,) = pt_solver.runs
    assert run.loop == "chunks" and run.reason is None
    assert ref.status == "Optimal"
    assert_same(ref, pt.solution_to_numpy(sol), OPT_TOL)


@pytest.mark.parametrize("entry", ["solve_batch", "make_batched_solver",
                                   "make_batched_warm_solver"])
def test_the_box_solver_on_the_batched_entry_points(entry):
    # solve_batch against the reference's solve_batch on the example's
    # JAX solver; the public batched solvers against solve_batch's run
    Q, c, A, b, cones = stack = box_stack()
    mine = port_example_box()
    got = pt.solve_batch(*stack, kktsolver=mine, device="cpu")
    assert [(r.loop, r.reason) for r in pt_batch.runs] == [("chunks", None)]
    if entry == "solve_batch":
        ref = ct_parallel.solve_batch(*stack, kktsolver=jax_example_box(N))
        got = pt.batch_solution_to_numpy(got)
        assert got.statuses == list(ref.statuses) == ["Optimal"] * 3
        np.testing.assert_array_equal(got.Iter, np.asarray(ref.Iter))
        for f in ("y", "w", "v"):
            np.testing.assert_allclose(getattr(got, f),
                                       np.asarray(getattr(ref, f)),
                                       rtol=0, atol=1e-6, err_msg=f)
        return
    # the public solvers on solve_batch's operands
    t = [torch.from_numpy(x) for x in (Q, c, A, b)]
    G, d = torch.zeros(3, 0, N, dtype=torch.float64), torch.zeros(
        3, 0, dtype=torch.float64)
    options = ipm.IPMOptions()
    if entry == "make_batched_solver":
        st = pt_batch.make_batched_solver(ConeSpec(cones), mine, options)(
            *t, G, d)
    else:
        # from one warm iterate, against the reference's warm solver
        y0, w0, v0 = np.zeros((3, N)), np.zeros((3, 0)), np.ones((3, 2 * N))
        s0 = np.einsum("bmn,bn->bm", A, y0) - b
        got = ct_parallel.make_batched_warm_solver(
            ct.ConeSpec(cones), jax_example_box(N), ct.IPMOptions())(
            Q, c, A, b, np.zeros((3, 0, N)), np.zeros((3, 0)),
            JaxVec4(y0, w0, v0, s0))
        st = pt_batch.make_batched_warm_solver(ConeSpec(cones), mine,
                                               options)(
            *t, G, d, Vec4(*(torch.from_numpy(x) for x in (y0, w0, v0, s0))))
    run = pt_batch.runs[-1]
    assert len(pt_batch.runs) == 2 and run.kktsolver is mine
    assert run.loop == "chunks" and run.reason is None
    np.testing.assert_array_equal(st.status, np.asarray(got.status))
    np.testing.assert_array_equal(st.Iter, np.asarray(got.Iter))
    np.testing.assert_allclose(st.y, np.asarray(got.y), rtol=0, atol=1e-6)


def test_a_dense_callers_solver_on_ops_cholesky_through_solve_batch(
        monkeypatch):
    stack = models.batched_box_qp(3, n=12, seed=5)
    kkt = pt.pivot(dense_schur_2x2_torch)
    got = pt.solve_batch(*stack, kktsolver=kkt, device="cpu")
    assert [(r.kktsolver, r.loop) for r in pt_batch.runs] == [
        (kkt, "chunks")]
    ref = ct_parallel.solve_batch(*stack,
                                  kktsolver=ct.pivot(dense_schur_2x2_jax))
    mine = pt.batch_solution_to_numpy(got)
    assert mine.statuses == list(ref.statuses) == ["Optimal"] * 3
    np.testing.assert_array_equal(mine.Iter, np.asarray(ref.Iter))
    np.testing.assert_allclose(mine.y, np.asarray(ref.y), rtol=0, atol=1e-6)
    # the eager loop on the same stack: the same bits
    eager_loop(monkeypatch)
    eager = pt.solve_batch(*stack, kktsolver=kkt, device="cpu")
    assert pt_batch.runs[0].loop == "eager"
    assert torch.equal(eager.y, got.y) and torch.equal(eager.Iter, got.Iter)


def test_a_callable_that_reads_the_device_still_solves_on_the_cpu():
    def reads(Q, A, G, spec):
        gen = dense_schur_2x2_torch(Q, A, G, spec)

        def solve3x3gen(F, FinvT):
            if F.r_d.min().item() <= 0:  # a host read in level 2
                raise AssertionError("not a scaling")
            return gen(F, FinvT)
        return solve3x3gen

    args = models.box_qp_dense(n=30).args()
    sol = pt.conic_ip(*args, kktsolver=pt.pivot(reads), device="cpu")
    (run,) = pt_solver.runs
    clean = pt.conic_ip(*args, kktsolver=pt.pivot(dense_schur_2x2_torch),
                        device="cpu")
    assert run.loop == "chunks" and sol.status == "Optimal"
    assert sol.Iter == clean.Iter and torch.equal(sol.y, clean.y)


# ── verbose output ──


VERBOSE = {
    "schur": (lambda: models.box_qp_dense(n=30).args(), {}),
    "f32 last-mile, mixed": (lambda: models.box_qp_dense(n=40).args(),
                             dict(factor_dtype=torch.float32)),
    "maxIters": (lambda: models.box_qp_dense(n=30).args(), dict(maxIters=4)),
    "caller's box solver": (lambda: box_instance(n=20) + (None, None),
                            dict(kktsolver="example")),
}


@pytest.mark.parametrize("poll", [1, 3])
@pytest.mark.parametrize("case", list(VERBOSE))
def test_verbose_output_from_the_device_loop_is_the_eager_loops(
        case, poll, monkeypatch):
    monkeypatch.setattr(ipm, "POLL", poll)
    make, kw = VERBOSE[case]
    if kw.get("kktsolver") == "example":
        kw = dict(kw, kktsolver=port_example_box())
    args = make()
    device = stdout_of(lambda: pt.conic_ip(*args, device="cpu", verbose=True,
                                           **kw))
    assert {r.loop for r in pt_solver.runs} == {"chunks"}
    eager_loop(monkeypatch)
    eager = stdout_of(lambda: pt.conic_ip(*args, device="cpu", verbose=True,
                                          **kw))
    assert {r.loop for r in pt_solver.runs} == {"eager"}
    # every run's rows numbered from 1, none missing or repeated
    ks = [int(ln.split("│")[0].split()[-1]) for ln in eager.splitlines()
          if ln.count("│") == 4 and "Iter" not in ln]
    starts = [i for i, k in enumerate(ks) if k == 1] + [len(ks)]
    assert len(starts) - 1 == len(pt_solver.runs)
    for a, b in zip(starts, starts[1:]):
        assert ks[a:b] == list(range(1, b - a + 1))
    assert device == eager


# ── the guard, and the eager loop it sends a run to ──


@pytest.fixture
def sync_debug_mode(monkeypatch):
    """PyTorch's sync debug mode stood in for (this CPU build has none):
    the modes set, in order."""
    modes = [0]
    monkeypatch.setattr(torch.cuda, "get_sync_debug_mode", lambda: modes[-1])
    monkeypatch.setattr(torch.cuda, "set_sync_debug_mode", modes.append)
    return modes


def test_the_guard_names_the_read_and_remembers_the_callable(
        sync_debug_mode):
    modes = sync_debug_mode

    def reads(Q, A, G, spec):
        def solve3x3gen(F, FinvT):
            def solve3x3(x, y, z):
                if modes[-1] == "error":  # what .item() raises in this mode
                    raise RuntimeError("called a synchronizing CUDA "
                                       "operation")
                return x, y, z
            return solve3x3
        return solve3x3gen

    guarded = control.guarded(reads)
    gen = guarded(None, None, None, None)
    solve = gen(None, None)
    assert modes == [0, "error", 0, "error", 0]
    host = modes[-1]  # between the calls the loop's own reads are free
    assert host == 0
    with pytest.raises(control.ReadsDevice) as err:
        solve(1, 2, 3)
    assert modes[-1] == 0
    assert 'raise RuntimeError("called a synchronizing' in err.value.reason
    assert "in solve3x3" in err.value.reason
    assert control.eager_reason(reads, "cuda") == err.value.reason
    assert pt_solver._eager_reason(reads, "cuda") == (
        err.value.reason)
    # on the CPU nothing is captured: the device loop takes it
    assert control.eager_reason(reads, "cpu") is None
    # another callable is not decided by it
    assert control.eager_reason(lambda *a: reads(*a), "cuda") is None
    # an error that is not a read passes through
    with pytest.raises(ValueError):
        control.guarded(lambda *a: (_ for _ in ()).throw(ValueError()))()


def test_the_guard_keeps_a_two_variant_generators_signature(sync_debug_mode):
    gen = control.guarded(pt.kktsolver_schur)
    two = control.guarded(pt.pivot(dense_schur_2x2_torch, lastmile=True,
                                   factor_dtype=torch.float32))
    from conicip_tpu_torch.kkt.pivot import accepts_mode

    Q, _, A, _, cones, _, _ = models.box_qp_dense(n=6).args()
    args = (torch.from_numpy(Q), torch.from_numpy(A),
            torch.zeros(0, 6, dtype=torch.float64), ConeSpec(cones))
    assert not accepts_mode(gen(*args))
    assert accepts_mode(two(*args))


def test_a_read_found_by_the_guard_runs_the_eager_loop_from_the_start():
    args = models.box_qp_dense(n=30).args()
    n = len(args[1])
    operands = tuple(torch.from_numpy(np.asarray(x)) for x in args[:4]) + (
        torch.zeros(0, n, dtype=torch.float64),
        torch.zeros(0, dtype=torch.float64), ConeSpec(args[4]),
        pt.kktsolver_schur, ipm.IPMOptions(verbose=True))
    seen = []

    def finds_a_read(prologue, inputs):
        seen.append(prologue)
        raise control.ReadsDevice("a caller's KKT callback reads the device")

    stats, eager_stats = {}, {}
    out = stdout_of(lambda: seen.append(ipm.ipm_solve(
        *operands, stats=stats, device_loop=finds_a_read)))
    eager = stdout_of(lambda: seen.append(ipm.ipm_solve(
        *operands, stats=eager_stats)))
    assert stats["loop"] == "eager" and "reads the device" in stats["reason"]
    assert {k: v for k, v in stats.items() if k != "reason"} == eager_stats
    # one banner, then the eager loop's rows
    assert out == eager
    assert torch.equal(seen[1].y, seen[2].y)
    run = pt_solver.Run(None, "Optimal", 1, **stats)
    assert run.reason == stats["reason"]


# ── what keeps the eager loop ──


@pytest.fixture
def gloo_world(tmp_path):
    import torch.distributed as dist

    from conicip_tpu_torch.parallel.mesh import start_rank

    start_rank(0, 1, "file://" + str(tmp_path / "rendezvous"), "cpu",
               timeout=60)
    yield pt.make_mesh((1,), ("tp",), device_type="cpu")
    dist.destroy_process_group()


def test_the_eager_loops_remaining_cases(gloo_world):
    # kktsolver_schur_tp over gloo: on the CPU the device loop takes it; on
    # CUDA tensors gloo stages its collectives through host memory
    tp = pt.kktsolver_schur_tp(gloo_world, "tp")
    assert pt_solver._eager_reason(tp, "cpu") is None
    assert "gloo" in pt_solver._eager_reason(tp, "cuda")
    # solve_batch's backstop sub-batch of stalled instances
    f32 = torch.float32
    pt.solve_batch(*models.batched_small_sdp(4, k=6), factor_dtype=f32,
                   kktsolver=_default_kktsolver(f32), device="cpu")
    runs = pt_batch.runs
    assert [(r.tier, r.loop) for r in runs] == [("main", "chunks"),
                                               ("backstop-1", "eager")]
    assert runs[0].reason is None
    assert runs[1].reason == "a sub-batch of stalled instances"


def test_a_capture_is_tried_for_no_callers_callable_on_the_cpu(monkeypatch):
    # the guard runs only where a capture would follow: a CPU solve builds
    # no probe, and the entry of a caller's callable is kept as any other
    built = []
    monkeypatch.setattr(control, "guarded",
                        lambda k: built.append(k) or k)
    kkt = port_example_box()
    graph.clear()
    pt.conic_ip(*box_instance(n=20), kktsolver=kkt, device="cpu")
    pt.conic_ip(*box_instance(n=20, seed=4), kktsolver=kkt, device="cpu")
    assert not built
    assert [r.cache_hit for r in pt_solver.runs] == [True]
    assert any(key[5] is kkt for key in graph.cache_info())
