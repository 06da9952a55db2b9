"""The device loop as the reference's ``lax.while_loop``, on the CPU.

On the card ``solver/graph.py`` runs the loop as one conditional WHILE
node (``csrc/graph_cond.cu``) whose body is a chunk of ``ipm.POLL`` units
and whose predicate is ``more`` of ``ipm.device_prologue``: some instance
still active, and the units run so far at most ``maxIters``. A hit reads
the device once, the final copy, which carries the units the node ran. On
the CPU ``ipm.run_chunks`` is the node's counterpart: a host loop of one
chunk, then one read of the same predicate. These tests hold that loop
against ``conicip_tpu.conic_ip`` (status and ``Iter``) on the R, Q, S and
mixed families of ``tests/test_torch_graph.py``, its units against the
eager loop's steps, the predicate's cap on a unit that leaves ``k``
where it was, and the arithmetic by which the card's counted conditional
bodies (the WHILE node's among them) add their launches per run.
"""

from collections import Counter
from types import SimpleNamespace

import numpy as np
import pytest
import torch

import conicip_tpu_torch as pt
from conicip_tpu_torch import solver as pt_solver
from conicip_tpu_torch import trace
from conicip_tpu_torch.cones.spec import ConeSpec
from conicip_tpu_torch.kkt import kktsolver_schur
from conicip_tpu_torch.models import box_qp_dense
from conicip_tpu_torch.ops import cholesky_kernel, rcone_kernel
from conicip_tpu_torch.solver import graph, ipm
from conicip_tpu_torch.solver.state import Status
from test_torch_graph import FAMILIES, reference

torch.set_num_threads(1)

# one family of each cone kind, and the mixed ones with equalities
KINDS = {"R": "box_diag", "Q": "single_soc", "S": "small_sdp",
         "RQS": "mixed_rqs", "RQ, equalities": "mixed_rq_eq"}


def solve(args, eager=False, **kw):
    """conic_ip on the CPU and its one run; ``eager`` takes the eager loop
    (the rule that picks the loop overridden for this call)."""
    rule = pt_solver._eager_reason
    if eager:
        pt_solver._eager_reason = lambda *a: "the eager loop, for comparison"
    try:
        sol = pt.conic_ip(*args, device="cpu", **kw)
    finally:
        pt_solver._eager_reason = rule
    (run,) = pt_solver.runs
    return sol, run


@pytest.mark.parametrize("poll", [1, 3])
@pytest.mark.parametrize("kind", list(KINDS))
def test_the_loop_runs_the_eager_loops_steps_as_units(kind, poll,
                                                      monkeypatch):
    family = KINDS[kind]
    args = FAMILIES[family]()
    ref = reference(family)
    _, erun = solve(args, eager=True)
    monkeypatch.setattr(ipm, "POLL", poll)
    sol, run = solve(args)
    assert erun.loop == "eager" and erun.units == 0
    assert run.loop == "chunks"
    assert (sol.status, sol.Iter) == (ref.status, ref.Iter)
    assert (erun.status, erun.Iter) == (ref.status, ref.Iter)
    steps = erun.fast_steps + erun.slow_steps
    assert steps > 0
    # units: the eager loop's steps, rounded up to whole chunks; the
    # host read once after the prologue and once per chunk
    assert run.units == poll * -(-steps // poll)
    assert run.units == ipm.POLL * (run.polls - 1)
    # KKT builds: one per unit after the cold start, as counted before the
    # units were (from the polls)
    assert trace.kkt_builds(run) == (run.cold_start
                                     + ipm.POLL * (run.polls - 1))
    if poll == 1:
        assert trace.kkt_builds(run) == trace.kkt_builds(erun)


@pytest.mark.parametrize("kind", ["R", "RQS"])
def test_a_warm_start_at_the_solution_ends_at_the_prologue(kind):
    # warm-started from its own solution the solve ends at its first
    # iterate, as the reference's does: the loop runs no unit and reads
    # once, after the prologue; the KKT builds are the eager loop's
    import conicip_tpu as ct

    args = FAMILIES[KINDS[kind]]()
    ref = reference(KINDS[kind])
    warm_ref = ct.conic_ip(*args, warm_start=ref)
    cold, _ = solve(args)
    sol, run = solve(args, warm_start=cold)
    esol, erun = solve(args, eager=True, warm_start=cold)
    assert (sol.status, sol.Iter) == (warm_ref.status, warm_ref.Iter)
    assert (esol.status, esol.Iter) == (warm_ref.status, warm_ref.Iter)
    assert run.loop == "chunks" and run.units == 0 and run.polls == 1
    assert erun.fast_steps + erun.slow_steps == 0
    assert trace.kkt_builds(run) == trace.kkt_builds(erun)
    assert torch.equal(sol.y, esol.y)


def operands(P):
    """ipm_solve's operands of a models problem, on the CPU."""
    Q, c, A, b, cones = (torch.from_numpy(np.asarray(x)) if i < 4 else x
                         for i, x in enumerate(P.args()[:5]))
    n = c.shape[0]
    return (Q, c, A, b, torch.zeros(0, n, dtype=c.dtype),
            torch.zeros(0, dtype=c.dtype), ConeSpec(cones))


def stuck(prologue, inputs, seen):
    """run_chunks with a unit that steps and evaluates but leaves ``k``
    where it was: nothing but the predicate's cap ends the loop."""
    def stalled(*args, **kw):
        body, cy = prologue(*args, **kw)
        unit = body.unit

        def same_k(cy, branch=ipm.masked):
            return unit(cy, branch)._replace(k=cy.k)

        seen.append(body)
        return SimpleNamespace(unit=same_k, more=body.more,
                               active=body.active), cy

    return ipm.run_chunks(stalled, inputs)


@pytest.mark.parametrize("max_iters", [1, 3])
def test_the_predicates_cap_ends_a_unit_that_leaves_k(max_iters):
    # box_qp_dense(30) takes 7 steps: at most 4 units it is still running,
    # so only the cap can end the loop, after maxIters + 1 units
    *ops, spec = operands(box_qp_dense(n=30))
    opts = ipm.IPMOptions(maxIters=max_iters)
    seen, stats = [], {}
    st = ipm.ipm_solve(*ops, spec, kktsolver_schur, opts, stats=stats,
                       device_loop=lambda p, i: stuck(p, i, seen))
    assert stats["units"] == max_iters + 1
    assert stats["polls"] == max_iters + 2
    assert int(st.status) == Status.ABANDONED
    # the predicate itself: still active, so the units alone decide
    (body,) = seen
    _, cy = ipm.device_prologue(spec, kktsolver_schur, opts)(*ops)
    assert bool(body.active(cy))
    assert bool(body.more(cy, max_iters))
    assert not bool(body.more(cy, max_iters + 1))
    # a device counter, as the WHILE node's body keeps it
    assert not bool(body.more(cy, torch.tensor(max_iters + 1)))


def test_without_a_stuck_unit_the_cap_never_binds():
    # the plain loop at maxIters: k rising ends it first, after maxIters
    # units, Abandoned, as the eager loop and the reference end
    *ops, spec = operands(box_qp_dense(n=30))
    for max_iters in (1, 3):
        stats = {}
        st = ipm.ipm_solve(*ops, spec, kktsolver_schur,
                           ipm.IPMOptions(maxIters=max_iters), stats=stats,
                           device_loop=ipm.run_chunks)
        assert stats["units"] == max_iters
        assert int(st.status) == Status.ABANDONED


@pytest.fixture
def counters():
    """The launch counters, restored after the test."""
    saved = [Counter(c) for c in graph._counters()]
    yield graph._counters()
    for c, s in zip(graph._counters(), saved):
        c.clear()
        c.update(s)


def fake_carry(steps=5, trips=2):
    return SimpleNamespace(steps=torch.tensor(steps), fast_steps=None,
                           slow_steps=None, recertified=None,
                           trips=torch.tensor(trips))


def test_counted_bodies_add_their_capture_deltas_once_per_run(counters):
    # an entry with two counted bodies: the WHILE node's (a Cholesky
    # factor, its inverse and an R-cone launch per run) and a refinement
    # trip's nested in it (an R-cone launch per run); the final copy reads
    # the units and each body's runs on the device, and each body's
    # captured launches are added once per run since the last read
    f64 = torch.float64
    chol, pred, jac, rc, inv = counters
    for c in counters:
        c.clear()
    loop_delta = [Counter({(f64, 100): 1}), Counter(), Counter(),
                  Counter({("step", f64, 100, 1): 1}),
                  Counter({(f64, 100): 1})]
    trip_delta = [Counter(), Counter(), Counter(),
                  Counter({("k4", f64, 100, 1): 1}), Counter()]
    runs = torch.tensor([7, 3])
    entry = SimpleNamespace(units=torch.tensor(8), clock=None, bodies=[
        [runs[0], loop_delta, 0], [runs[1], trip_delta, 0]])
    got = graph._counts(entry, fake_carry())
    assert got == dict(fast_steps=5, slow_steps=0, recertified=0, trips=2,
                       units=8)
    assert chol == Counter({(f64, 100): 7}) and not pred and not jac
    assert inv == Counter({(f64, 100): 7})
    assert rc == Counter({("step", f64, 100, 1): 7,
                          ("k4", f64, 100, 1): 3})
    assert [b[2] for b in entry.bodies] == [7, 3]
    # the next solve: the device counters go on from where they were
    runs += torch.tensor([6, 0])
    entry.units = torch.tensor(7)
    assert graph._counts(entry, fake_carry())["units"] == 7
    assert chol == Counter({(f64, 100): 13})
    assert rc == Counter({("step", f64, 100, 1): 13,
                          ("k4", f64, 100, 1): 3})
    assert inv == Counter({(f64, 100): 13})
    assert cholesky_kernel.cholesky_launches is chol
    assert cholesky_kernel.inverse_launches is inv
    assert rcone_kernel.rcone_launches is rc


def test_counts_on_the_cpu_read_no_units(counters):
    # the CPU's entry keeps no device counter: run_chunks counts the
    # units on the host
    entry = SimpleNamespace(units=None, clock=None, bodies=[])
    got = graph._counts(entry, fake_carry(steps=3, trips=0))
    assert got == dict(fast_steps=3, slow_steps=0, recertified=0, trips=0)


def test_the_while_body_has_a_slot_of_its_own():
    # every body a unit may count, and the loop's WHILE body beside them;
    # NESTING: the WHILE body, a variant's step, the trips inside it
    for refine in (0, 1, 3):
        opts = ipm.IPMOptions(maxRefinementSteps=refine)
        assert graph.counted_bodies(opts) == 2 * (3 + refine) + 1
    assert graph.NESTING == 3


def test_kkt_builds_count_units_where_a_run_has_them():
    # a hit: the cold start and one per unit; a miss: the prologue twice
    # (its eager first chunk among the units); the eager loop's own
    run = pt_solver.Run(None, "Optimal", 7, 7, 0, 1, 0, 1, 1, 7, "graph", 0,
                        True)
    assert trace.kkt_builds(run) == 1 + 7
    assert trace.kkt_builds(run._replace(cache_hit=False)) == 2 + 7
    assert trace.kkt_builds(run._replace(cold_start=0)) == 7
    eager = run._replace(loop="eager", units=0)
    assert trace.kkt_builds(eager) == 1 + 7


@pytest.mark.parametrize("n", [0, 5])
def test_dot_of_empty_vectors_is_a_device_zero(n):
    # a spec with no equalities dots empty vectors every unit: on the card
    # torch.dot copies their 0 from host memory, a node a WHILE body
    # refuses, so ops.batched.dot sums them; non-empty ones keep torch.dot
    from conicip_tpu_torch.ops.batched import dot

    rng = np.random.default_rng(n)
    a, b = (torch.from_numpy(rng.standard_normal(n)) for _ in range(2))
    got, want = dot(a, b), torch.dot(a, b)
    assert got.shape == want.shape == () and got.dtype == want.dtype
    assert torch.equal(got, want)
