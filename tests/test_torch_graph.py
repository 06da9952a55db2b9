"""The device loop of ``conicip_tpu_torch.solver.ipm`` on the CPU.

On CUDA, ``conic_ip`` runs the interior-point iteration of its full-precision
built-in backends as a captured CUDA graph (``solver/graph.py``), the host
reading the status once per chunk of ``ipm.POLL`` iterations; on the CPU the
same chunks run eagerly (``ipm.run_chunks``). These tests hold the chunked
loop against ``conicip_tpu.conic_ip`` (same status and ``Iter``, y/w/v
within 1e-6, NaN patterns equal on certificates) at several ``POLL``, show
that a chunk reads nothing back (so that it can be captured on the card),
and hold the masked refinement and the predicated ridge retry against the
reference.
"""

import contextlib
import functools
import io

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import conicip_tpu as ct
from conicip_tpu.ops.control import retry_while as jax_retry_while
import conicip_tpu_torch as pt
from conicip_tpu_torch import models
from conicip_tpu_torch import solver as pt_solver
from conicip_tpu_torch.cones.spec import ConeSpec
from conicip_tpu_torch.kkt import kktsolver_schur
from conicip_tpu_torch.ops.cholesky import cholesky
from conicip_tpu_torch.ops.cholesky_kernel import cholesky_plain
from conicip_tpu_torch.ops.control import retry_while
from conicip_tpu_torch.solver import ipm
from test_torch_ipm import assert_same, box

torch.set_num_threads(1)

OPT_TOL = 1e-6


def readme_box(n=100):
    """The README box QP (diag backend) as (Q, c, A, b, cones, G, d)."""
    return box(n) + (None, None)


# the f64 families of tests/test_torch_conic.py and a box QP on diag
FAMILIES = {
    "single_soc": lambda: models.single_soc(n=40).args(),
    "many_small_socs": lambda: models.many_small_socs(n=60, k=20).args(),
    "small_sdp": lambda: models.small_sdp(k=4).args(),
    "mixed_rqs": lambda: models.mixed_rqs().args(),
    "mixed_rq_eq": lambda: models.mixed_rq_eq(n=30).args(),
    "box_diag": readme_box,
}


@functools.lru_cache(maxsize=None)
def reference(family, **kw):
    return ct.conic_ip(*FAMILIES[family](), **kw)


def port(args, **kw):
    """The port's CPU solve and its one run, which must have taken the
    chunked device loop."""
    sol = pt.conic_ip(*args, device="cpu", **kw)
    (run,) = pt_solver.runs
    assert run.loop == "chunks" and run.replays == 0
    return pt.solution_to_numpy(sol), run


def chunks_run(run, poll):
    """Chunks of ``poll`` units the loop ran: one unit per step taken."""
    return -(-run.fast_steps // poll)


@pytest.mark.parametrize("poll", [1, 3, 100])
@pytest.mark.parametrize("family", list(FAMILIES))
def test_chunked_loop_matches_jax(family, poll, monkeypatch):
    # POLL = 100 = maxIters: one chunk, the solve's end and every frozen
    # unit after it inside it
    monkeypatch.setattr(ipm, "POLL", poll)
    sol, run = port(FAMILIES[family]())
    ref = reference(family)
    assert_same(ref, sol, OPT_TOL)
    # one host read of the loop after the prologue, and one per chunk
    assert run.polls == 1 + chunks_run(run, poll)


class HostRead(AssertionError):
    pass


@contextlib.contextmanager
def no_host_reads():
    """Every way a tensor reaches a Python value raises: what a read inside
    a CUDA graph capture would be."""
    def refuse(*args, **kw):
        raise HostRead("a host read inside the device loop")

    with pytest.MonkeyPatch.context() as mp:
        for name in ("__bool__", "item", "tolist", "__int__", "__float__",
                     "__index__"):
            mp.setattr(torch.Tensor, name, refuse)
        yield


def guarded_first_chunk(prologue, inputs):
    """A device loop whose prologue and first chunk run with host reads
    refused; the rest as ``run_chunks``."""
    with no_host_reads():
        body, cy = prologue(*inputs)
        for _ in range(ipm.POLL):
            cy = body.unit(cy)
    polls = 2
    while bool(body.active(cy)):
        for _ in range(ipm.POLL):
            cy = body.unit(cy)
        polls += 1
    return cy, dict(polls=polls, replays=0, loop="chunks")


def sdp_with_equalities():
    """small_sdp(k=4) with two equalities its solution satisfies (an S
    spec with equalities: the Schur backend)."""
    Q, c, A, b, cones, _, _ = models.small_sdp(k=4).args()
    rng = np.random.default_rng(3)
    G = rng.standard_normal((2, len(c)))
    y = ct.conic_ip(Q, c, A, b, cones).y
    return Q, c, A, b, cones, G, G @ np.asarray(y)


GUARDED = {
    "R diag": readme_box,
    "R diag, equality": lambda: box(100) + (np.ones((1, 100)),
                                            np.array([1.0])),
    "R schur": lambda: models.box_qp_dense(n=30).args(),
    "Q schur": FAMILIES["single_soc"],
    "RQ schur, equalities": FAMILIES["mixed_rq_eq"],
    "S spectral": FAMILIES["small_sdp"],
    "RQS spectral": FAMILIES["mixed_rqs"],
    "S schur, equalities": sdp_with_equalities,
}


@pytest.mark.parametrize("case", list(GUARDED))
def test_a_chunk_reads_nothing_back(case, monkeypatch):
    # the same solve with its first chunk under the guard: no read, and the
    # reference's answer
    args = GUARDED[case]()
    monkeypatch.setattr(ipm, "run_chunks", guarded_first_chunk)
    sol, run = port(args)
    assert run.polls >= 2
    assert_same(ct.conic_ip(*args), sol, OPT_TOL)


def test_the_guard_catches_a_read():
    with no_host_reads(), pytest.raises(HostRead):
        bool(torch.ones(()) > 0)


@pytest.mark.parametrize("steps", [0, 1, 2, 3])
def test_masked_refinement_matches_jax(steps, capsys):
    # mixed_rq_eq: some iteration takes every one of `steps` trips (the
    # verbose table, the eager loop's text printed from the device loop's
    # polls: refine = steps taken + 1); the device loop runs them all
    # masked and lands on the reference
    args = FAMILIES["mixed_rq_eq"]()
    pt.conic_ip(*args, device="cpu", verbose=True, maxRefinementSteps=steps)
    (verbose_run,) = pt_solver.runs
    assert verbose_run.loop == "chunks"
    rows = [line.split("│") for line in capsys.readouterr().out.splitlines()
            if line.count("│") == 4 and "Iter" not in line]
    assert max(int(r[-1].strip().split("\x1b")[0]) for r in rows) == steps + 1
    sol, _ = port(args, maxRefinementSteps=steps)
    assert_same(ct.conic_ip(*args, maxRefinementSteps=steps), sol, OPT_TOL)


@pytest.mark.parametrize("max_iters, poll", [(5, 3), (6, 4), (1, 2)])
def test_max_iters_not_a_multiple_of_poll_is_abandoned(max_iters, poll,
                                                       monkeypatch):
    monkeypatch.setattr(ipm, "POLL", poll)
    args = models.box_qp_dense(n=30).args()
    sol, run = port(args, maxIters=max_iters)
    ref = ct.conic_ip(*args, maxIters=max_iters)
    assert ref.status == "Abandoned"
    assert_same(ref, sol, OPT_TOL)
    assert run.fast_steps == max_iters
    assert run.polls == 1 + -(-max_iters // poll)


def test_warm_start_on_the_chunked_loop():
    # _solve_warm_jit's counterpart: a warm start from the solution of a
    # neighbouring instance, on the Schur backend and on diag
    for make in (lambda s: models.box_qp_dense(n=40, seed=s).args(),
                 lambda s: box(60)[:1] + (box(60)[1] + s,) + box(60)[2:]):
        first = ct.conic_ip(*make(7))
        ref = ct.conic_ip(*make(8), warm_start=first)
        sol, run = port(make(8), warm_start=(np.asarray(first.y),
                                             np.asarray(first.w),
                                             np.asarray(first.v)))
        assert run.cold_start == 0 and ref.status == "Optimal"
        assert_same(ref, sol, OPT_TOL)


def indefinite_by(n, lowest, seed):
    """A unit-diagonal symmetric matrix whose least eigenvalue is
    ``lowest``: a well-conditioned block beside [[1, 1 - lowest],
    [1 - lowest, 1]] (eigenvalues 2 - lowest and lowest), rows and
    columns permuted. Only the permutation is random, so rounding leaves
    the margin as it is."""
    rng = np.random.default_rng(seed)
    V, _ = np.linalg.qr(rng.standard_normal((n - 2, n - 2)))
    C = (V * np.linspace(0.5, 2.0, n - 2)) @ V.T
    dg = 1.0 / np.sqrt(np.diag(C))
    M = np.eye(n)
    M[:-2, :-2] = 0.5 * (C + C.T) * dg[:, None] * dg[None, :]
    M[-1, -2] = M[-2, -1] = 1.0 - lowest
    perm = rng.permutation(n)
    return M[np.ix_(perm, perm)]


RIDGE = 30.0 * np.finfo(np.float64).eps


def factor_tol(boost):
    """|L - L_ref| of two LAPACK factors of M + boost·ridge·I, whose
    condition number is up to ~1 / (boost·ridge): ~eps·sqrt(κ) each entry,
    times 10."""
    return max(1e-12, 10 * np.finfo(np.float64).eps
               / np.sqrt((boost or 1e6) * RIDGE))


def boost_taken(M, L):
    """The ridge boost a factor was taken at: diag(LLᵀ − M) / ridge."""
    return float(np.median(np.diag(L @ L.T - M)) / RIDGE)


@pytest.mark.parametrize("lowest, boost", [(0.5, 1.0), (-1e-12, 1e3),
                                           (-1e-9, 1e6), (-1e-3, None)])
def test_device_retry_takes_the_references_boost(lowest, boost):
    # the Schur solver's retry (kkt/schur.py): first factor at the ridge,
    # then predicated attempts at 1e3 and 1e6 ridges
    n = 40
    M = indefinite_by(n, lowest, seed=5)
    Mt = torch.from_numpy(M)
    Ik = torch.eye(n, dtype=torch.float64)
    L = retry_while(
        lambda L: ~torch.isfinite(L).flatten(-2).all(-1),
        lambda b, skip, L: cholesky(Mt + (b * RIDGE) * Ik, skip=skip, out=L),
        cholesky(Mt + RIDGE * Ik), 1e3, 1e3, 1e7).numpy()
    Mj = jnp.asarray(M)
    ref = np.asarray(jax_retry_while(
        lambda L: ~jnp.all(jnp.isfinite(L)),
        lambda b: jnp.linalg.cholesky(Mj + (b * RIDGE) * jnp.eye(n)),
        jnp.linalg.cholesky(Mj + RIDGE * jnp.eye(n)), 1e3, 1e3, 1e7))
    L, ref = np.tril(L), np.tril(ref)  # (NaN above it in the reference's)
    np.testing.assert_array_equal(np.isfinite(L), np.isfinite(ref))
    np.testing.assert_allclose(L, ref, rtol=0, atol=factor_tol(boost))
    if boost is None:  # beyond the cap: both end non-finite
        assert not np.isfinite(L).all()
    else:  # the boosts are 1e3 apart
        assert boost_taken(M, L) == pytest.approx(boost, rel=0.5)
        assert boost_taken(M, ref) == pytest.approx(boost, rel=0.5)


def test_device_retry_on_a_stack_matches_vmap_of_the_reference():
    # each instance its own boost; the reference's loop under vmap
    n = 30
    M = np.stack([indefinite_by(n, lo, seed=i) for i, lo in
                  enumerate((0.5, -1e-12, -1e-9, -1e-3))])
    Mt = torch.from_numpy(M)
    Ik = torch.eye(n, dtype=torch.float64)
    L = retry_while(
        lambda L: ~torch.isfinite(L).flatten(-2).all(-1),
        lambda b, skip, L: cholesky(Mt + (b * RIDGE) * Ik, skip=skip, out=L),
        cholesky(Mt + RIDGE * Ik), 1e3, 1e3, 1e7).numpy()

    def one(Mi):
        return jax_retry_while(
            lambda L: ~jnp.all(jnp.isfinite(L)),
            lambda b: jnp.linalg.cholesky(Mi + (b * RIDGE) * jnp.eye(n)),
            jnp.linalg.cholesky(Mi + RIDGE * jnp.eye(n)), 1e3, 1e3, 1e7)

    L, ref = np.tril(L), np.tril(np.asarray(jax.vmap(one)(jnp.asarray(M))))
    np.testing.assert_array_equal(np.isfinite(L), np.isfinite(ref))
    np.testing.assert_allclose(L, ref, rtol=0, atol=factor_tol(1e3))
    for i, want in enumerate((1.0, 1e3, 1e6)):
        assert boost_taken(M[i], L[i]) == pytest.approx(want, rel=0.5)
    assert not np.isfinite(L[3]).all()


def test_predicated_plain_factor_keeps_the_flagged_matrices(rng):
    B = rng.standard_normal((3, 6, 6))
    M = torch.from_numpy(B @ np.swapaxes(B, -1, -2) + 6 * np.eye(6))
    prev = torch.full_like(M, 7.0)
    skip = torch.tensor([True, False, True])
    L = cholesky_plain(M, skip=skip, out=prev)
    fresh = cholesky_plain(M)
    assert torch.equal(L[[0, 2]], prev[[0, 2]])
    assert torch.equal(L[1], fresh[1])
    # one matrix, one flag
    assert torch.equal(cholesky_plain(M[1], skip=torch.tensor(True),
                                      out=prev[1]), prev[1])
    assert torch.equal(cholesky_plain(M[1], skip=torch.tensor(False),
                                      out=prev[1]), fresh[1])
    with pytest.raises(ValueError, match="needs `out`"):
        cholesky_plain(M, skip=skip)
    with pytest.raises(ValueError, match="skip must be a bool tensor"):
        cholesky_plain(M, skip=skip[:2], out=prev)


def test_device_loop_configurations():
    # the device loop takes the built-in backends at every precision (f32
    # factors with the last-mile switch and mixed residuals too), passed by
    # a caller too, a caller's own callable and verbose output
    args = models.box_qp_dense(n=30).args()
    for kw, loop in (({}, "chunks"), (dict(verbose=True), "chunks"),
                     (dict(factor_dtype=torch.float32), "chunks"),
                     (dict(kktsolver=kktsolver_schur), "chunks"),
                     (dict(kktsolver=lambda *a: kktsolver_schur(*a)),
                      "chunks")):
        with contextlib.redirect_stdout(None):
            pt.conic_ip(*args, device="cpu", **kw)
        # (a ladder tier after an f32 run takes the device loop too)
        assert pt_solver.runs[0].loop == loop, kw
    # ipm_solve's device loop prints the eager loop's verbose text
    n = len(args[1])
    printed = []
    for device_loop in (ipm.run_chunks, None):
        with contextlib.redirect_stdout(io.StringIO()) as out:
            ipm.ipm_solve(*(torch.from_numpy(np.asarray(x)) for x in args[:4]),
                          torch.zeros(0, n, dtype=torch.float64),
                          torch.zeros(0, dtype=torch.float64),
                          ConeSpec(args[4]), kktsolver_schur,
                          ipm.IPMOptions(verbose=True),
                          device_loop=device_loop)
        printed.append(out.getvalue())
    assert printed[0] == printed[1] and "│" in printed[0]


def test_the_graphs_buffers_rebuild_the_carry():
    # solver/graph.py copies a carry into one buffer per tensor and back:
    # every tensor of it, in order, and nothing else
    from conicip_tpu_torch.solver import graph

    seen = {}

    def keep(prologue, inputs):
        seen["carry"] = prologue(*inputs)[1]
        return ipm.run_chunks(prologue, inputs)

    args = GUARDED["RQ schur, equalities"]()
    spec = ConeSpec(args[4])
    ipm.ipm_solve(*(torch.from_numpy(np.asarray(x)) for x in args[:4]),
                  torch.from_numpy(args[5]), torch.from_numpy(args[6]),
                  spec, kktsolver_schur, ipm.IPMOptions(),
                  device_loop=keep)
    cy = seen["carry"]
    leaves = graph._leaves(cy)
    # the iterate, the best record, best/stall/k/steps/trips, the scaling
    # and its inverse adjoint (r_d, and d, u, alpha per SOC group), the
    # scaled point, and the residuals (rleft, r0 and 11 scalars)
    scaling = 1 + 3 * len(spec.soc_groups)
    assert spec.soc_groups and spec.nr
    assert len(leaves) == 4 + 11 + 5 + 2 * scaling + 1 + (4 + 4 + 11)
    assert leaves[0] is cy.z.y
    copy = graph._rebuild(cy, iter([t.clone() for t in leaves]))
    assert type(copy) is ipm.Carry and copy.k.shape == ()
    for a, b in zip(graph._leaves(copy), leaves):
        assert a is not b and torch.equal(a, b)
