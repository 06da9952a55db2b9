"""Batched solving: conicip_tpu_torch.solve_batch against the reference.

Every batch is made with numpy from a seed (the generators both packages
share) and solved by ``conicip_tpu.parallel.solve_batch`` (CPU, f64, a
vmapped jitted solve) and by the port on the CPU, where the port's Cholesky
is its plain version. Tolerances: per instance the same status and the same
``Iter``; ``y`` and ``v`` within 1e-6 relative of the reference's; residual
fields below optTol. With f32 factors (``factor_dtype=float32``) the two
packages round differently, so those cases hold the status equal and
``Iter`` within 2. The second half holds the batched solve against the
port's own ``conic_ip``, instance by instance.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import conicip_tpu as ct
import conicip_tpu.parallel as ct_parallel
import conicip_tpu_torch as pt
from conicip_tpu_torch.kkt import kktsolver_schur
from conicip_tpu_torch.models import (batched_box_qp, batched_mixed_rq_eq,
                                      batched_mixed_rqs, batched_small_sdp)
from conicip_tpu_torch.parallel import batch as pt_batch

torch.set_num_threads(1)

F32 = dict(jax=jnp.float32, torch=torch.float32)


def both(*args, f32=False, jax_kw=None, torch_kw=None, **kw):
    """Solve a batch with both packages; returns (reference, port) with the
    port's fields as numpy arrays."""
    jkw, tkw = dict(jax_kw or {}), dict(torch_kw or {})
    if f32:
        jkw["factor_dtype"], tkw["factor_dtype"] = F32["jax"], F32["torch"]
    ref = ct_parallel.solve_batch(*args, **kw, **jkw)
    sol = pt.solve_batch(*args, device="cpu", **kw, **tkw)
    assert sol.y.device.type == "cpu" and sol.y.dtype == torch.float64
    return ref, pt.batch_solution_to_numpy(sol)


def resid(bs):
    return np.maximum(bs.prFeas, np.maximum(bs.duFeas, bs.muFeas))


def assert_same(ref, sol, opt_tol, iter_slack=0):
    assert sol.statuses == ref.statuses
    assert np.abs(sol.Iter - np.asarray(ref.Iter)).max() <= iter_slack
    if iter_slack == 0:
        for f in ("y", "v"):
            r = np.asarray(getattr(ref, f))
            scale = np.maximum(1.0, np.nanmax(np.abs(r), axis=-1,
                                              keepdims=True))
            np.testing.assert_allclose(getattr(sol, f) / scale, r / scale,
                                       rtol=0, atol=1e-6, equal_nan=True,
                                       err_msg=f)
    opt = np.asarray(ref.status) == 1
    for s in (ref, sol):
        assert np.all(resid(s)[opt] < opt_tol)


def planted_box(seed, bad, kind="infeasible", batch=4, n=10):
    """Identity-Q box QPs with instance ``bad`` made infeasible (y ≥ 1 and
    −y ≥ 1) or unbounded (no curvature, a free direction)."""
    rng = np.random.default_rng(seed)
    Q = np.stack([np.eye(n)] * batch)
    c = rng.standard_normal((batch, n))
    A0 = np.vstack([np.eye(n), -np.eye(n)])
    A = np.stack([A0] * batch)
    b = np.stack([-np.ones(2 * n)] * batch)
    if kind == "infeasible":
        b[bad] = np.ones(2 * n)
    else:
        Q[bad] = 0.0
        A[bad, n:] = np.eye(n)  # only y ≥ −1 twice: +c is a free ray
        c[bad] = np.abs(c[bad]) + 0.1
    return Q, c, A, b, [("R", 2 * n)]


# ── against conicip_tpu.parallel.solve_batch ──


def test_solve_batch_plain():
    args = batched_box_qp(batch=8, n=20)
    ref, sol = both(*args, optTol=1e-7)
    assert sol.statuses == ["Optimal"] * 8
    assert_same(ref, sol, 1e-7)


@pytest.mark.parametrize("kind, status", [("infeasible", "Infeasible"),
                                          ("unbounded", "Unbounded")])
def test_solve_batch_mixed_statuses(kind, status):
    # one infeasible or unbounded instance inside an otherwise-optimal
    # batch must not poison the others
    args = planted_box(1, 2, kind)
    ref, sol = both(*args, optTol=1e-7)
    assert sol.statuses[2] == status
    assert [s for i, s in enumerate(sol.statuses) if i != 2] == ["Optimal"] * 3
    assert np.all(np.isfinite(sol.y[[0, 1, 3]]))
    assert_same(ref, sol, 1e-7)


def test_solve_batch_f32_backstop_escalates_infeasible():
    # an f32-tier instance that ends Abandoned with a large residual (the
    # signature of infeasibility) must still escalate through the ladder
    # and come back certified Infeasible
    args = planted_box(3, 1)
    ref, sol = both(*args, f32=True, mixedResiduals=True, optTol=1e-7)
    assert sol.statuses[1] == "Infeasible"
    assert sol.statuses[0] == sol.statuses[2] == sol.statuses[3] == "Optimal"
    assert resid(sol)[[0, 2, 3]].max() < 1e-7
    assert_same(ref, sol, 1e-7, iter_slack=2)


def test_solve_batch_warm_start():
    Q, c, A, b, cones = batched_box_qp(batch=6, n=20)
    cold_ref, cold = both(Q, c, A, b, cones, optTol=1e-7)
    c2 = c * 1.01
    cold2 = pt.batch_solution_to_numpy(
        pt.solve_batch(Q, c2, A, b, cones, optTol=1e-7, device="cpu"))
    # each package warm-starts from its own cold solution, carried across
    # as numpy: the same iterate to 1e-6
    ref = ct_parallel.solve_batch(Q, c2, A, b, cones, optTol=1e-7,
                                  warm_start=pt.warm_to_numpy(
                                      pt.solve_batch(Q, c, A, b, cones,
                                                     optTol=1e-7,
                                                     device="cpu")))
    warm = pt.batch_solution_to_numpy(pt.solve_batch(
        Q, c2, A, b, cones, optTol=1e-7, device="cpu",
        warm_start=pt.warm_from_numpy(cold_ref.y, cold_ref.w, cold_ref.v,
                                      device="cpu")))
    assert warm.statuses == ["Optimal"] * 6
    assert warm.Iter.mean() < cold2.Iter.mean()
    assert resid(warm).max() < 1e-7
    assert_same(ref, warm, 1e-7)
    np.testing.assert_allclose(warm.y, cold2.y, atol=2e-3)
    # a BatchSolution is a warm start as it is
    again = pt.solve_batch(Q, c2, A, b, cones, optTol=1e-7, device="cpu",
                           warm_start=pt.solve_batch(Q, c, A, b, cones,
                                                     optTol=1e-7,
                                                     device="cpu"))
    assert again.Iter.tolist() == warm.Iter.tolist()
    del cold


def test_solve_batch_warm_start_scrubs_nonfinite():
    Q, c, A, b, cones = batched_box_qp(batch=4, n=12)
    cold = pt.batch_solution_to_numpy(
        pt.solve_batch(Q, c, A, b, cones, optTol=1e-7, device="cpu"))
    y = cold.y.copy()
    y[2] = np.nan  # one corrupted instance must not poison the batch
    ref = ct_parallel.solve_batch(Q, c, A, b, cones, optTol=1e-7,
                                  warm_start=(y, cold.w, cold.v))
    warm = pt.batch_solution_to_numpy(pt.solve_batch(
        Q, c, A, b, cones, optTol=1e-7, device="cpu",
        warm_start=(y, cold.w, cold.v)))
    assert warm.statuses == ["Optimal"] * 4
    assert_same(ref, warm, 1e-7)


def test_solve_batch_warm_start_bad_dims():
    Q, c, A, b, cones = batched_box_qp(batch=4, n=12)
    cold = pt.solve_batch(Q, c, A, b, cones, device="cpu")
    with pytest.raises(ValueError):
        pt.solve_batch(Q, c, A, b, cones, device="cpu",
                       warm_start=(cold.y[:, :-1], None, cold.v))


def test_solve_batch_eliminated_matches_single():
    Q, c, A, b, cones, G, d = batched_mixed_rq_eq(batch=6, n=40)
    # pinned: the family has the low-rank structure that otherwise keeps
    # the direct path
    ref, sol = both(Q, c, A, b, cones, G, d, f32=True, optTol=1e-7,
                    eliminate_equalities=True)
    assert sol.statuses == ["Optimal"] * 6
    assert resid(sol).max() < 1e-7
    assert_same(ref, sol, 1e-7, iter_slack=2)
    # equalities hold to elimination accuracy, and the answers match the
    # individual full-precision solves
    np.testing.assert_allclose(sol.y @ G.T, d, atol=1e-9)
    for i in range(6):
        one = pt.conic_ip(Q[i], c[i], A[i], b[i], cones, G=G, d=d[i],
                          factor_dtype=None, optTol=1e-9,
                          eliminateEqualities=False, device="cpu")
        np.testing.assert_allclose(sol.y[i], one.y.numpy(), atol=2e-3)
        np.testing.assert_allclose(sol.w[i], one.w.numpy(), atol=2e-3)


def test_solve_batch_f32_lowrank_direct_path():
    # the same family by default: f32 dense tier, and the low-rank f64
    # finisher behind it; no elimination
    Q, c, A, b, cones, G, d = batched_mixed_rq_eq(batch=5, n=30, n_q=11, p=4)
    ref, sol = both(Q, c, A, b, cones, G, d, f32=True)
    assert sol.statuses == ["Optimal"] * 5
    assert_same(ref, sol, 1e-6, iter_slack=2)
    np.testing.assert_allclose(sol.y @ G.T, d, atol=1e-6)


def inconsistent_row_batch():
    Q, c, A, b, cones, G, d = batched_mixed_rq_eq(batch=4, n=30)
    # duplicate an equality row with a contradictory rhs in instance 2 only
    G2 = np.vstack([G, G[0]])
    d2 = np.concatenate([d, d[:, :1]], axis=1)
    d2[2, -1] += 1.0
    return Q, c, A, b, cones, G2, d2


def test_solve_batch_eliminated_inconsistent_instance():
    ref, sol = both(*inconsistent_row_batch(), f32=True, optTol=1e-7)
    assert sol.statuses[2] == "Infeasible"
    assert sol.statuses[0] == sol.statuses[1] == sol.statuses[3] == "Optimal"
    assert np.all(np.isnan(sol.y[2])) and sol.Iter[2] == 0
    assert sol.statuses == ref.statuses
    assert np.abs(sol.Iter - np.asarray(ref.Iter))[1:].max() <= 2
    assert resid(sol)[[0, 1, 3]].max() < 1e-7
    # Every instance of the reduced stack stalls in the f32 tier in both
    # packages, and ``Iter`` is the accepted rescue tier's own count.
    # Instance 0 sits on an edge: the two f32 main tiers end 1e-6 apart in
    # y, and from this package's iterate the f64-assembled tier finishes it
    # in 5 steps, while from the reference's it stalls and the f64 tier
    # finishes it in 2. (The test below shows that each tier, given the
    # other package's iterate, does what the other package's tier does.)
    # Pinned as observed, with the tier that finished each instance:
    main, fused1, fused2 = pt_batch.runs
    assert [r.tier for r in pt_batch.runs] == ["main", "fused-1", "fused-2"]
    stalled = (pt_batch.Status.ABANDONED,) * 4
    assert main.status == stalled and main.Iter == (6, 6, 6, 6)
    assert fused1.status == (1, 4, 4, 1) and fused1.Iter == (5, 1, 1, 5)
    assert fused2.status == (1, 1, 1, 1) and fused2.Iter[1] == 4
    assert sol.Iter.tolist() == [5, 4, 0, 5]
    assert np.asarray(ref.Iter).tolist() == [2, 4, 0, 5]


def test_rescue_tier_from_the_same_iterate_matches_reference(monkeypatch):
    # the f64-assembled rescue tier of both packages from the same warm
    # iterate, crossed: from this package's f32 main iterate both finish
    # instance 0 in 5 steps, from the reference's both leave it stalled
    # after 1. The tiers and their accept rule agree; the difference in the
    # test above is the rounding of the f32 main tier.
    import conicip_tpu.parallel.batch as ct_batch
    from conicip_tpu.cones.spec import ConeSpec as RefSpec
    from conicip_tpu.solver import _default_kktsolver as ref_kkt
    from conicip_tpu.solver.ipm import IPMOptions as RefOptions
    from conicip_tpu.solver.state import Vec4 as RefVec4
    from conicip_tpu_torch.solver import _default_kktsolver as pt_kkt

    args = inconsistent_row_batch()
    cones = args[4]
    seen = {}
    run = pt_batch._run

    def spy(spec, kkt, opts, tier, *operands, **kw):
        st = run(spec, kkt, opts, tier, *operands, **kw)
        seen.setdefault(tier, (spec, kkt, opts, operands[:6], st))
        return st

    monkeypatch.setattr(pt_batch, "_run", spy)
    pt_batch.make_batched_ladder_solver.cache_clear()
    pt.solve_batch(*args, factor_dtype=torch.float32, optTol=1e-7,
                   device="cpu")
    monkeypatch.undo()
    pt_batch.make_batched_ladder_solver.cache_clear()
    spec, _, opts, reduced, pt_main = seen["main"]
    _, kkt1, opts1, _, pt_fused1 = seen["fused-1"]
    assert kkt1 is pt_kkt(torch.float32, torch.float64)

    def as_dict(o):
        return {f: getattr(o, f) for f in o.__dataclass_fields__}

    Qr, cr, Ar, br, Gr, dr = (jnp.asarray(x.numpy()) for x in reduced)
    ref_spec = RefSpec(tuple(cones))
    ref_main = ct_batch.make_batched_solver(
        ref_spec, ref_kkt(jnp.float32), RefOptions(**as_dict(opts)))(
        Qr, cr, Ar, br, Gr, dr)
    ref_tier = ct_batch.make_batched_warm_solver(
        ref_spec, ref_kkt(jnp.float32, jnp.float64),
        RefOptions(**as_dict(opts1)))

    def ref_from(y, w, v):
        y, w, v = (jnp.asarray(np.asarray(x)) for x in (y, w, v))
        s = jnp.einsum("bij,bj->bi", Ar, y) - br
        return ref_tier(Qr, cr, Ar, br, Gr, dr, RefVec4(y, w, v, s))

    def pt_from(y, w, v):
        y, w, v = (torch.as_tensor(np.array(x)) for x in (y, w, v))
        return run(spec, kkt1, opts1, "crossed", *reduced,
                   pt_batch._neutral_warm(y, w, v, reduced[2], reduced[3]))

    def outcome(st):
        return (np.asarray(st.status).tolist(), np.asarray(st.Iter).tolist())

    assert outcome(ref_main) == outcome(pt_main) == ([4] * 4, [6] * 4)
    own = outcome(pt_fused1)
    assert own == ([1, 4, 4, 1], [5, 1, 1, 5])
    assert outcome(ref_from(pt_main.y, pt_main.w, pt_main.v)) == own
    ref_own = outcome(ref_from(ref_main.y, ref_main.w, ref_main.v))
    assert ref_own == ([4, 4, 4, 1], [1, 1, 1, 5])
    assert outcome(pt_from(ref_main.y, ref_main.w, ref_main.v)) == ref_own


def test_solve_batch_eliminate_requires_shared_G():
    Q, c, A, b, cones, G, d = batched_mixed_rq_eq(batch=3, n=24)
    Gb = np.broadcast_to(G, (3,) + G.shape).copy()
    with pytest.raises(ValueError):
        pt.solve_batch(Q, c, A, b, cones, Gb, d, eliminate_equalities=True,
                       device="cpu")


def test_solve_batch_stacked_G_direct_path():
    # per-instance equality systems take the direct saddle path
    Q, c, A, b, cones, G, d = batched_mixed_rq_eq(batch=3, n=24)
    Gb = np.broadcast_to(G, (3,) + G.shape).copy()
    ref, sol = both(Q, c, A, b, cones, Gb, d, optTol=1e-7)
    assert sol.statuses == ["Optimal"] * 3
    assert_same(ref, sol, 1e-7)
    np.testing.assert_allclose(sol.w, np.asarray(ref.w), atol=1e-6)


def test_solve_batch_sdp_backstop_skips_futile_tier():
    # S-cone stalls cannot be rescued by the f64-assembled/f32-factored
    # tier; the f32 policy for S cones runs the spectral solver in full
    # precision and certifies every instance
    args = batched_small_sdp(6, k=6)
    ref, sol = both(*args, f32=True, optTol=1e-7)
    assert sol.statuses == ["Optimal"] * 6
    assert resid(sol).max() < 1e-7
    assert_same(ref, sol, 1e-7, iter_slack=2)
    from conicip_tpu_torch.kkt.spectral import spectral_kktsolver

    assert [r.kktsolver for r in pt_batch.runs][0] is spectral_kktsolver(None)
    assert not any(getattr(r.kktsolver, "keywords", {}).get("assemble_dtype")
                   for r in pt_batch.runs)


def test_solve_batch_full_rank_G_degenerate():
    # G with rank n pins y completely: a 0-variable reduced problem must
    # fall back to the direct saddle path, not crash
    n = 4
    Q = np.stack([np.eye(n)] * 3)
    c = np.zeros((3, n))
    A = Q.copy()
    b = np.zeros((3, n))
    d = 0.5 * np.ones((3, n))
    ref, sol = both(Q, c, A, b, [("R", n)], np.eye(n), d, f32=True,
                    optTol=1e-7)
    assert sol.statuses == ["Optimal"] * 3
    np.testing.assert_allclose(sol.y, d, atol=1e-6)
    assert_same(ref, sol, 1e-7, iter_slack=2)


def test_batched_sdp_fasteig_certifies():
    # f32 decompositions on request, against full-precision ones: every
    # instance certifies 1e-6 either way, with the same objective
    Q, c, A, b, cones = batched_small_sdp(5, k=5)
    kw = dict(factor_dtype=torch.float32, device="cpu")
    fast = pt.batch_solution_to_numpy(pt.solve_batch(Q, c, A, b, cones, **kw))
    slow = pt.batch_solution_to_numpy(
        pt.solve_batch(Q, c, A, b, cones, fastEig=False, **kw))
    for bs in (fast, slow):
        assert bs.statuses == ["Optimal"] * 5
        assert resid(bs).max() < 1e-6
    np.testing.assert_allclose(fast.pobj, slow.pobj, rtol=1e-5, atol=1e-5)
    # 'refined' decompositions are the working-dtype ones in this package
    ref = pt.solve_batch(Q, c, A, b, cones, refinedEig=True, **kw)
    assert torch.equal(ref.y, torch.as_tensor(slow.y))


def test_batched_sdp_fasteig_rescue_tier_certifies():
    # the S-cone rescue ladder driven directly: f32 factors and f32
    # decompositions first, then the f64-KKT tier with f32 decompositions,
    # then the full-precision tier; every instance certifies 1e-6
    from conicip_tpu_torch.parallel.batch import make_batched_ladder_solver
    from conicip_tpu_torch.solver import _default_kktsolver

    Q, c, A, b, cones = batched_small_sdp(6, k=6)
    spec = pt.ConeSpec(cones)
    n = c.shape[-1]
    O = pt.IPMOptions
    tiers = (
        (_default_kktsolver(None),
         O(optTol=1e-6, mixedResiduals=False, fastEig=True)),
        (_default_kktsolver(None),
         O(optTol=1e-6, mixedResiduals=False, fastEig=False)),
    )
    solver = make_batched_ladder_solver(
        spec, _default_kktsolver(torch.float32), tiers,
        O(optTol=1e-6, mixedResiduals=True, fastEig=True))
    del pt_batch.runs[:]
    T = lambda x: torch.as_tensor(x, dtype=torch.float64)  # noqa: E731
    st = solver(T(Q), T(c), T(A), T(b), torch.zeros(6, 0, n).double(),
                torch.zeros(6, 0).double())
    assert st.status.tolist() == [1] * 6
    res = torch.maximum(st.prFeas, torch.maximum(st.duFeas, st.muFeas))
    assert float(res.max()) < 1e-6
    # the f32 tier breaks down on S cones, so a rescue tier ran
    assert [r.tier for r in pt_batch.runs][:2] == ["main", "fused-1"]


# ── against the port's own conic_ip, instance by instance ──


def single(args, i, **kw):
    """conic_ip on instance i of a stacked problem (G shared when 2-D)."""
    Q, c, A, b, cones = args[:5]
    G = d = None
    if len(args) > 5:
        G = args[5] if np.ndim(args[5]) == 2 else args[5][i]
        d = args[6][i]
    return pt.conic_ip(Q[i], c[i], A[i], b[i], cones, G, d, device="cpu",
                       **kw)


# what solve_batch's f64 default runs per family: the dense Schur backend,
# one corrector on R/Q specs and none with S cones
FAMILIES = {
    "box_qp": (lambda: batched_box_qp(6, n=24, seed=2), 1),
    "small_sdp": (lambda: batched_small_sdp(5, k=5, seed=2), 0),
    "mixed_rq_eq": (lambda: batched_mixed_rq_eq(5, n=30, n_q=11, p=4), 1),
    "mixed_rqs": (lambda: batched_mixed_rqs(4, seed=2), 0),
}


@pytest.mark.parametrize("family", sorted(FAMILIES))
def test_batch_matches_own_single_solves(family):
    make, correctors = FAMILIES[family]
    args = make()
    sol = pt.solve_batch(*args, device="cpu")
    assert sol.statuses == ["Optimal"] * args[1].shape[0]
    assert float(torch.maximum(sol.prFeas, torch.maximum(
        sol.duFeas, sol.muFeas)).max()) < 1e-6
    for i in range(args[1].shape[0]):
        one = single(args, i, kktsolver=kktsolver_schur,
                     centralityCorrectors=correctors)
        assert (one.status, one.Iter) == (sol.statuses[i], int(sol.Iter[i]))
        # the stacked products sum in another order than the single ones
        assert (one.y - sol.y[i]).abs().max() <= 1e-6 * max(
            1.0, float(one.y.abs().max()))


# the KKT backends a caller picks by hand, on a stack: each package's own
# qr and lu solver under its solve_batch
BY_HAND = {
    "qr": (ct.kktsolver_qr, pt.kktsolver_qr),
    "lu": (ct.kktsolver_lu, pt.kktsolver_lu),
}
STACKS = {
    "mixed_rq_eq-stacked_G": lambda: batched_mixed_rq_eq(4, n=30),
    "mixed_rq_eq-shared_G": lambda: batched_mixed_rq_eq(4, n=30),
    "box_qp": lambda: batched_box_qp(4, n=20),
}


@pytest.mark.parametrize("stack", sorted(STACKS))
@pytest.mark.parametrize("backend", sorted(BY_HAND))
def test_solve_batch_qr_lu_on_a_stack(backend, stack):
    ref_kkt, kkt = BY_HAND[backend]
    args = list(STACKS[stack]())
    if stack.endswith("stacked_G"):
        args[5] = np.broadcast_to(args[5], (4,) + args[5].shape).copy()
    ref, sol = both(*args, jax_kw=dict(kktsolver=ref_kkt),
                    torch_kw=dict(kktsolver=kkt))
    assert sol.statuses == ["Optimal"] * 4
    assert_same(ref, sol, 1e-6)
    np.testing.assert_allclose(sol.w, np.asarray(ref.w), atol=1e-6)
    assert [r.kktsolver for r in pt_batch.runs] == [kkt]
    for i in range(4):
        one = single(args, i, kktsolver=kkt)
        assert (one.status, one.Iter) == (sol.statuses[i], int(sol.Iter[i]))
        for f in ("y", "w", "v"):
            np.testing.assert_allclose(getattr(sol, f)[i],
                                       getattr(one, f).numpy(), rtol=0,
                                       atol=1e-6, err_msg=f)


@pytest.mark.parametrize("backend", sorted(BY_HAND))
def test_qr_lu_take_a_shared_G_and_a_broken_instance(backend):
    # G as one 2-D system under stacked Q and A (make_batched_solver with
    # batch_G=False), against the same stack with G stacked; and an
    # instance with non-finite data, which reaches the factorizations:
    # nothing raises, it ends Error, and its neighbours are untouched
    from conicip_tpu_torch.parallel.batch import make_batched_solver

    kkt = BY_HAND[backend][1]
    Q, c, A, b, cones, G, d = batched_mixed_rq_eq(4, n=30)
    T = lambda x: torch.as_tensor(x, dtype=torch.float64)  # noqa: E731
    spec, opts = pt.ConeSpec(tuple(cones)), pt.IPMOptions()
    shared = make_batched_solver(spec, kkt, opts, batch_G=False)(
        T(Q), T(c), T(A), T(b), T(G), T(d))
    Gb = T(G).expand(4, *G.shape)
    stacked = make_batched_solver(spec, kkt, opts)(
        T(Q), T(c), T(A), T(b), Gb, T(d))
    assert shared.status.tolist() == stacked.status.tolist() == [1] * 4
    assert shared.Iter.tolist() == stacked.Iter.tolist()
    assert float((shared.y - stacked.y).abs().max()) <= 1e-9
    with pytest.raises(ValueError, match="batch_G"):
        make_batched_solver(spec, kkt, opts, batch_G=False)(
            T(Q), T(c), T(A), T(b), Gb, T(d))
    for where in ("c", "Q", "G"):
        Qn, cn, Gn = Q.copy(), c.copy(), np.array(Gb)
        {"c": cn, "Q": Qn, "G": Gn}[where][2].flat[3] = np.nan
        hurt = pt.solve_batch(Qn, cn, A, b, cones, Gn, d, kktsolver=kkt,
                              device="cpu")
        assert hurt.statuses == ["Optimal"] * 2 + ["Error"] + ["Optimal"]
        keep = [0, 1, 3]
        assert hurt.Iter[keep].tolist() == stacked.Iter[keep].tolist()
        assert float((hurt.y[keep] - stacked.y[keep]).abs().max()) <= 1e-9


def test_instances_finish_apart_and_a_failed_one_stays_alone():
    # instances that need 6 and 7 iterations under a budget of 6: the slow
    # ones end Abandoned with their own best iterate, the others Optimal
    # and bit for bit what they are without the budget; an instance with
    # NaN data ends Error and touches nobody
    Q, c, A, b, cones = batched_box_qp(6, n=24, seed=2)
    free = pt.solve_batch(Q, c, A, b, cones, device="cpu")
    iters = free.Iter.tolist()
    assert len(set(iters)) > 1
    cut = min(iters)
    tight = pt.solve_batch(Q, c, A, b, cones, maxIters=cut, device="cpu")
    for i, k in enumerate(iters):
        want = "Optimal" if k <= cut else "Abandoned"
        assert tight.statuses[i] == want
        one = pt.conic_ip(Q[i], c[i], A[i], b[i], cones, maxIters=cut,
                          device="cpu")
        assert (one.status, one.Iter) == (want, int(tight.Iter[i]))
        if want == "Optimal":
            assert torch.equal(tight.y[i], free.y[i])
    c_bad = c.copy()
    c_bad[3, 5] = np.nan
    hurt = pt.solve_batch(Q, c_bad, A, b, cones, device="cpu")
    assert hurt.statuses[3] == "Error"
    keep = [0, 1, 2, 4, 5]
    assert [hurt.statuses[i] for i in keep] == ["Optimal"] * 5
    assert torch.equal(hurt.y[keep], free.y[keep])
    assert torch.equal(hurt.Iter[keep], free.Iter[keep])


def test_fused_ladder_runs_only_the_tiers_it_needs():
    # no stalled instance: the main tier alone
    args = batched_box_qp(4, n=16, seed=1)
    sol = pt.solve_batch(*args, factor_dtype=torch.float32, device="cpu")
    assert sol.statuses == ["Optimal"] * 4
    assert [r.tier for r in pt_batch.runs] == ["main"]
    assert pt_batch.runs[0].kktsolver.keywords["factor_dtype"] == torch.float32
    # the reduced mixed R+Q batch at 1e-7 stalls every instance in the f32
    # tier; the fused tiers run in order until nothing is stalled, each on
    # the whole stack, and the host backstop finds nothing left
    Q, c, A, b, cones, G, d = batched_mixed_rq_eq(batch=4, n=30)
    kw = dict(factor_dtype=torch.float32, optTol=1e-7,
              eliminate_equalities=True, device="cpu")
    sol = pt.solve_batch(Q, c, A, b, cones, G, d, **kw)
    assert sol.statuses == ["Optimal"] * 4
    tiers = [r.tier for r in pt_batch.runs]
    assert tiers[0] == "main" and pt_batch.runs[0].stalled > 0
    assert tiers[1] == "fused-1"
    assert not any(t.startswith("backstop") for t in tiers)
    assert [r.stalled for r in pt_batch.runs][-1] == 0
    assert all(a.stalled >= b.stalled
               for a, b in zip(pt_batch.runs, pt_batch.runs[1:]))
    # without the backstop the stalled instances come back as they ended
    raw = pt.solve_batch(Q, c, A, b, cones, G, d, backstop=False,
                         twoModeKKT=False, **kw)
    assert set(raw.statuses) & {"Abandoned", "Error"}
    # (the reduced solve, then the direct fallback on what it left stalled)
    assert [r.tier for r in pt_batch.runs] == ["main", "main"]


def test_two_variant_generator_in_a_stack_matches_single_solves():
    # backstop=False keeps the in-loop last-mile switch: instances of one
    # stack switch to the full-precision variant on different iterations,
    # and each gets what its own solve gets
    from conicip_tpu_torch.solver import _default_kktsolver
    from conicip_tpu_torch.solver.ipm import IPMOptions, ipm_solve

    Q, c, A, b, cones = batched_box_qp(5, n=24, seed=4)
    kkt = _default_kktsolver(torch.float32, lastmile=True)
    opts = IPMOptions(optTol=1e-9, mixedResiduals=True, lastmileProactive=50.0)
    spec = pt.ConeSpec(cones)
    T = lambda x: torch.as_tensor(x, dtype=torch.float64)  # noqa: E731
    n = c.shape[-1]
    stats = {}
    st = ipm_solve(T(Q), T(c), T(A), T(b), torch.zeros(5, 0, n).double(),
                   torch.zeros(5, 0).double(), spec, kkt, opts, stats=stats)
    assert stats["slow_steps"] > 0 and stats["fast_steps"] > 0
    for i in range(5):
        one = ipm_solve(T(Q[i]), T(c[i]), T(A[i]), T(b[i]),
                        torch.zeros(0, n).double(), torch.zeros(0).double(),
                        spec, kkt, opts)
        assert int(one.status) == int(st.status[i])
        assert int(one.Iter) == int(st.Iter[i])
        assert (one.y - st.y[i]).abs().max() <= 1e-8


def test_solve_batch_rejects_what_it_does_not_do():
    args = batched_box_qp(2, n=8)
    with pytest.raises(ValueError, match="verbose"):
        pt.solve_batch(*args, verbose=True, device="cpu")
    with pytest.raises(TypeError, match="make_mesh"):
        pt.solve_batch(*args, mesh=object(), device="cpu")


def test_batched_generators_give_the_reference_data():
    from conicip_tpu.models import generators as ref_gen
    from conicip_tpu_torch.models import generators as gen

    for name, kw in (("batched_box_qp", dict(batch=3, n=7, seed=5)),
                     ("batched_small_sdp", dict(batch=3, k=4, seed=5)),
                     ("batched_mixed_rq_eq", dict(batch=3, n=12, seed=5)),
                     ("batched_mixed_rqs", dict(batch=3, seed=5))):
        mine, theirs = getattr(gen, name)(**kw), getattr(ref_gen, name)(**kw)
        assert len(mine) == len(theirs)
        for x, y in zip(mine, theirs):
            if isinstance(x, list):
                assert x == y
            else:
                np.testing.assert_array_equal(x, y)
    X = np.random.default_rng(0).standard_normal((2, 4, 4))
    X = X + X.transpose(0, 2, 1)
    np.testing.assert_array_equal(gen._vecm_np(X), ref_gen._vecm_np(X))
    assert [g.__name__ for g in gen.ALL_GENERATORS] == [
        g.__name__ for g in ref_gen.ALL_GENERATORS]
    assert [g.family_name for g in gen.ALL_GENERATORS] == [
        g.family_name for g in ref_gen.ALL_GENERATORS]


def test_parallel_exports_the_reference_names():
    """The reference's public names of parallel/, and no more: batch,
    checkpoint, the mesh and the distributed Schur solver."""
    import conicip_tpu_torch.parallel as mine_pkg

    assert set(mine_pkg.__all__) == set(ct_parallel.__all__)
    for name in mine_pkg.__all__:
        assert callable(getattr(mine_pkg, name))
    for name in ("solve_batch", "BatchSolution", "kktsolver_schur_tp",
                 "make_mesh"):
        assert getattr(pt, name) is getattr(mine_pkg, name)
        assert getattr(ct, name) is getattr(ct_parallel, name)
    assert callable(pt.batch_from_numpy)


def test_no_library_cholesky_on_the_kkt_and_batch_paths():
    """Every dense KKT factor goes through ops/cholesky.py (the kernel on a
    CUDA tensor): no module of kkt/ or parallel/ calls torch's Cholesky or
    the plain version itself."""
    import pathlib
    import re

    root = pathlib.Path(pt.__file__).parent
    for sub in ("kkt", "parallel"):
        for path in (root / sub).glob("*.py"):
            code = re.sub(r'""".*?"""', "", path.read_text(), flags=re.S)
            assert not re.search(r"linalg\.cholesky|cholesky_ex|cholesky_plain"
                                 r"|cholesky_solve", code), path
