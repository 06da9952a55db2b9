"""The rescue paths behind f32 factors, at the widths the card drives them.

``chip_smoke.py`` ``[ladder]`` holds the card to the CPU on a single solve
that climbs ``conic_ip``'s ladder and on a stack that reaches
``solve_batch``'s backstop; here the same constructions are held to the
reference on the CPU (statuses equal, ``Iter`` within 2, the band f32
factors get), with the port's tiers read from ``solver.runs`` and
``parallel.batch.runs``. The last test pins what the f32 eliminated stack
of ``batched_mixed_rq_eq`` costs in both packages: both f32 tiers stall on
every instance and the f64 tier finishes them.
"""

import functools

import jax.numpy as jnp
import numpy as np
import torch

import conicip_tpu as ct
import conicip_tpu.parallel as ct_parallel
import conicip_tpu.parallel.batch as ct_batch
import conicip_tpu_torch as pt
from conicip_tpu_torch import solver as pt_solver
from conicip_tpu_torch.models import batched_mixed_rq_eq, batched_small_sdp
from conicip_tpu_torch.parallel import batch as pt_batch
from conicip_tpu_torch.solver.state import Status

torch.set_num_threads(1)

STALLED = (Status.ABANDONED, Status.ERROR)


def wide_diag_qp(n):
    """A separable QP with a wide diagonal spread and one equality: at
    optTol=1e-10 the f32 tiers of the eliminated problem stall."""
    rng = np.random.default_rng(1)
    Q = np.diag(np.logspace(0, -6, n))
    c = rng.standard_normal(n) * np.logspace(0, -3, n)
    A = np.vstack([np.eye(n), -np.eye(n)])
    return (Q, c, A, -np.ones(2 * n), [("R", 2 * n)], np.ones((1, n)),
            np.array([0.3]))


def precision(kktsolver):
    kw = getattr(kktsolver, "keywords", {})
    return (kw.get("factor_dtype"), kw.get("assemble_dtype"),
            bool(kw.get("lastmile")))


def test_conic_ip_climbs_every_tier_at_the_cards_width():
    n = 200  # tests/test_torch_mixed.py holds the same climb at n=30
    f32, f64 = torch.float32, torch.float64
    sol = pt.conic_ip(*wide_diag_qp(n), factor_dtype=f32, optTol=1e-10,
                      maxIters=40, device="cpu")
    runs = list(pt_solver.runs)
    assert [precision(r.kktsolver) for r in runs] == [
        (f32, None, True), (f32, f64, False), (None, None, False)]
    assert [r.status for r in runs][1:] == ["Abandoned", "Optimal"]
    assert runs[0].status in ("Abandoned", "Error")
    assert sol.status == "Optimal" and sol.Iter == runs[-1].Iter
    assert max(sol.prFeas, sol.duFeas, sol.muFeas) < 1e-10
    ref = ct.conic_ip(*wide_diag_qp(n), factor_dtype=jnp.float32,
                      optTol=1e-10, maxIters=40)
    assert ref.status == "Optimal" and abs(ref.Iter - sol.Iter) <= 2
    assert abs(sol.pobj - ref.pobj) <= 1e-8 * (1 + abs(ref.pobj))
    # residuals of 1e-10 over a smallest curvature of 1e-6 pin y to 1e-4
    np.testing.assert_allclose(sol.y.numpy(), np.asarray(ref.y), rtol=0,
                               atol=1e-4)


def test_solve_batch_backstop_finishes_a_stalled_scone_stack():
    # a caller's f32 Schur solver on S cones: no fused tier stands behind
    # a caller's solver there, the f32 decompositions stall every instance
    # near the tolerance, and the backstop re-solves them as a sub-batch
    # in f64 (the f64-assembled f32 tier is skipped on S cones)
    args = batched_small_sdp(6, k=6)
    ref = ct_parallel.solve_batch(
        *args, factor_dtype=jnp.float32, kktsolver=functools.partial(
            ct.kktsolver_schur, factor_dtype=jnp.float32))
    sol = pt.solve_batch(
        *args, factor_dtype=torch.float32, device="cpu",
        kktsolver=functools.partial(pt.kktsolver_schur,
                                    factor_dtype=torch.float32))
    main, backstop = pt_batch.runs
    assert (main.tier, backstop.tier) == ("main", "backstop-1")
    assert main.stalled == backstop.batch > 0 and backstop.stalled == 0
    assert precision(main.kktsolver)[0] == torch.float32
    assert backstop.kktsolver is pt.kktsolver_schur
    assert sol.statuses == ref.statuses == ["Optimal"] * 6
    assert np.abs(sol.Iter.numpy() - np.asarray(ref.Iter)).max() <= 2
    res = torch.maximum(sol.prFeas, torch.maximum(sol.duFeas, sol.muFeas))
    assert float(res.max()) < 1e-6
    # two answers within optTol = 1e-6, reached from differently rounded
    # f32 iterates
    np.testing.assert_allclose(sol.y.numpy(), np.asarray(ref.y), rtol=0,
                               atol=1e-4)
    # an instance the backstop finished reports that tier's own count
    rescued = [i for i, s in enumerate(main.status) if s in STALLED]
    assert sol.Iter[rescued].tolist() == list(backstop.Iter)


def test_f32_eliminated_stack_stalls_in_both_f32_tiers_in_both_packages(
        monkeypatch):
    """``batched_mixed_rq_eq`` at n=200 with f32 factors, eliminated
    (reduced order 190): in the port the f32 main tier and the
    f64-assembled f32 tier leave every instance Abandoned and the f64 tier
    finishes them, three stacked solves. The reference's two f32 tiers,
    run on the same reduced stack, stall on every instance as well, and
    its ``solve_batch`` ends on the same per-instance ``Iter``, the f64
    tier's own count: the cost is the reference's behaviour, not a fault
    of the port."""
    from conicip_tpu.cones.spec import ConeSpec as RefSpec
    from conicip_tpu.solver import _default_kktsolver as ref_kkt
    from conicip_tpu.solver.ipm import IPMOptions as RefOptions
    from conicip_tpu.solver.state import Vec4 as RefVec4

    args = batched_mixed_rq_eq(4, n=200, n_q=51, p=10)
    cones = args[4]
    seen = {}
    run = pt_batch._run

    def spy(spec, kkt, opts, tier, *operands, **kw):
        st = run(spec, kkt, opts, tier, *operands, **kw)
        seen[tier] = (opts, operands[:6])
        return st

    monkeypatch.setattr(pt_batch, "_run", spy)
    pt_batch.make_batched_ladder_solver.cache_clear()
    sol = pt.solve_batch(*args, factor_dtype=torch.float32,
                         eliminate_equalities=True, device="cpu")
    monkeypatch.undo()
    pt_batch.make_batched_ladder_solver.cache_clear()
    runs = list(pt_batch.runs)
    assert [r.tier for r in runs] == ["main", "fused-1", "fused-2"]
    assert [precision(r.kktsolver)[:2] for r in runs] == [
        (torch.float32, None), (torch.float32, torch.float64), (None, None)]
    assert [r.stalled for r in runs] == [4, 4, 0]
    assert runs[0].status == runs[1].status == (Status.ABANDONED,) * 4
    assert sol.statuses == ["Optimal"] * 4
    assert sol.Iter.tolist() == list(runs[2].Iter)

    ref = ct_parallel.solve_batch(*args, factor_dtype=jnp.float32,
                                  eliminate_equalities=True)
    assert ref.statuses == ["Optimal"] * 4
    assert np.abs(np.asarray(ref.Iter) - sol.Iter.numpy()).max() <= 2
    np.testing.assert_allclose(sol.y.numpy(), np.asarray(ref.y), rtol=0,
                               atol=1e-5)

    # the reference's f32 tiers on the port's reduced stack
    def as_dict(o):
        return {f: getattr(o, f) for f in o.__dataclass_fields__}

    opts, reduced = seen["main"]
    opts1, _ = seen["fused-1"]
    assert reduced[0].shape == (4, 190, 190)
    Qr, cr, Ar, br, Gr, dr = (jnp.asarray(x.numpy()) for x in reduced)
    spec = RefSpec(tuple(cones))
    ref_main = ct_batch.make_batched_solver(
        spec, ref_kkt(jnp.float32), RefOptions(**as_dict(opts)))(
        Qr, cr, Ar, br, Gr, dr)
    assert np.asarray(ref_main.status).tolist() == [Status.ABANDONED] * 4
    assert np.abs(np.asarray(ref_main.Iter)
                  - np.asarray(runs[0].Iter)).max() <= 2
    s = jnp.einsum("bij,bj->bi", Ar, ref_main.y) - br
    ref_fused1 = ct_batch.make_batched_warm_solver(
        spec, ref_kkt(jnp.float32, jnp.float64),
        RefOptions(**as_dict(opts1)))(
        Qr, cr, Ar, br, Gr, dr, RefVec4(ref_main.y, ref_main.w, ref_main.v, s))
    assert np.asarray(ref_fused1.status).tolist() == [Status.ABANDONED] * 4
