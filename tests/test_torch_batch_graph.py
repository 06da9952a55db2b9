"""``solve_batch`` on the device loop (``conicip_tpu_torch.solver.graph``), on
the CPU.

The reference runs a stack as one ``jax.jit(jax.vmap(ipm_solve))``, kept per
configuration and shape. The port's counterpart: every run whose KKT
generator ``solve_batch`` chose itself, in full precision, goes through the
device loop's cache (on CUDA a captured prologue and chunk; here the same
chunks run eagerly, ``ipm.run_chunks``). These tests hold the stacked device
loop

- against ``conicip_tpu.parallel.solve_batch`` on the same numpy data (per
  instance the same status and ``Iter``, y/w/v within 1e-6);
- against the eager loop on the same operands (y bit for bit, the same KKT
  builds, counted at the built-in generators' level-2 call, and the same
  refinement trips);
- on its cache: a stack of other data of the same shapes is a hit and
  equals a fresh solve bit for bit; a shared and a stacked G, and a warm
  start, are configurations of their own; ``solve_batch_resumable``'s
  later chunks hit;
- and as a capture would take it: the prologue and first chunk of each
  stacked configuration read nothing back and make no tensor of host data
  once a first prologue has run.

They also say which runs keep the eager loop: the backstop's
sub-batches and a caller's own callable; f32 factors with mixed residuals
take the device loop.
"""

import contextlib
import functools

import numpy as np
import pytest
import torch

import conicip_tpu.parallel as ct_parallel
import conicip_tpu_torch as pt
from conicip_tpu_torch.kkt.lowrank import lowrank_kktsolver
from conicip_tpu_torch.kkt.spectral import spectral_kktsolver
from conicip_tpu_torch.models import (batched_box_qp, batched_mixed_rq_eq,
                                      batched_mixed_rqs, batched_small_sdp)
from conicip_tpu_torch.parallel import batch as pt_batch
from conicip_tpu_torch.parallel import checkpoint
from conicip_tpu_torch.solver import _default_kktsolver, graph, ipm
from test_torch_batch import assert_same, planted_box
from test_torch_graph import no_host_reads
from test_torch_graph_cache import counted_builds

torch.set_num_threads(1)

OPT_TOL = 1e-6
F32 = torch.float32


def stacked_G(args):
    """The stack with its shared G repeated per instance."""
    Q, c, A, b, cones, G, d = args
    return Q, c, A, b, cones, np.broadcast_to(G, (c.shape[0],) + G.shape
                                              ).copy(), d


# the four batched families, at small sizes, by seed
STACKS = {
    "box_qp": lambda s=0: batched_box_qp(4, n=12, seed=s),
    "mixed_rq_eq shared G": lambda s=0: batched_mixed_rq_eq(
        4, n=30, n_q=7, p=3, seed=s),
    "mixed_rq_eq stacked G": lambda s=0: stacked_G(batched_mixed_rq_eq(
        4, n=30, n_q=7, p=3, seed=s)),
    "mixed_rqs": lambda s=0: batched_mixed_rqs(3, seed=s),
    "small_sdp": lambda s=0: batched_small_sdp(3, seed=s),
}


@functools.lru_cache(maxsize=None)
def reference(stack, **kw):
    return ct_parallel.solve_batch(*STACKS[stack](), **kw)


def port(args, **kw):
    """The port's CPU solve, its fields as numpy arrays, and its runs."""
    sol = pt.solve_batch(*args, device="cpu", **kw)
    return sol, pt.batch_solution_to_numpy(sol), list(pt_batch.runs)


def assert_w_close(ref, sol):
    r = np.asarray(ref.w)
    scale = np.maximum(1.0, np.nanmax(np.abs(r), axis=-1, keepdims=True,
                                      initial=0.0))
    np.testing.assert_allclose(sol.w / scale, r / scale, rtol=0, atol=1e-6,
                               equal_nan=True)


def same_bits(a, b):
    """Two BatchSolutions equal bit for bit (NaN where the other is)."""
    for f in ("y", "w", "v", "status", "Iter", "Mu", "prFeas", "duFeas",
              "muFeas", "pobj", "dobj"):
        x, y = getattr(a, f), getattr(b, f)
        assert torch.equal(torch.isnan(x), torch.isnan(y)), f
        assert torch.equal(torch.nan_to_num(x), torch.nan_to_num(y)), f


@contextlib.contextmanager
def operands_of_the_device_loop():
    """The arguments each graph.solve call of solve_batch was given."""
    calls, real = [], graph.solve

    def spy(*args, **kw):
        calls.append((args, kw))
        return real(*args, **kw)

    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(graph, "solve", spy)
        yield calls


# ── against conicip_tpu.parallel.solve_batch ──


@pytest.mark.parametrize("stack", list(STACKS))
def test_the_main_run_takes_the_device_loop_and_matches_jax(stack):
    sol, got, runs = port(STACKS[stack]())
    assert [(r.tier, r.loop, r.replays) for r in runs] == [
        ("main", "chunks", 0)]
    ref = reference(stack)
    assert got.statuses == ["Optimal"] * len(got.statuses)
    assert_same(ref, got, OPT_TOL)
    assert_w_close(ref, got)


@pytest.mark.parametrize("kind, status", [("infeasible", "Infeasible"),
                                          ("unbounded", "Unbounded")])
def test_planted_certificates_keep_their_neighbours(kind, status):
    args = planted_box(1, 2, kind)
    _, got, runs = port(args, optTol=1e-7)
    assert runs[0].loop == "chunks"
    ref = ct_parallel.solve_batch(*args, optTol=1e-7)
    assert got.statuses[2] == status
    assert np.all(np.isfinite(got.y[[0, 1, 3]]))
    assert_same(ref, got, 1e-7)


def test_max_iters_ends_each_instance_as_the_reference():
    args = STACKS["box_qp"]()
    cut = min(reference("box_qp").Iter.tolist()) - 1
    _, got, runs = port(args, maxIters=cut)
    assert runs[0].loop == "chunks" and runs[0].fast_steps == cut
    ref = ct_parallel.solve_batch(*args, maxIters=cut)
    assert got.statuses == ref.statuses == ["Abandoned"] * 4
    assert_same(ref, got, OPT_TOL)


# ── against the eager loop on the same operands ──


@pytest.mark.parametrize("stack", list(STACKS))
def test_the_device_loop_builds_and_refines_as_the_eager_loop(stack):
    graph.clear()
    with operands_of_the_device_loop() as calls, counted_builds() as builds:
        sol = pt.solve_batch(*STACKS[stack](), device="cpu")
    (run,) = pt_batch.runs
    device_builds = len(builds)
    ((args, kw),) = calls
    stats = {}
    with counted_builds() as builds:
        eager = ipm.ipm_solve(*args, warm=kw["warm"], stats=stats)
    assert stats["loop"] == "eager"
    same_bits(sol, pt_batch.BatchSolution.from_state(eager))
    # the cold start's build and one per step, as the eager loop
    assert device_builds == len(builds) == 1 + stats["fast_steps"]
    assert run.fast_steps == stats["fast_steps"]
    assert run.trips == stats["trips"]
    assert run.polls == 1 + run.fast_steps


# ── the cache ──


@pytest.mark.parametrize("stack", list(STACKS))
def test_a_hit_on_other_data_equals_a_fresh_solve(stack):
    graph.clear()
    first, kept, _ = port(STACKS[stack](0))
    (key,) = graph.cache_info()
    hit, _, runs = port(STACKS[stack](1))
    assert runs[0].cache_hit and graph.cache_info() == [key]
    np.testing.assert_array_equal(first.y.numpy(), kept.y)
    graph.clear()
    fresh, _, runs = port(STACKS[stack](1))
    assert not runs[0].cache_hit
    same_bits(hit, fresh)


def test_shared_and_stacked_G_have_entries_of_their_own():
    graph.clear()
    port(STACKS["mixed_rq_eq shared G"]())
    port(STACKS["mixed_rq_eq stacked G"]())
    _, _, runs = port(STACKS["mixed_rq_eq shared G"](1))
    assert runs[0].cache_hit
    # the same shapes; G's layout tells them apart (the shared G is one
    # system expanded over the stack, stride 0)
    stacked, shared = graph.cache_info()
    assert [i for i in range(len(shared)) if shared[i] != stacked[i]] == [3]
    assert [s for s, _ in shared[3]] == [s for s, _ in stacked[3]]
    assert [i for i, (a, b) in enumerate(zip(shared[3], stacked[3]))
            if a != b] == [4]
    assert shared[3][4][1][0] == 0 != stacked[3][4][1][0]


def test_a_warm_start_has_an_entry_of_its_own():
    graph.clear()
    args = STACKS["box_qp"]()
    cold, _, _ = port(args)
    warm, _, runs = port(args, warm_start=cold)
    assert runs[0].cold_start == 0 and not runs[0].cache_hit
    assert graph.cache_info()[-1][-2] is False
    # the warm iterate is copied into the entry, not kept by reference:
    # another warm start hits and solves as a fresh entry does
    other = pt.solve_batch(*STACKS["box_qp"](1), device="cpu")
    hit, _, runs = port(args, warm_start=other)
    assert runs[0].cache_hit and runs[0].cold_start == 0
    graph.clear()
    fresh, _, runs = port(args, warm_start=other)
    assert not runs[0].cache_hit
    same_bits(hit, fresh)


def test_resumed_chunks_hit_the_warm_entry(tmp_path, monkeypatch):
    graph.clear()
    seen, real = [], checkpoint.solve_batch

    def spy(*args, **kw):
        out = real(*args, **kw)
        seen.append([(r.loop, r.cold_start, r.cache_hit)
                     for r in pt_batch.runs])
        return out

    monkeypatch.setattr(checkpoint, "solve_batch", spy)
    out = checkpoint.solve_batch_resumable(
        *STACKS["box_qp"](), store=str(tmp_path / "snap.npz"),
        chunk_iters=2, maxIters=12, device="cpu")
    assert out.statuses == ["Optimal"] * 4
    assert len(seen) >= 3
    # the first chunk is cold, the second the first warm one: two misses;
    # every later chunk hits the warm entry
    assert seen[0] == [("chunks", 1, False)]
    assert seen[1] == [("chunks", 0, False)]
    assert all(s == [("chunks", 0, True)] for s in seen[2:])


# ── which runs keep the eager loop ──


def test_f32_main_runs_keep_the_eager_loop_and_f64_tiers_do_not():
    # the f32 main tier (mixed residuals) and the low-rank f64 finisher
    # fused behind it both take the device loop (the name is the one this
    # test had while the f32 main tier stayed eager)
    _, got, runs = port(STACKS["mixed_rq_eq shared G"](), factor_dtype=F32,
                        optTol=1e-8)
    assert [(r.tier, r.loop) for r in runs] == [("main", "chunks"),
                                               ("fused-1", "chunks")]
    assert runs[0].kktsolver.keywords["factor_dtype"] == F32
    assert runs[1].kktsolver is lowrank_kktsolver()
    assert got.statuses == ["Optimal"] * 4


def test_the_backstops_sub_batches_keep_the_eager_loop():
    # a caller's f32 Schur generator on S cones stalls every instance (on
    # the device loop: it is the package's own); the backstop's f64
    # sub-batch finishes them on the eager loop
    _, got, runs = port(batched_small_sdp(4, k=6),
                        kktsolver=_default_kktsolver(F32), factor_dtype=F32)
    assert [(r.tier, r.loop) for r in runs] == [("main", "chunks"),
                                               ("backstop-1", "eager")]
    assert runs[1].kktsolver is pt.kktsolver_schur
    assert got.statuses == ["Optimal"] * 4


def test_the_s_cone_f32_policy_runs_on_the_device_loop():
    # behind factor_dtype=float32 the S-cone policy's main run is the f64
    # spectral solver: the solver's own, in full precision
    _, got, runs = port(STACKS["small_sdp"](), factor_dtype=F32)
    assert runs[0].kktsolver is spectral_kktsolver(None)
    assert runs[0].loop == "chunks"
    assert got.statuses == ["Optimal"] * 3


@pytest.mark.parametrize("backend", ["kktsolver_qr", "kktsolver_lu"])
def test_a_callers_kktsolver_keeps_the_eager_loop(backend):
    # a caller's own callable (here around one of the package's backends)
    # takes the device loop, as the reference's jit(vmap(...)) traces it
    def kkt(Q, A, G, spec):
        return getattr(pt, backend)(Q, A, G, spec)

    _, got, runs = port(STACKS["mixed_rq_eq stacked G"](), kktsolver=kkt)
    assert [(r.kktsolver, r.loop, r.cache_hit, r.reason) for r in runs] == [
        (kkt, "chunks", False, None)]
    assert got.statuses == ["Optimal"] * 4


# ── as a capture takes it ──


@contextlib.contextmanager
def no_host_traffic():
    """What a capture refuses: a read of the device, and a tensor made of
    host data (a copy to the device)."""
    def refuse(make):
        def guarded(data, *args, **kw):
            if not isinstance(data, torch.Tensor):
                raise AssertionError("host data copied inside the device "
                                     "loop")
            return make(data, *args, **kw)
        return guarded

    with no_host_reads(), pytest.MonkeyPatch.context() as mp:
        for name in ("tensor", "as_tensor", "from_numpy"):
            mp.setattr(torch, name, refuse(getattr(torch, name)))
        yield


def as_a_capture(prologue, inputs):
    """A device loop run as a miss on the card is: the prologue once
    eagerly, then the prologue and the first chunk with host reads and
    host data refused; the rest as ``run_chunks``."""
    prologue(*inputs)
    with no_host_traffic():
        body, cy = prologue(*inputs)
        for _ in range(ipm.POLL):
            cy = body.unit(cy)
    polls = 2
    while bool(body.active(cy)):
        for _ in range(ipm.POLL):
            cy = body.unit(cy)
        polls += 1
    return cy, dict(polls=polls, replays=0, units=ipm.POLL * (polls - 1),
                    loop="chunks")


def lowrank_finisher():
    """The f32 path's low-rank f64 finisher on the mixed R+Q stack, as
    graph.solve arguments."""
    Q, c, A, b, cones, G, d = STACKS["mixed_rq_eq shared G"]()
    T = lambda x: torch.as_tensor(x, dtype=torch.float64)  # noqa: E731
    return ((T(Q), T(c), T(A), T(b), T(G).expand(4, *G.shape), T(d),
             pt.ConeSpec(cones), lowrank_kktsolver(), pt.IPMOptions()), {})


GUARDED = {
    **{stack: (make, {}) for stack, make in STACKS.items()},
    "small_sdp f32 (spectral)": (STACKS["small_sdp"],
                                 dict(factor_dtype=F32)),
}


@pytest.mark.parametrize("case", list(GUARDED) + ["lowrank finisher"])
def test_a_stacked_chunk_reads_nothing_back(case, monkeypatch):
    monkeypatch.setattr(ipm, "run_chunks", as_a_capture)
    graph.clear()
    if case == "lowrank finisher":
        args, kw = lowrank_finisher()
        stats = {}
        st = graph.solve(*args, stats=stats, **kw)
        assert stats["polls"] >= 2 and st.status.tolist() == [1] * 4
        return
    make, kw = GUARDED[case]
    _, got, runs = port(make(), **kw)
    assert runs[0].loop == "chunks" and runs[0].polls >= 2
    assert got.statuses == ["Optimal"] * len(got.statuses)


def test_the_capture_guard_catches_host_data():
    with no_host_traffic(), pytest.raises(AssertionError, match="host"):
        torch.as_tensor(np.ones(3))
    with no_host_traffic():
        torch.as_tensor(torch.ones(3), dtype=torch.float64)
