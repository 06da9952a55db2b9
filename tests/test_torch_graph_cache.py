"""The device loop's cache (``conicip_tpu_torch.solver.graph``) on the CPU.

``conic_ip`` keeps one entry per configuration (device, dtype, shapes,
cone spec, KKT generator, options, cold or warm start): its input buffers
and, on CUDA, its captured graphs. A later call of the same configuration
copies its data into the buffers and runs the loop again (on the CPU
eagerly, ``ipm.run_chunks``). These tests build an entry on one instance
and refresh it with others of the same shapes: each refreshed solve equals
a fresh solve of its data bit for bit and matches ``conicip_tpu.conic_ip``
(same status and ``Iter``, y/w/v within 1e-6); an earlier solution is not
changed by a later call; a different configuration gets an entry of its
own, and the cache is bounded. They also hold the rotated loop (step, then
evaluate) to the eager loop: the same KKT builds, counted at the built-in
generators' level-2 call, and the same refinement trips.
"""

import contextlib
import functools
import io

import numpy as np
import pytest
import torch

import conicip_tpu as ct
import conicip_tpu_torch as pt
from conicip_tpu_torch import models
from conicip_tpu_torch import solver as pt_solver
from conicip_tpu_torch.kkt import diag, schur, spectral
from conicip_tpu_torch.solver import graph
from test_torch_ipm import assert_same, box

torch.set_num_threads(1)

OPT_TOL = 1e-6


def box_with(n, seed, eq=False, pattern=False):
    """The README box QP (diag backend), its objective shifted by the seed;
    with one equality; or with A's rows in another order, signs and
    scales (each row still one nonzero: the same backend, other level-1
    data), and the box it bounds kept by b."""
    H, c, A, b, cones = box(n)
    rng = np.random.default_rng(seed)
    c = c + rng.standard_normal(n)
    if pattern:
        perm = rng.permutation(n)
        signs = rng.choice([-1.0, 1.0], size=2 * n)
        scale = rng.uniform(0.5, 2.0, size=2 * n)
        A = (signs * scale)[:, None] * np.vstack([np.eye(n)[perm],
                                                  -np.eye(n)[perm]])
        b = -scale
    G, d = (np.ones((1, n)), np.array([1.0])) if eq else (None, None)
    return H, c, A, b, cones, G, d


# a configuration: its instance at a seed, and the backend it takes
FAMILIES = {
    "box_qp_dense schur": (
        lambda s: models.box_qp_dense(n=30, seed=s).args(), "schur"),
    "readme box diag": (lambda s: box_with(40, s), "diag"),
    "readme box diag, equality": (lambda s: box_with(40, s, eq=True), "diag"),
    "readme box diag, sign pattern": (
        lambda s: box_with(40, s, pattern=True), "diag"),
    "small_sdp spectral": (lambda s: models.small_sdp(k=4, seed=s).args(),
                           "spectral"),
    "mixed_rq_eq schur": (lambda s: models.mixed_rq_eq(n=30, seed=s).args(),
                          "schur"),
}
SEEDS = (1, 2, 3)  # the first builds the entry, the others refresh it


@functools.lru_cache(maxsize=None)
def reference(family, seed):
    return ct.conic_ip(*FAMILIES[family][0](seed))


def solve(args, **kw):
    """The port's CPU solve and its one run (the device loop)."""
    sol = pt.conic_ip(*args, device="cpu", **kw)
    (run,) = pt_solver.runs
    assert run.loop == "chunks"
    return sol, run


def same_bits(a, b):
    assert (a.status, a.Iter) == (b.status, b.Iter)
    for f in ("y", "w", "v"):
        x, y = getattr(a, f), getattr(b, f)
        assert torch.equal(torch.isnan(x), torch.isnan(y)), f
        assert torch.equal(torch.nan_to_num(x), torch.nan_to_num(y)), f
    for f in ("Mu", "prFeas", "duFeas", "muFeas", "pobj", "dobj"):
        assert np.array_equal(getattr(a, f), getattr(b, f), equal_nan=True)


@pytest.mark.parametrize("family", list(FAMILIES))
def test_a_refreshed_entry_solves_as_a_fresh_one(family):
    make, backend = FAMILIES[family]
    graph.clear()
    sols = []
    for i, seed in enumerate(SEEDS):
        sol, run = solve(make(seed))
        assert run.cache_hit == (i > 0)
        assert len(graph.cache_info()) == 1
        sols.append((seed, sol, pt.solution_to_numpy(sol)))
    (key,) = graph.cache_info()
    assert key[5] is {"schur": pt.kktsolver_schur,
                      "diag": pt.kktsolver_diag,
                      "spectral": spectral.spectral_kktsolver(None)}[backend]
    # a solution is the caller's: later calls leave it as it was
    for seed, sol, kept in sols:
        np.testing.assert_array_equal(sol.y.numpy(), kept.y)
        np.testing.assert_array_equal(sol.v.numpy(), kept.v)
    for seed, sol, kept in sols[1:]:
        graph.clear()
        fresh, run = solve(make(seed))
        assert not run.cache_hit
        same_bits(sol, fresh)
        assert_same(reference(family, seed), kept, OPT_TOL)


def test_each_configuration_has_its_own_entry():
    graph.clear()
    H, c, A, b, cones, _, _ = box_with(30, 1)
    base = (H, c, A, b, cones)
    variants = {  # the parts of the key in which each differs from base
        (3, 4): (box_with(31, 1)[:5], {}),  # the shapes (and spec's size)
        (4,): ((H, c, A, b, [("R", 30), ("R", 30)]), {}),  # the spec
        # the backend, Schur, and with it the options (one corrector)
        (5, 6): ((H + 0.01, c, A, b, cones), {}),
        (6,): (base, dict(optTol=1e-7)),  # an option
    }
    solve(base)
    (key,) = graph.cache_info()
    assert key[5] is pt.kktsolver_diag
    for part, (args, kw) in variants.items():
        solve(args, **kw)
        other = graph.cache_info()[-1]
        assert tuple(i for i in range(len(key))
                     if other[i] != key[i]) == part
    # the bound: the fifth configuration evicted the least recently used
    assert len(graph.cache_info()) == graph.CACHE_SIZE == 4
    assert key not in graph.cache_info()
    # a hit moves its entry to the back
    _, run = solve(variants[(4,)][0])
    assert run.cache_hit and graph.cache_info()[-1][4] != key[4]
    # a warm start is a configuration of its own
    first = pt.conic_ip(*base, device="cpu")
    _, run = solve(base, warm_start=first)
    assert not run.cache_hit and graph.cache_info()[-1][-2] is False
    graph.clear()
    assert graph.cache_info() == []


@contextlib.contextmanager
def counted_builds():
    """Count the built-in generators' level-2 calls (one per KKT build):
    the inner factories of the diag, Schur and spectral backends wrapped,
    their generators counted. The wrappers keep their contracts (one
    variant, no ``mode``)."""
    calls = []

    def spy(make):
        def factory(*args, **kw):
            gen = make(*args, **kw)

            def counted(F, FinvT):
                calls.append(1)
                return gen(F, FinvT)
            return counted
        return factory

    with pytest.MonkeyPatch.context() as mp:
        for mod, name in ((schur, "kktsolver_2x2"),
                          (diag, "kktsolver_2x2_diag"),
                          (spectral, "kktsolver_spectral")):
            mp.setattr(mod, name, spy(getattr(mod, name)))
        yield calls


@pytest.mark.parametrize("family", list(FAMILIES))
def test_the_rotated_loop_builds_and_refines_as_the_eager_loop(family,
                                                               monkeypatch):
    args = FAMILIES[family][0](SEEDS[0])
    graph.clear()
    with counted_builds() as calls:
        sol, run = solve(args)
    device_builds = len(calls)
    # the eager loop, which the device loop takes verbose output from too:
    # the rule overridden for this call
    monkeypatch.setattr(pt_solver, "_eager_reason",
                        lambda *a: "the eager loop, for comparison")
    with counted_builds() as calls, \
            contextlib.redirect_stdout(io.StringIO()) as out:
        eager = pt.conic_ip(*args, device="cpu", verbose=True)
    (erun,) = pt_solver.runs
    assert erun.loop == "eager"
    same_bits(sol, eager)
    # the cold start's build and one per step; no step after the last
    # evaluation, as the eager loop and the reference stop
    assert device_builds == len(calls) == 1 + erun.fast_steps
    assert run.fast_steps == erun.fast_steps
    # refinement trips: the verbose table's `refine` column is the
    # previous step's trips + 1 (every step's, the last row included)
    rows = [line.split("│") for line in out.getvalue().splitlines()
            if line.count("│") == 4 and "Iter" not in line]
    table = sum(int(r[-1].strip().split("\x1b")[0]) - 1 for r in rows[1:])
    assert run.trips == erun.trips == table
