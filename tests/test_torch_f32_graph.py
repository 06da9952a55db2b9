"""The f32 options on the device loop of ``conicip_tpu_torch``, on the CPU.

The reference runs every f32 solve inside one compiled program: the
last-mile flag is part of its ``while_loop`` carry, ``lax.cond`` picks the
variant, and the mixed-residual recompute is ``cond_once``. The port's
device loop carries the flag, the products and their drift on the device
and hands each variant's scaling and step, and the recompute, to a
``branch`` (on CUDA a conditional graph node; here the chunks run eagerly,
``ipm.run_chunks``, each body masked). These tests hold, for the f32
Schur generator with the last-mile switch and mixed residuals, the f32
diagonal backend with mixed residuals, f32 S-cone decompositions under
``fastEig``, f32 factors in an f32 working dtype, and a stack whose
instances sit on both variants:

- the chunked loop against the eager loop on the same operands, bit for
  bit, with the same steps per variant, recomputes, refinement trips and
  KKT builds per precision (a build inside a body counted only where its
  predicate held, as a conditional node runs it);
- ``conic_ip`` / ``solve_batch`` on the CPU against ``conicip_tpu``, by
  ``tests/test_torch_mixed.py``'s f32 criteria;
- a first chunk that reads nothing back.
"""

from collections import Counter
from types import SimpleNamespace

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import conicip_tpu as ct
import conicip_tpu.parallel as ct_parallel
from conicip_tpu.kkt import kktsolver_schur as jax_schur
from conicip_tpu.parallel.batch import make_batched_solver as jax_batched
import conicip_tpu_torch as pt
from conicip_tpu_torch import solver as pt_solver
from conicip_tpu_torch.cones.spec import ConeSpec
from conicip_tpu_torch.kkt.pivot import accepts_mode
from conicip_tpu_torch.models import batched_box_qp, box_qp_dense, mixed_rqs
from conicip_tpu_torch.parallel import batch as pt_batch
from conicip_tpu_torch.solver import _auto_kktsolver, _default_kktsolver
from conicip_tpu_torch.solver import graph, ipm
from conicip_tpu_torch.solver.state import STATUS_NAMES
from test_torch_graph import guarded_first_chunk
from test_torch_mixed import assert_close_to_reference, readme_box, y_f64

torch.set_num_threads(1)

F32 = torch.float32


def s_cone_mix():
    """mixed_rqs (R, Q and S cones) with a dense Q, so that the automatic
    backend is the dense Schur solver, not the spectral one."""
    Q, c, A, b, cones, _, _ = mixed_rqs().args()
    B = np.random.default_rng(5).standard_normal((len(c), len(c)))
    return Q + B @ B.T / (4 * len(c)), c, A, b, cones, None, None


def split_stack():
    """Four box QPs whose instances enter the last-mile variant on
    different iterations."""
    return batched_box_qp(4, n=24, seed=4) + (None, None)


# name: (problem, ipm options, working dtype); the options are those
# conic_ip gives the automatic backend with factor_dtype=float32
CONFIGS = {
    "schur f32, last mile, mixed": (
        lambda: box_qp_dense(n=30).args(),
        dict(mixedResiduals=True, lastmileProactive=50.0,
             centralityCorrectors=1), torch.float64),
    "diag f32, mixed, equality": (
        lambda: readme_box(eq=True),
        dict(mixedResiduals=True, lastmileProactive=50.0), torch.float64),
    "S cones, fastEig, last mile": (
        s_cone_mix,
        dict(mixedResiduals=True, lastmileProactive=50.0,
             centralityCorrectors=1), torch.float64),
    "f32 factors, f32 dtype": (
        lambda: box_qp_dense(n=30).args(),
        dict(lastmileProactive=50.0, centralityCorrectors=1, optTol=1e-4),
        F32),
    "stack of 4, both variants": (
        split_stack,
        dict(mixedResiduals=True, lastmileProactive=50.0, optTol=1e-9),
        torch.float64),
}


def operands(name):
    """The configuration's operands as tensors, its spec, its KKT
    generator (the f32 last-mile Schur generator for the stack, the
    automatic choice otherwise) and its options."""
    make, opts, dtype = CONFIGS[name]
    Q, c, A, b, cones, G, d = make()
    spec = ConeSpec(cones)
    if c.ndim > 1:
        kkt = _default_kktsolver(F32, lastmile=True)
    else:
        kkt = _auto_kktsolver(Q, A, G, spec, F32)
    bs, n = c.shape[:-1], c.shape[-1]
    G = np.zeros(bs + (0, n)) if G is None else G
    d = np.zeros(bs + (0,)) if d is None else d
    args = tuple(torch.as_tensor(np.asarray(x), dtype=dtype)
                 for x in (Q, c, A, b, G, d))
    return args, spec, kkt, ipm.IPMOptions(**opts)


def counting(kkt, calls):
    """``kkt`` with each KKT build (level-2 call) recorded by its
    variant: "fast" (the factor dtype's, or the only variant) or "slow"."""
    def factory(Q, A, G, spec):
        gen = kkt(Q, A, G, spec)
        if not accepts_mode(gen):
            def counted(F, FinvT):
                calls.append("fast")
                return gen(F, FinvT)
            return counted

        def counted_mode(F, FinvT, mode="fast"):
            calls.append(mode)
            return gen(F, FinvT, mode=mode)
        return counted_mode
    return factory


def attributed_chunks(calls):
    """``ipm.run_chunks`` with each body masked, as on the CPU, and the
    KKT builds inside a body kept only where its predicate held: the
    builds a conditional graph node would run."""
    held = []

    def branch(pred, body):
        mark = len(calls)
        out = body()
        held.append((pred, calls[mark:]))
        del calls[mark:]
        return out

    def loop(prologue, inputs):
        body, cy = prologue(*inputs)
        polls = 1
        while bool(body.active(cy)):
            for _ in range(ipm.POLL):
                cy = body.unit(cy, branch)
            polls += 1
        for pred, made in held:
            if bool(pred):
                calls.extend(made)
        return cy, dict(polls=polls, replays=0,
                        units=ipm.POLL * (polls - 1), loop="chunks")

    return loop


def same_bits(a, b):
    for f in ("y", "w", "v", "status", "Iter", "Mu", "prFeas", "duFeas",
              "muFeas", "pobj", "dobj"):
        x, y = getattr(a, f), getattr(b, f)
        assert torch.equal(torch.isnan(x), torch.isnan(y)), f
        assert torch.equal(torch.nan_to_num(x), torch.nan_to_num(y)), f


@pytest.mark.parametrize("poll", [1, 3])
@pytest.mark.parametrize("name", list(CONFIGS))
def test_the_chunked_loop_is_the_eager_loop(name, poll, monkeypatch):
    monkeypatch.setattr(ipm, "POLL", poll)
    args, spec, kkt, opts = operands(name)
    eager_builds, chunk_builds = [], []
    est, cst = {}, {}
    eager = ipm.ipm_solve(*args, spec, counting(kkt, eager_builds), opts,
                          stats=est)
    chunked = ipm.ipm_solve(*args, spec, counting(kkt, chunk_builds), opts,
                            stats=cst,
                            device_loop=attributed_chunks(chunk_builds))
    plain = ipm.ipm_solve(*args, spec, kkt, opts, device_loop=ipm.run_chunks)
    assert (est["loop"], cst["loop"]) == ("eager", "chunks")
    same_bits(eager, chunked)
    same_bits(eager, plain)
    for k in ("fast_steps", "slow_steps", "recertified", "trips"):
        assert cst[k] == est[k], k
    # builds per precision: the cold start's (fast) and one per step on
    # each variant, a split stack's iterations on both. A single-variant
    # generator's step is no body: a frozen unit (the solve ended inside a
    # chunk) builds too, as on the f64 path
    assert Counter(eager_builds) == Counter(
        fast=1 + est["fast_steps"], slow=est["slow_steps"])
    frozen = 0
    if not accepts_mode(kkt(*args[:1], *args[2:3], *args[4:5], spec)):
        frozen = poll * (cst["polls"] - 1) - est["fast_steps"]
    assert Counter(chunk_builds) == Counter(eager_builds) + Counter(
        fast=frozen)
    if opts.mixedResiduals:
        assert est["recertified"] > 0
    if "last mile" in name or "both" in name:
        assert est["slow_steps"] > 0
    if "both" in name:
        # steps taken: one per read, less the recomputes' second reads and
        # the last iteration's
        steps = est["polls"] - est["recertified"] - 1
        assert est["fast_steps"] + est["slow_steps"] > steps


# conic_ip's keywords per configuration, for both packages
API = {
    "schur f32, last mile, mixed": dict(factor_dtype=F32),
    "diag f32, mixed, equality": dict(factor_dtype=F32,
                                      eliminateEqualities=False),
    "S cones, fastEig, last mile": dict(factor_dtype=F32),
    "f32 factors, f32 dtype": dict(factor_dtype=F32, dtype=F32, optTol=1e-4),
}


def jax_kw(kw):
    return {k: jnp.float32 if v is F32 else v for k, v in kw.items()}


@pytest.mark.parametrize("name", list(API))
def test_conic_ip_runs_f32_on_the_device_loop_and_matches_jax(name):
    args = CONFIGS[name][0]()
    kw = API[name]
    sol = pt.solution_to_numpy(pt.conic_ip(*args, device="cpu", **kw))
    runs = list(pt_solver.runs)
    assert runs[0].loop == "chunks"
    assert all(r.loop == "chunks" for r in runs)
    ref = ct.conic_ip(*args, **jax_kw(kw))
    assert_close_to_reference(name, ref, sol, y_f64(args),
                              opt_tol=kw.get("optTol", 1e-6))


def assert_stack_close(name, ref, got, y64, opt_tol):
    """test_torch_mixed's f32 criteria, instance by instance."""
    def one(s, i):
        return SimpleNamespace(
            status=s.statuses[i] if hasattr(s, "statuses")
            else STATUS_NAMES[int(s.status[i])],
            Iter=int(s.Iter[i]), y=np.asarray(s.y[i]),
            **{f: float(getattr(s, f)[i])
               for f in ("prFeas", "duFeas", "muFeas")})

    for i in range(len(y64)):
        assert_close_to_reference(f"{name}[{i}]", one(ref, i), one(got, i),
                                  y64[i], opt_tol=opt_tol)


def f64_stack(opt_tol):
    Q, c, A, b, cones, _, _ = split_stack()
    sol = pt.solve_batch(Q, c, A, b, cones, device="cpu", optTol=opt_tol)
    assert sol.statuses == ["Optimal"] * 4
    return sol.y.numpy()


def test_solve_batch_runs_f32_stacks_on_the_device_loop_and_matches_jax():
    # the checkpoint loop's configuration (no backstop) and the default
    # one (its fused tiers behind the main run)
    Q, c, A, b, cones, _, _ = split_stack()
    y64 = f64_stack(1e-8)
    for backstop in (False, True):
        got = pt.batch_solution_to_numpy(pt.solve_batch(
            Q, c, A, b, cones, device="cpu", factor_dtype=F32,
            backstop=backstop, optTol=1e-8))
        assert [r.loop for r in pt_batch.runs] == ["chunks"] * len(
            pt_batch.runs)
        assert pt_batch.runs[0].recertified > 0
        ref = ct_parallel.solve_batch(Q, c, A, b, cones,
                                      factor_dtype=jnp.float32,
                                      backstop=backstop, optTol=1e-8)
        assert got.statuses == ref.statuses == ["Optimal"] * 4
        assert_stack_close(f"backstop={backstop}", ref, got, y64, 1e-8)


def test_a_stack_split_across_variants_matches_jax():
    # the two-variant generator on a stack, through the device loop's
    # cache, against the reference's jit(vmap(ipm_solve))
    args, spec, kkt, opts = operands("stack of 4, both variants")
    graph.clear()
    stats = {}
    st = graph.solve(*args, spec, kkt, opts, stats=stats)
    assert stats["loop"] == "chunks" and stats["slow_steps"] > 0
    Q, c, A, b, cones, _, _ = split_stack()
    n = c.shape[-1]
    jkkt = lambda *a: jax_schur(*a, factor_dtype=jnp.float32,  # noqa: E731
                                lastmile=True)
    ref = jax_batched(ct.ConeSpec(cones), jkkt, ct.IPMOptions(
        mixedResiduals=True, lastmileProactive=50.0, optTol=1e-9))(
        *(jnp.asarray(x) for x in (Q, c, A, b)), jnp.zeros((4, 0, n)),
        jnp.zeros((4, 0)))
    assert st.status.tolist() == np.asarray(ref.status).tolist()
    assert_stack_close("split stack", ref, st, f64_stack(1e-9), 1e-9)


@pytest.mark.parametrize("name", list(CONFIGS))
def test_a_first_f32_chunk_reads_nothing_back(name):
    args, spec, kkt, opts = operands(name)
    stats = {}
    guarded = ipm.ipm_solve(*args, spec, kkt, opts, stats=stats,
                            device_loop=guarded_first_chunk)
    assert stats["polls"] >= 2
    same_bits(guarded, ipm.ipm_solve(*args, spec, kkt, opts))
