"""Distribution in the port: make_mesh, distributed_normal_matrix,
kktsolver_schur_tp and solve_batch(mesh=...) on gloo worlds on the CPU.

One world of four ranks is spawned per module (the ``world`` fixture, a
``file://`` rendezvous, one thread per rank, a join timeout that kills the
ranks): every rank runs every case of ``CASES`` and saves what it got, and
the tests read it. Run as a script, this file is one rank of that world.

Held against the JAX package (``conicip_tpu.parallel`` on four of the
virtual CPU devices, the same inputs made with numpy from a seed):
``distributed_normal_matrix`` to 1e-10; the distributed factor kernel's
``W``, ``dscale`` and ``Y`` to 1e-13 and its apply to 1e-12; the ``pad``
and ``rqs_eq`` TP solves with the same status and ``Iter`` and ``y`` to
1e-8. Held against the port's own single solve (0 centrality correctors, as
the reference's tests hold theirs): ``y`` to 1e-6; the cone-sharded against
the replicated scaling to 1e-8; sharded stacks per instance equal to the
unsharded stack (status, ``Iter``, ``y`` to 1e-12). Every rank must end
with the same bits.
"""

import argparse
import os
import subprocess
import sys
import time
import traceback
from pathlib import Path

import numpy as np
import pytest
import torch

REPO = Path(__file__).resolve().parents[1]
WORLD = 4
WORLD_TIMEOUT = 240.0  # seconds the spawned world may take in all

# (cones, p) of the TP solves, as tests/test_parallel.py states them; n = 19
TP_SPECS = {
    "pad": ([("R", 21)], 0),  # nothing divisible by the mesh: padding
    "eq": ([("R", 24)], 3),  # equalities through the sharded couplings
    "soc": ([("R", 10), ("Q", 5), ("Q", 5)], 0),  # SOC groups
    "rqs_eq": ([("R", 8), ("Q", 4), ("S", 10)], 2),  # R+Q+S, equalities
    "wide_eq": ([("R", 24)], 5),  # p = 5 > r = 5: wider than a panel
}
# three SOCs and one SDP over four ranks: padded cone groups
SHARDED_CONES = [("R", 9), ("Q", 4), ("Q", 4), ("Q", 4), ("S", 6)]
RQS = [("R", 8), ("Q", 4), ("S", 10)]


def tp_problem(n, cones, p=0, seed=1):
    """The reference's TP test problem (tests/test_parallel.py): strictly
    feasible, A y0 - b the cone identity."""
    from conicip_tpu_torch.cones.spec import ConeSpec

    rng = np.random.default_rng(seed)
    B = rng.standard_normal((n, n))
    Q = B.T @ B / n + np.eye(n)
    c = rng.standard_normal(n)
    m = sum(d for _, d in cones)
    A = rng.standard_normal((m, n)) * 0.3
    y0 = rng.standard_normal(n) * 0.1
    b = A @ y0 - ConeSpec(cones).identity
    G = rng.standard_normal((p, n)) if p else np.zeros((0, n))
    d = G @ y0 if p else np.zeros(0)
    return Q, c, A, b, G, d


def factor_data(n=64, p=3):
    """Inputs of the factor-kernel check: Atilᵀ Atil + I = Msym, G, x."""
    rng = np.random.default_rng(0)
    B = rng.standard_normal((n, n))
    Msym = B.T @ B + n * np.eye(n)
    Atil = np.linalg.cholesky(Msym - np.eye(n)).T
    G = rng.standard_normal((p, n))
    x = rng.standard_normal(n)
    return Msym, Atil, G, x


def normal_data(m):
    rng = np.random.default_rng(0)
    n = 12
    return np.eye(n), rng.standard_normal((m, n)), rng.uniform(0.5, 2.0, m)


# ── the cases every rank runs ──


def _solution(sol):
    return dict(status=sol.status, Iter=sol.Iter, y=sol.y.clone(),
                resid=max(sol.prFeas, sol.duFeas, sol.muFeas))


def _batch(bs):
    return dict(status=bs.status.clone(), Iter=bs.Iter.clone(),
                y=bs.y.clone(), w=bs.w.clone())


def case_normal(ctx):
    from conicip_tpu_torch.parallel import distributed_normal_matrix

    return {m: distributed_normal_matrix(*normal_data(m), ctx["tp"], "tp")
            for m in (32, 30)}


def case_factor(ctx):
    from conicip_tpu_torch.parallel.distributed import (_make_apply,
                                                        _make_factor_kernel)

    _, Atil, G, x = factor_data()
    n, p = Atil.shape[0], G.shape[0]
    T = lambda a: torch.as_tensor(a, dtype=torch.float64)  # noqa: E731
    factor = _make_factor_kernel(ctx["tp"], "tp", n, p, torch.float64)
    W, dscale, Y, ok = factor(T(Atil), torch.eye(n, dtype=torch.float64),
                              T(G), T(1.0), T(30 * np.finfo(float).eps))
    x_out = _make_apply(ctx["tp"], "tp", n)(W, dscale, T(x))
    return dict(W=W, dscale=dscale, Y=Y, ok=ok, apply=x_out)


def _tp_solve(ctx, cones, p, n=19, **kkt_kw):
    import conicip_tpu_torch as pt

    Q, c, A, b, G, d = tp_problem(n, cones, p)
    kkt = pt.kktsolver_schur_tp(ctx["tp"], "tp", **kkt_kw)
    return _solution(pt.conic_ip(Q, c, A, b, cones, G=G, d=d, kktsolver=kkt,
                                 optTol=1e-7, device="cpu"))


def case_tp(ctx):
    return {name: _tp_solve(ctx, cones, p)
            for name, (cones, p) in TP_SPECS.items()}


def case_scaling(ctx):
    return {flag: _tp_solve(ctx, SHARDED_CONES, 2, n=21, shard_scaling=flag)
            for flag in (True, False)}


def case_replicated_factor(ctx):
    return _tp_solve(ctx, RQS, 0, distributed_factor=False)


def case_f32(ctx):
    import conicip_tpu_torch as pt

    cones = TP_SPECS["soc"][0]
    Q, c, A, b, G, d = tp_problem(19, cones, 0)
    kkt = pt.kktsolver_schur_tp(ctx["tp"], "tp", factor_dtype=torch.float32)
    return _solution(pt.conic_ip(Q, c, A, b, cones, kktsolver=kkt,
                                 mixedResiduals=True, optTol=1e-7,
                                 device="cpu"))


def _stack_pair(ctx, mesh, axis, args, **kw):
    """The stack sharded over ``mesh`` and, on rank 0, unsharded."""
    import conicip_tpu_torch as pt

    out = dict(sharded=_batch(pt.solve_batch(*args, mesh=mesh,
                                             batch_axis=axis, device="cpu",
                                             **kw)))
    if ctx["rank"] == 0:
        out["plain"] = _batch(pt.solve_batch(*args, device="cpu", **kw))
    return out


def case_batch(ctx):
    from conicip_tpu_torch.models import batched_box_qp

    args = batched_box_qp(batch=16, n=16)
    return {"batch": _stack_pair(ctx, ctx["batch"], "batch", args,
                                 optTol=1e-6),
            "dp_tp": _stack_pair(ctx, ctx["grid"], ("dp", "tp"), args,
                                 optTol=1e-6)}


def case_warm(ctx):
    import conicip_tpu_torch as pt
    from conicip_tpu_torch.models import batched_box_qp

    args = batched_box_qp(batch=16, n=16)
    cold = pt.solve_batch(*args, mesh=ctx["batch"], optTol=1e-7,
                          device="cpu")
    warm = pt.solve_batch(*args, mesh=ctx["batch"], optTol=1e-7,
                          device="cpu", warm_start=cold)
    out = dict(cold=_batch(cold), warm=_batch(warm))
    if ctx["rank"] == 0:
        plain = pt.solve_batch(*args, optTol=1e-7, device="cpu",
                               warm_start=pt.solve_batch(
                                   *args, optTol=1e-7, device="cpu"))
        out["plain_warm"] = _batch(plain)
    return out


def case_eliminated(ctx):
    import conicip_tpu_torch as pt
    from conicip_tpu_torch.models import batched_mixed_rq_eq

    Q, c, A, b, cones, G, d = batched_mixed_rq_eq(batch=8, n=32)
    kw = dict(factor_dtype=torch.float32, optTol=1e-7, device="cpu")
    cold = pt.solve_batch(Q, c, A, b, cones, G, d, mesh=ctx["batch"], **kw)
    warm = pt.solve_batch(Q, c, A, b, cones, G, d, mesh=ctx["batch"],
                          warm_start=cold, **kw)
    out = dict(cold=_batch(cold), warm=_batch(warm))
    if ctx["rank"] == 0:
        out["plain"] = _batch(pt.solve_batch(Q, c, A, b, cones, G, d, **kw))
    return out


def case_resumable(ctx):
    from conicip_tpu_torch.models import batched_box_qp
    from conicip_tpu_torch.parallel import load_snapshot, solve_batch_resumable

    args = batched_box_qp(batch=8, n=12)
    store = str(ctx["out"] / "sharded.npz")
    kw = dict(chunk_iters=4, optTol=1e-7, device="cpu")
    first = solve_batch_resumable(*args, store=store, mesh=ctx["batch"], **kw)
    again = solve_batch_resumable(*args, store=store, mesh=ctx["batch"], **kw)
    info = load_snapshot(store)
    out = dict(first=_batch(first), again=_batch(again),
               done=info.done, iters_done=info.iters_done)
    if ctx["rank"] == 0:
        out["plain"] = _batch(solve_batch_resumable(
            *args, store=str(ctx["out"] / "plain.npz"), **kw))
    return out


def case_errors(ctx):
    import conicip_tpu_torch as pt
    from conicip_tpu_torch.models import batched_box_qp

    got = {}
    for name, call in (
            ("mesh_size", lambda: pt.make_mesh((3,), ("tp",),
                                               device_type="cpu")),
            ("indivisible", lambda: pt.solve_batch(
                *batched_box_qp(batch=6, n=8), mesh=ctx["batch"],
                device="cpu")),
            ("device", lambda: pt.solve_batch(
                *batched_box_qp(batch=8, n=8), mesh=ctx["batch"])),
            ("axis", lambda: pt.kktsolver_schur_tp(ctx["grid"], "batch"))):
        try:
            call()
            got[name] = None
        except (ValueError, TypeError) as e:
            got[name] = (type(e).__name__, str(e))
    return got


def case_dryrun(ctx):
    from conicip_tpu_torch.parallel import dryrun

    bs = dryrun.dp_leg(ctx["grid"], "cpu")
    sol = dryrun.tp_leg(ctx["grid"], "cpu")
    return dict(dp=bs.statuses, tp=sol.status, tp_y=sol.y.clone())


CASES = {name[5:]: fn for name, fn in list(globals().items())
         if name.startswith("case_")}


def rank_main(rank, init, out):
    """One rank of the world: every case, its results saved to
    ``out/rank<k>.pt`` (a case that raised saves its traceback)."""
    import torch.distributed as dist

    from conicip_tpu_torch.parallel.mesh import make_mesh, start_rank

    torch.set_num_threads(1)
    res = {}
    try:
        make_mesh((WORLD,), ("tp",), device_type="cpu")
    except RuntimeError as e:
        res["no_group"] = str(e)
    start_rank(rank, WORLD, init, "cpu", timeout=60)
    ctx = dict(rank=rank, out=out,
               tp=make_mesh((WORLD,), ("tp",), device_type="cpu"),
               batch=make_mesh((WORLD,), ("batch",), device_type="cpu"),
               grid=make_mesh((2, 2), ("dp", "tp"), device_type="cpu"))
    for name, case in CASES.items():
        t = time.perf_counter()
        try:
            res[name] = case(ctx)
        except Exception:  # recorded for the test that reads this case
            res[name] = {"error": traceback.format_exc()}
        res[f"{name}_seconds"] = time.perf_counter() - t
    torch.save(res, out / f"rank{rank}.pt")
    dist.destroy_process_group()


# ── the tests ──


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    from conicip_tpu_torch.parallel.mesh import spawn_world

    out = tmp_path_factory.mktemp("world")
    env = dict(os.environ)
    env["PYTHONPATH"] = os.pathsep.join(
        [str(REPO)] + [p for p in [env.get("PYTHONPATH")] if p])
    w = spawn_world(lambda k, init: [sys.executable, __file__, "--rank",
                                     str(k), "--init", init, "--out",
                                     str(out)],
                    WORLD, WORLD_TIMEOUT, env=env)
    assert w.ok, (f"world exit codes {w.codes}, timed out {w.timed_out}:\n"
                  + "\n".join(w.err))
    return [torch.load(out / f"rank{k}.pt") for k in range(WORLD)]


def result(world, name):
    """A case's results on every rank, with the rank's traceback where it
    raised."""
    got = [r[name] for r in world]
    for k, g in enumerate(got):
        assert not (isinstance(g, dict) and "error" in g), \
            f"rank {k}, case {name}:\n{g['error']}"
    return got


def same_on_every_rank(values):
    """Every rank got the same bits."""
    first = values[0]
    for v in values[1:]:
        if isinstance(first, torch.Tensor):
            assert torch.equal(v, first)
        elif isinstance(first, dict):
            assert v.keys() == first.keys()
            for k in first:
                same_on_every_rank([first[k], v[k]])
        else:
            assert v == first


@pytest.fixture(scope="module")
def reference():
    """The JAX package on four of the virtual CPU devices."""
    import jax
    import jax.numpy as jnp

    import conicip_tpu as ct
    from conicip_tpu.parallel import (distributed_normal_matrix,
                                      kktsolver_schur_tp, make_mesh)
    from conicip_tpu.parallel.distributed import (_make_apply,
                                                  _make_factor_kernel)

    mesh = make_mesh((WORLD,), ("tp",), devices=jax.devices()[:WORLD])
    Msym, Atil, G, x = factor_data()
    n, p = Atil.shape[0], G.shape[0]
    W, dscale, Y, ok = _make_factor_kernel(mesh, "tp", n, p, jnp.float64)(
        jnp.asarray(Atil), jnp.eye(n), jnp.asarray(G), jnp.asarray(1.0),
        jnp.asarray(30 * np.finfo(float).eps))
    out = dict(
        normal=np.asarray(distributed_normal_matrix(*normal_data(32), mesh,
                                                    "tp")),
        factor=dict(W=np.asarray(W), dscale=np.asarray(dscale),
                    Y=np.asarray(Y), ok=bool(ok),
                    apply=np.asarray(_make_apply(mesh, "tp", n)(
                        W, dscale, jnp.asarray(x)))))
    for name in ("pad", "rqs_eq"):
        cones, p = TP_SPECS[name]
        Q, c, A, b, G, d = tp_problem(19, cones, p)
        sol = ct.conic_ip(Q, c, A, b, cones, G=G, d=d, optTol=1e-7,
                          kktsolver=kktsolver_schur_tp(mesh, "tp"))
        out[name] = dict(status=sol.status, Iter=int(sol.Iter),
                         y=np.asarray(sol.y))
    return out


def single(cones, p, n=19):
    """The port's own single-device solve, 0 centrality correctors."""
    import conicip_tpu_torch as pt

    torch.set_num_threads(1)
    Q, c, A, b, G, d = tp_problem(n, cones, p)
    return pt.conic_ip(Q, c, A, b, cones, G=G, d=d, optTol=1e-7,
                       centralityCorrectors=0, device="cpu")


def test_make_mesh_needs_a_started_process_group(world):
    for r in world:
        assert "torch.distributed.init_process_group" in r["no_group"]


def test_distributed_normal_matrix_matches_the_reference(world, reference):
    got = result(world, "normal")
    same_on_every_rank(got)
    np.testing.assert_allclose(got[0][32].numpy(), reference["normal"],
                               rtol=0, atol=1e-10)
    Q, A, dinv = normal_data(30)  # rows the mesh does not divide
    At = A * dinv[:, None]
    np.testing.assert_allclose(got[0][30].numpy(), Q + At.T @ At, rtol=0,
                               atol=1e-10)


def test_tp_factor_kernel_matches_the_reference(world, reference):
    got = result(world, "factor")
    ref = reference["factor"]
    assert ref["ok"] and all(g["ok"] for g in got)
    W = torch.cat([g["W"] for g in got], dim=1).numpy()  # column blocks
    np.testing.assert_allclose(W, ref["W"], rtol=0, atol=1e-13)
    for k in ("dscale", "Y", "apply"):
        same_on_every_rank([g[k] for g in got])
    np.testing.assert_allclose(got[0]["dscale"].numpy(), ref["dscale"],
                               rtol=0, atol=1e-13)
    np.testing.assert_allclose(got[0]["Y"].numpy(), ref["Y"], rtol=0,
                               atol=1e-13)
    np.testing.assert_allclose(got[0]["apply"].numpy(), ref["apply"],
                               rtol=0, atol=1e-12)


def test_tp_factor_kernel_is_exact(world):
    # W = L⁻¹ of the equilibrated, ridged M + GᵀG, as numpy gives it
    got = result(world, "factor")
    Msym, _, G, x = factor_data()
    n = Msym.shape[0]
    ridge = 30 * np.finfo(float).eps
    dscale = got[0]["dscale"].numpy()
    Mtil = Msym + G.T @ G
    Ms = Mtil * dscale[:, None] * dscale[None, :]
    Wref = np.linalg.inv(np.linalg.cholesky(Ms + ridge * np.eye(n)))
    W = torch.cat([g["W"] for g in got], dim=1).numpy()
    np.testing.assert_allclose(W, Wref, rtol=0, atol=1e-15 * n)
    np.testing.assert_allclose(got[0]["apply"].numpy(),
                               np.linalg.solve(Mtil, x), rtol=0, atol=1e-12)


@pytest.mark.parametrize("name", ["pad", "rqs_eq"])
def test_tp_solve_matches_the_reference(world, reference, name):
    got = [r[name] for r in result(world, "tp")]
    same_on_every_rank(got)
    ref = reference[name]
    assert (got[0]["status"], got[0]["Iter"]) == (ref["status"], ref["Iter"])
    np.testing.assert_allclose(got[0]["y"].numpy(), ref["y"], rtol=0,
                               atol=1e-8)


@pytest.mark.parametrize("name", list(TP_SPECS))
def test_tp_solve_matches_the_single_solve(world, name):
    got = [r[name] for r in result(world, "tp")]
    same_on_every_rank(got)
    one = single(*TP_SPECS[name])
    assert got[0]["status"] == one.status == "Optimal"
    np.testing.assert_allclose(got[0]["y"].numpy(), one.y.numpy(), rtol=0,
                               atol=1e-6)


def test_tp_cone_sharded_scaling_matches_replicated(world):
    got = result(world, "scaling")
    same_on_every_rank(got)
    sharded, replicated = got[0][True], got[0][False]
    one = single(SHARDED_CONES, 2, n=21)
    assert sharded["status"] == replicated["status"] == "Optimal"
    np.testing.assert_allclose(sharded["y"].numpy(), replicated["y"].numpy(),
                               rtol=0, atol=1e-8)
    np.testing.assert_allclose(sharded["y"].numpy(), one.y.numpy(), rtol=0,
                               atol=1e-6)


def test_tp_replicated_factor_matches_the_single_solve(world):
    got = result(world, "replicated_factor")
    same_on_every_rank(got)
    one = single(RQS, 0)
    assert got[0]["status"] == "Optimal"
    np.testing.assert_allclose(got[0]["y"].numpy(), one.y.numpy(), rtol=0,
                               atol=1e-6)


def test_tp_f32_factor_with_mixed_residuals(world):
    got = result(world, "f32")
    same_on_every_rank(got)
    assert got[0]["status"] == "Optimal" and got[0]["resid"] < 1e-7


def assert_stacks_equal(a, b):
    assert torch.equal(a["status"], b["status"])
    assert torch.equal(a["Iter"], b["Iter"])
    np.testing.assert_allclose(a["y"].numpy(), b["y"].numpy(), rtol=0,
                               atol=1e-12)


@pytest.mark.parametrize("mesh", ["batch", "dp_tp"])
def test_sharded_stack_equals_the_unsharded(world, mesh):
    got = [r[mesh] for r in result(world, "batch")]
    same_on_every_rank([g["sharded"] for g in got])
    assert (got[0]["plain"]["status"] == 1).all()  # Optimal
    assert_stacks_equal(got[0]["sharded"], got[0]["plain"])


def test_sharded_warm_start(world):
    got = result(world, "warm")
    same_on_every_rank([{k: g[k] for k in ("cold", "warm")} for g in got])
    cold, warm = got[0]["cold"], got[0]["warm"]
    assert (warm["status"] == 1).all()
    assert warm["Iter"].max() <= cold["Iter"].max()
    assert_stacks_equal(warm, got[0]["plain_warm"])


def test_sharded_eliminated_stack_and_its_warm_start(world):
    got = result(world, "eliminated")
    same_on_every_rank([{k: g[k] for k in ("cold", "warm")} for g in got])
    cold, warm = got[0]["cold"], got[0]["warm"]
    assert (cold["status"] == 1).all() and (warm["status"] == 1).all()
    assert warm["Iter"].double().mean() <= cold["Iter"].double().mean()
    assert_stacks_equal(cold, got[0]["plain"])


def test_resumable_solve_over_a_mesh(world):
    got = result(world, "resumable")
    same_on_every_rank([{k: g[k] for k in ("first", "again", "done")}
                        for g in got])
    first, again = got[0]["first"], got[0]["again"]
    assert got[0]["done"] and (first["status"] == 1).all()
    assert_stacks_equal(again, first)  # resumed a finished snapshot
    assert_stacks_equal(first, got[0]["plain"])


def test_distribution_rejects_what_it_cannot_do(world):
    got = result(world, "errors")
    same_on_every_rank(got)
    errs = got[0]
    assert errs["mesh_size"] == ("ValueError",
                                 "mesh (3,) does not match 4 ranks")
    kind, msg = errs["indivisible"]
    assert kind == "ValueError" and "divisible by 4" in msg
    assert errs["device"][0] == "ValueError" and "'cpu'" in errs["device"][1]
    assert errs["axis"][0] == "ValueError" and "'batch'" in errs["axis"][1]


def test_dryrun_legs_in_the_world(world):
    got = result(world, "dryrun")
    same_on_every_rank([g["dp"] for g in got])
    assert got[0]["dp"] == ["Optimal"] * 16
    assert all(g["tp"] == "Optimal" for g in got)
    # the two "tp" sub-groups each solved the problem: the same answer
    for g in got[1:]:
        assert torch.equal(g["tp_y"], got[0]["tp_y"])


def test_world_takes_well_under_its_timeout(world):
    seconds = sum(world[0][f"{name}_seconds"] for name in CASES)
    assert seconds < WORLD_TIMEOUT / 2


# ── a world of one, in this process ──


@pytest.fixture(scope="module")
def world_of_one(tmp_path_factory):
    import torch.distributed as dist

    from conicip_tpu_torch.parallel.mesh import start_rank

    init = "file://" + str(tmp_path_factory.mktemp("one") / "rendezvous")
    start_rank(0, 1, init, "cpu", timeout=60)
    yield
    dist.destroy_process_group()


def test_world_of_one_reproduces_the_single_path(world_of_one):
    import conicip_tpu_torch as pt
    from conicip_tpu_torch.kkt import kktsolver_schur

    torch.set_num_threads(1)
    mesh = pt.make_mesh((1,), ("tp",), device_type="cpu")
    for cones, p in (TP_SPECS["rqs_eq"], TP_SPECS["soc"]):
        Q, c, A, b, G, d = tp_problem(19, cones, p)
        kw = dict(G=G, d=d, optTol=1e-7, device="cpu")
        tp = pt.conic_ip(Q, c, A, b, cones,
                         kktsolver=pt.kktsolver_schur_tp(mesh, "tp"), **kw)
        one = pt.conic_ip(Q, c, A, b, cones, kktsolver=kktsolver_schur, **kw)
        assert (tp.status, tp.Iter) == (one.status, one.Iter)
        np.testing.assert_allclose(tp.y.numpy(), one.y.numpy(), rtol=0,
                                   atol=1e-8)


def test_world_of_one_stack_equals_the_unsharded(world_of_one):
    import conicip_tpu_torch as pt
    from conicip_tpu_torch.models import batched_box_qp

    torch.set_num_threads(1)
    args = batched_box_qp(batch=4, n=10)
    mesh = pt.make_mesh((1,), ("batch",), device_type="cpu")
    sharded = pt.solve_batch(*args, mesh=mesh, device="cpu")
    plain = pt.solve_batch(*args, device="cpu")
    assert_stacks_equal(_batch(sharded), _batch(plain))


def test_world_of_one_rejects_a_wrong_mesh_and_a_stack(world_of_one):
    import conicip_tpu_torch as pt
    from conicip_tpu_torch.models import batched_box_qp

    with pytest.raises(ValueError, match="does not match 1 ranks"):
        pt.make_mesh((2,), ("tp",), device_type="cpu")
    mesh = pt.make_mesh((1,), ("tp",), device_type="cpu")
    with pytest.raises(ValueError, match="one instance"):
        pt.solve_batch(*batched_box_qp(batch=2, n=6), device="cpu",
                       kktsolver=pt.kktsolver_schur_tp(mesh, "tp"))
    with pytest.raises(TypeError, match="make_mesh"):
        pt.kktsolver_schur_tp(object(), "tp")


def test_dryrun_module_on_the_cpu():
    # python -m conicip_tpu_torch.parallel.dryrun --cpu: its own four ranks
    env = dict(os.environ)
    env["PYTHONPATH"] = os.pathsep.join(
        [str(REPO)] + [p for p in [env.get("PYTHONPATH")] if p])
    proc = subprocess.run(
        [sys.executable, "-m", "conicip_tpu_torch.parallel.dryrun", "--cpu"],
        capture_output=True, text=True, timeout=WORLD_TIMEOUT, env=env)
    assert proc.returncode == 0, proc.stderr
    assert proc.stdout.count("{'Optimal': 16} + tp n=24 Optimal") == WORLD
    assert "dryrun OK" in proc.stdout


# ── spawn_world: no hang outlives its timeout ──


def test_spawn_world_kills_every_rank_at_its_timeout():
    from conicip_tpu_torch.parallel.mesh import spawn_world

    t = time.monotonic()
    w = spawn_world(lambda k, init: [sys.executable, "-c",
                                     "import time; time.sleep(60)"], 2, 1.0)
    assert w.timed_out and not w.ok and all(c < 0 for c in w.codes)
    assert time.monotonic() - t < 20


def test_spawn_world_kills_the_rest_when_a_rank_fails():
    from conicip_tpu_torch.parallel.mesh import spawn_world

    t = time.monotonic()
    w = spawn_world(lambda k, init: [
        sys.executable, "-c",
        "import sys, time; sys.exit(3) if sys.argv[1] == '0' "
        "else time.sleep(60)", str(k)], 2, 60.0)
    assert not w.timed_out and w.codes[0] == 3 and w.codes[1] < 0
    assert time.monotonic() - t < 20


if __name__ == "__main__":
    parser = argparse.ArgumentParser()
    parser.add_argument("--rank", type=int, required=True)
    parser.add_argument("--init", required=True)
    parser.add_argument("--out", type=Path, required=True)
    args = parser.parse_args()
    rank_main(args.rank, args.init, args.out)
