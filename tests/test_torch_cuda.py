"""Tests of the port that need an NVIDIA GPU (marker ``cuda``).

The CUDA kernel has no CPU mode, so each test skips where
``torch.cuda.is_available()`` is false. This file imports no JAX, so on a
machine with a card and without JAX it runs on its own:

    python -m pytest --noconftest -m cuda tests/test_torch_cuda.py
"""

import numpy as np
import pytest
import torch

import jacobi_model
from conicip_tpu_torch import conic_ip
from conicip_tpu_torch.models import box_qp_dense, single_soc, small_sdp
from conicip_tpu_torch.ops import batched, cholesky_kernel, jacobi_kernel

pytestmark = pytest.mark.cuda


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU; the CUDA kernel has no CPU mode")
    return torch.device("cuda")


def spd(n, seed=0):
    rng = np.random.default_rng(seed)
    B = rng.standard_normal((n, n))
    return B @ B.T / n + np.eye(n)


@pytest.mark.parametrize("dtype", ["float64", "float32"])
def test_kernel_matches_plain(cuda, dtype):
    # relative bounds: f64 rounding of two summation orders at n <= 1280,
    # f32 likewise (the TPU kernel's own type); sizes cover the one-launch
    # path (n <= 128) and ragged last panels
    dt = getattr(torch, dtype)
    tol = 1e-10 if dt == torch.float64 else 1e-4
    for n in (1, 31, 127, 128, 129, 255, 257, 500, 1000, 1024, 1280):
        M = torch.from_numpy(spd(n, seed=n)).to(cuda, dt)
        before = cholesky_kernel.launch_count(dt, n)
        others = cholesky_kernel.launch_count() - before
        L = cholesky_kernel.cholesky_factor(M)
        # counted once, under the entry point and the order that ran
        assert cholesky_kernel.launch_count(dt, n) == before + 1
        assert cholesky_kernel.launch_count() == before + 1 + others
        Lp = cholesky_kernel.cholesky_plain(M)
        assert ((L - Lp).abs().max() / Lp.abs().max()).item() <= tol
        assert torch.equal(L.triu(1), torch.zeros_like(L))
        bad = M.clone()
        bad[n // 2, n // 2] = -1.0
        L_bad = cholesky_kernel.cholesky_factor(bad)
        assert not bool(torch.isfinite(L_bad).all())


@pytest.mark.parametrize("dtype, kappa, bound",
                         [("float64", 1e12, 1e-13), ("float32", 1e5, 1e-5)])
def test_kernel_ill_conditioned(cuda, dtype, kappa, bound):
    # equilibrated SPD with condition number ~kappa: the explicit inverses
    # of the diagonal blocks keep the backward error at rounding level
    n = 500
    rng = np.random.default_rng(5)
    Q, _ = np.linalg.qr(rng.standard_normal((n, n)))
    M = (Q * np.logspace(0, -np.log10(kappa), n)) @ Q.T
    d = 1 / np.sqrt(np.diag(M))
    M = M * d[:, None] * d[None, :]
    M = torch.from_numpy((M + M.T) / 2).to(cuda, getattr(torch, dtype))
    L = cholesky_kernel.cholesky_factor(M)
    assert ((L @ L.T - M).abs().max() / M.abs().max()).item() <= bound


@pytest.mark.parametrize("p", [10, 200, 299])  # first, middle, last panel
def test_kernel_nan_from_failing_pivot(cuda, p):
    # a failing pivot at column p makes every entry on and below the
    # diagonal from column p on NaN, and nothing before it: the ridge retry
    # of the Schur solver reads isfinite(L).all()
    n = 300
    M = spd(n, seed=7)
    M[p, p] = -1.0
    for dt in (torch.float64, torch.float32):
        L = cholesky_kernel.cholesky_factor(torch.from_numpy(M).to(cuda, dt))
        i, c = np.indices((n, n))
        np.testing.assert_array_equal(torch.isnan(L).cpu().numpy(),
                                      (c >= p) & (i >= c))


BATCH_SHAPES = ((64, 500), (64, 200), (64, 86), (256, 55), (7, 129), (3, 1),
                (5, 257), (2, 1000),
                # more matrices than the card has SMs, above one panel: the
                # look-ahead factor_diag blocks outnumber the resident ones
                (600, 300), (2000, 129))


def spd_stack(B, n, seed=0):
    rng = np.random.default_rng(seed)
    X = rng.standard_normal((B, n, n))
    return X @ X.transpose(0, 2, 1) / n + np.eye(n)


@pytest.mark.parametrize("dtype", ["float64", "float32"])
@pytest.mark.parametrize("B, n", BATCH_SHAPES)
def test_batched_kernel_matches_plain_and_single(cuda, dtype, B, n):
    # the batched entry against the plain version (same relative bounds as
    # the single entry), and per matrix against the single entry, whose
    # arithmetic it repeats: equal bit for bit
    dt = getattr(torch, dtype)
    tol = 1e-10 if dt == torch.float64 else 1e-4
    M = torch.from_numpy(spd_stack(B, n, seed=n)).to(cuda, dt)
    before = cholesky_kernel.cholesky_launches[(dt, n, B)]
    singles = cholesky_kernel.launch_count(batch=False)
    L = cholesky_kernel.cholesky_factor(M)
    assert cholesky_kernel.cholesky_launches[(dt, n, B)] == before + 1
    assert cholesky_kernel.launch_count(batch=False) == singles
    Lp = cholesky_kernel.cholesky_plain(M)
    assert ((L - Lp).abs().max() / Lp.abs().max()).item() <= tol
    assert torch.equal(L.triu(1), torch.zeros_like(L))
    for i in sorted({0, B // 2, B - 1}):
        assert torch.equal(L[i], cholesky_kernel.cholesky_factor(
            M[i].contiguous()))
    # leading dims beyond one are a stack all the same
    if B % 2 == 0:
        L2 = cholesky_kernel.cholesky_factor(M.view(2, B // 2, n, n))
        assert torch.equal(L2.view(B, n, n), L)


@pytest.mark.parametrize("B, n, p", [(5, 300, 200), (9, 100, 37), (4, 129, 128)])
def test_batched_kernel_nan_stays_in_its_instance(cuda, B, n, p):
    # one indefinite matrix in the middle of the stack: NaN from its
    # failing pivot on, and every other factor what it was without it
    for dt in (torch.float64, torch.float32):
        M = torch.from_numpy(spd_stack(B, n, seed=3)).to(cuda, dt)
        good = cholesky_kernel.cholesky_factor(M)
        bad = M.clone()
        bad[B // 2, p, p] = -1.0
        L = cholesky_kernel.cholesky_factor(bad)
        i, c = np.indices((n, n))
        np.testing.assert_array_equal(
            torch.isnan(L[B // 2]).cpu().numpy(), (c >= p) & (i >= c))
        keep = [j for j in range(B) if j != B // 2]
        assert torch.equal(L[keep], good[keep])


def test_solve_batch_on_card_matches_cpu(cuda):
    from conicip_tpu_torch import solve_batch
    from conicip_tpu_torch.models import batched_box_qp

    Q, c, A, b, cones = batched_box_qp(6, n=40, seed=1)
    cholesky_kernel.reset_launch_count()
    out = solve_batch(Q, c, A, b, cones, device=cuda)
    used = cholesky_kernel.cholesky_launches[(torch.float64, 40, 6)]
    ref = solve_batch(Q, c, A, b, cones, device="cpu")
    assert out.statuses == ref.statuses == ["Optimal"] * 6
    assert torch.equal(out.Iter.cpu(), ref.Iter)
    # one stacked factor for the cold start and one per step, none single
    assert used >= int(out.Iter.max())
    assert cholesky_kernel.launch_count(batch=False) == 0
    assert out.y.device.type == "cuda"
    assert (out.y.cpu() - ref.y).abs().max().item() <= 1e-6


def test_kernel_rejects_what_it_does_not_take(cuda):
    M = torch.eye(8, device=cuda, dtype=torch.float64)
    with pytest.raises(TypeError):
        cholesky_kernel.cholesky_factor(M.half())
    with pytest.raises(ValueError):
        cholesky_kernel.cholesky_factor(M[:, :4])
    with pytest.raises(ValueError):
        cholesky_kernel.cholesky_factor(M.T[::2, ::2])


def test_conic_ip_on_card_matches_cpu(cuda):
    args = box_qp_dense(n=64, seed=42).args()
    before = cholesky_kernel.launch_count()
    sol = conic_ip(*args, device=cuda)
    used = cholesky_kernel.launch_count() - before
    ref = conic_ip(*args, device="cpu")
    assert sol.status == ref.status == "Optimal"
    assert sol.Iter == ref.Iter
    # the cold-start factor plus one per step; no step at the last k
    assert used >= sol.Iter
    assert sol.y.device.type == "cuda"
    assert (sol.y.cpu() - ref.y).abs().max().item() <= 1e-6


@pytest.mark.parametrize("family", ["single_soc", "small_sdp"])
def test_conic_families_on_card_match_cpu(cuda, family):
    # single_soc takes the Schur backend (the kernel every iteration),
    # small_sdp the spectral backend (no factorization at all)
    P = single_soc(n=200) if family == "single_soc" else small_sdp(k=10)
    before = cholesky_kernel.launch_count()
    jbefore = jacobi_kernel.launch_count()
    sol = conic_ip(*P.args(), device=cuda)
    used = cholesky_kernel.launch_count() - before
    jused = jacobi_kernel.launch_count() - jbefore
    ref = conic_ip(*P.args(), device="cpu")
    assert sol.status == ref.status == "Optimal"
    assert sol.Iter == ref.Iter
    assert (used >= sol.Iter) if family == "single_soc" else (used == 0)
    # the S cone's decompositions run the Jacobi kernels: an SVD per
    # scaling, so one at least per iteration
    assert (jused >= sol.Iter) if family == "small_sdp" else (jused == 0)
    assert (sol.y.cpu() - ref.y).abs().max().item() <= 1e-6


def _invariants(A, w, U, svd):
    """Errors that do not depend on signs or bases, relative to max(1,
    |A|_F) (|A|_F^2 for the SVD's Gram identity)."""
    A, w, U = A.double(), w.double(), U.double()
    s = torch.linalg.matrix_norm(A).clamp_min(1.0)
    eye = torch.eye(A.shape[-1], dtype=torch.float64, device=A.device)
    if svd:
        G = U.mT @ A @ A.mT @ U - torch.diag_embed(w * w)
        first = torch.linalg.matrix_norm(G) / (s * s)
    else:
        first = torch.linalg.matrix_norm(U @ torch.diag_embed(w) @ U.mT - A) / s
    return max(first.max().item(),
               (torch.linalg.matrix_norm(U.mT @ U - eye) / s).max().item())


@pytest.mark.parametrize("dtype", ["float64", "float32"])
@pytest.mark.parametrize("B, d", [(64, 10), (3, 33), (1, 30), (64, 20),
                                  (64, 5), (200, 10)])
def test_jacobi_kernels_match_model_and_library(cuda, dtype, B, d):
    # the model (tests/jacobi_model.py) does the kernels' arithmetic in
    # another summation order: values and vectors agree to a few hundred
    # units of rounding of the working type, at most a sweep apart; the
    # library (cuSOLVER) and the identities to 1e-12 / 1e-5 of max(1, |A|_F).
    # The shapes: a warp alone (1, 30), stacks of one-warp matrices at the
    # paths' orders, more matrices than SMs (200, 10), and the block-per-
    # matrix kernel of d > 32 (3, 33)
    dt = getattr(torch, dtype)
    tol = 1e-12 if dt == torch.float64 else 1e-5
    near = 1e-10 if dt == torch.float64 else 1e-5
    rng = np.random.default_rng(B + d)
    X = rng.standard_normal((B, d, d))
    S = ((X + X.swapaxes(-1, -2)) / 2).astype(dtype)
    M = X.astype(dtype)
    A, Mt = (torch.from_numpy(a).to(cuda) for a in (S, M))
    scale = torch.linalg.matrix_norm(A.double()).clamp_min(1.0)[:, None]

    before = jacobi_kernel.launch_count("eigh", dt, d)
    w, U = jacobi_kernel.eigh(A)
    assert jacobi_kernel.launch_count("eigh", dt, d) == before + 1
    assert jacobi_kernel.jacobi_launches[("eigh", dt, d, B)] >= 1
    wm, Um = jacobi_model.eigh(S)
    assert np.abs(w.cpu().numpy() - wm).max() <= near * np.sqrt(d)
    assert np.abs(np.abs(U.cpu().numpy()) - np.abs(Um)).max() <= near * 1e3
    wl = torch.linalg.eigvalsh(A)
    assert ((w - wl).abs().double() / scale).max().item() <= tol
    assert _invariants(A, w, U, svd=False) <= tol
    assert torch.equal(jacobi_kernel.eigvalsh(A), w)

    Us, sig = jacobi_kernel.svd(Mt)
    Um, sm = jacobi_model.svd(M)
    assert np.abs(sig.cpu().numpy() - sm).max() <= near * np.sqrt(d)
    sl = torch.linalg.svdvals(Mt)
    ms = torch.linalg.matrix_norm(Mt.double()).clamp_min(1.0)[:, None]
    assert ((sig - sl).abs().double() / ms).max().item() <= tol
    assert _invariants(Mt, sig, Us, svd=True) <= tol


def test_jacobi_branch_free_rotation_gives_the_librarys_bits(cuda):
    # the d <= 32 kernels compute each rotation on the fast paths of the
    # correctly rounded division, reciprocal and square root, with no branch
    # (csrc/jacobi.cu rotation_fast), and take the library's values where a
    # fast path would not hold: where they hold, the bits are the library's,
    # over the range of a scaled matrix (|a| < 1, a_pq down to the
    # subnormals, 0, and a_pp = a_qq); the subnormal a_pq (theta overflows)
    # and a_pp = a_qq (a zero dividend) leave a fast path
    g = torch.Generator(device=cuda).manual_seed(0)
    n = 1 << 20

    def spread(lowest):
        mant = torch.rand(n, generator=g, device=cuda,
                          dtype=torch.float64) * 2 - 1
        ex = torch.randint(lowest, 1, (n,), generator=g, device=cuda)
        return mant * torch.pow(2.0, ex.double())

    app, apq, aqq = spread(-60), spread(-1074), spread(-60)
    apq[::97] = 0
    aqq[::89] = app[::89]
    mismatched, slow = jacobi_kernel.rotation_check(app, apq, aqq)
    assert mismatched == 0, (mismatched, slow)
    assert 0 < slow < n, (mismatched, slow)


@pytest.mark.parametrize("dtype", ["float64", "float32"])
@pytest.mark.parametrize("d", [10, 30])
def test_jacobi_a_matrix_that_converges_early_leaves_its_neighbours_alone(
        cuda, dtype, d):
    # a near-diagonal matrix between random ones needs fewer sweeps: its
    # warp leaves the sweep loop while the others go on, and it gets the
    # answer it gets alone, bit for bit; so do the random ones
    rng = np.random.default_rng(d)
    X = rng.standard_normal((5, d, d))
    S = (X + X.swapaxes(-1, -2)) / 2
    S[2] = np.diag(np.arange(1.0, d + 1)) + 1e-6 * S[2]
    A = torch.from_numpy(S.astype(dtype)).to(cuda)
    for fn in (jacobi_kernel.eigh, jacobi_kernel.svd,
               lambda M: (jacobi_kernel.eigvalsh(M),)):
        stack = fn(A)
        for i in range(5):
            alone = fn(A[i:i + 1].contiguous())
            for a, b in zip(stack, alone):
                assert torch.equal(a[i], b[0])
    # two sweeps are enough for the near-diagonal one and no other (the
    # SVD counts a third, which finds nothing left to rotate)
    for kind, sweeps in (("eigh", 2), ("eigvalsh", 2), ("svd", 3)):
        for out in jacobi_kernel._launch(kind, A, max_sweeps=sweeps):
            if out is None:
                continue
            assert torch.isfinite(out[2]).all(), kind
            assert torch.isnan(out[[0, 1, 3, 4]]).all(), kind


def test_jacobi_nan_stays_in_its_entry_and_nothing_is_read_back(cuda):
    A = torch.eye(6, device=cuda, dtype=torch.float64).repeat(5, 1, 1)
    A[2, 3, 1] = float("nan")
    w, U = batched.safe_eigh(A)
    Us, sig = batched.safe_svd(A)
    for out in (w, U, Us, sig, batched.safe_eigvalsh(A)):
        assert torch.isnan(out[2]).all()
        assert torch.isfinite(out[[0, 1, 3, 4]]).all()
    with pytest.raises(TypeError):
        batched.safe_eigh(A.half())
    with pytest.raises(ValueError):
        jacobi_kernel.svd(A[:, :, :4])


def test_f32_factors_on_card_run_the_f32_entry(cuda):
    """factor_dtype=float32: the fast iterations factor through the
    kernel's f32 entry, the last-mile ones through its f64 entry, and the
    answer is the f64 solve's to the f32 path's accuracy."""
    f32, f64 = torch.float32, torch.float64
    args = box_qp_dense(n=200, seed=42).args()
    ref = conic_ip(*args, device=cuda)
    c32, c64 = (cholesky_kernel.launch_count(dt) for dt in (f32, f64))
    sol = conic_ip(*args, device=cuda, factor_dtype=f32)
    used32 = cholesky_kernel.launch_count(f32) - c32
    used64 = cholesky_kernel.launch_count(f64) - c64
    assert sol.status == ref.status == "Optimal"
    assert abs(sol.Iter - ref.Iter) <= 2
    assert used32 > 0 and used32 + used64 >= sol.Iter
    assert max(sol.prFeas, sol.duFeas, sol.muFeas) < 1e-6
    assert sol.y.dtype == f64
    assert (sol.y - ref.y).abs().max().item() <= 1e-5


@pytest.mark.parametrize("shape", [(64, 64), (300, 300), (8, 200, 200)])
def test_predicated_entry_matches_plain(cuda, shape):
    # the ridge retries' form: a flagged matrix keeps `out` bit for bit, an
    # unflagged one is factored as the plain version factors it
    rng = np.random.default_rng(1)
    B = rng.standard_normal(shape)
    M = torch.from_numpy(B @ np.swapaxes(B, -1, -2) / shape[-1]
                         + np.eye(shape[-1])).to(cuda)
    prev = torch.full_like(M, 7.0)
    lead = shape[:-2]
    for flags in (torch.ones(lead, dtype=torch.bool),
                  torch.zeros(lead, dtype=torch.bool),
                  torch.arange(lead[0] if lead else 1).reshape(lead) % 2 == 0):
        flags = flags.to(cuda)
        before = cholesky_kernel.launch_count(predicated=True)
        L = cholesky_kernel.cholesky_factor(M, skip=flags, out=prev.clone())
        assert cholesky_kernel.launch_count(predicated=True) == before + 1
        Lp = cholesky_kernel.cholesky_plain(M, skip=flags, out=prev.clone())
        assert torch.equal(L[flags], prev[flags])
        assert ((L - Lp).abs().max() / Lp.abs().max()).item() <= 1e-10


def test_graph_solve_matches_cpu(cuda):
    # conic_ip's device loop on the card (a captured CUDA graph) against
    # the same loop run eagerly on the CPU
    from conicip_tpu_torch import solver

    for P in (box_qp_dense(n=64, seed=42), single_soc(n=40), small_sdp(k=4)):
        sol = conic_ip(*P.args(), device="cuda")
        (run,) = solver.runs
        ref = conic_ip(*P.args(), device="cpu")
        assert run.loop == "graph" and sol.status == ref.status == "Optimal"
        assert sol.Iter == ref.Iter
        assert (sol.y.cpu() - ref.y).abs().max().item() <= 1e-8


def test_a_cached_solve_equals_one_after_clear(cuda):
    # the device loop's kept graphs (solver/graph.py), refreshed with other
    # instances of one configuration: bit for bit a solve of the same data
    # from an empty cache, and an earlier solution left as it was
    from conicip_tpu_torch import solver
    from conicip_tpu_torch.solver import graph

    for make in (lambda s: box_qp_dense(n=64, seed=s),
                 lambda s: single_soc(n=40, seed=s),
                 lambda s: small_sdp(k=4, seed=s)):
        graph.clear()
        first = conic_ip(*make(1).args(), device="cuda")
        kept = first.y.clone()
        for seed in (2, 3):
            sol = conic_ip(*make(seed).args(), device="cuda")
            assert solver.runs[0].cache_hit and solver.runs[0].loop == "graph"
            graph.clear()
            fresh = conic_ip(*make(seed).args(), device="cuda")
            assert not solver.runs[0].cache_hit
            assert (sol.status, sol.Iter) == (fresh.status, fresh.Iter)
            assert torch.equal(sol.y, fresh.y) and torch.equal(sol.v, fresh.v)
            # the entry now holds the first instance's data again
            conic_ip(*make(1).args(), device="cuda")
        assert torch.equal(first.y, kept)
    graph.clear()
    assert graph.cache_info() == []


def test_solve_batch_runs_its_stacks_on_kept_graphs(cuda):
    # solve_batch's own full-precision stacks on the device loop: captured
    # CUDA graphs kept across calls, a second call of the same stack a hit
    # equal to the first bit for bit, and per instance the CPU's status and
    # Iter; a Schur stack with a shared G and an S-cone stack
    from conicip_tpu_torch import solve_batch
    from conicip_tpu_torch.models import batched_mixed_rq_eq, batched_small_sdp
    from conicip_tpu_torch.parallel import batch as pbatch
    from conicip_tpu_torch.solver import graph

    for args in (batched_mixed_rq_eq(4, n=30, n_q=7, p=3),
                 batched_small_sdp(3)):
        graph.clear()
        first = solve_batch(*args, device=cuda)
        (run,) = pbatch.runs
        assert run.loop == "graph" and not run.cache_hit
        again = solve_batch(*args, device=cuda)
        (run,) = pbatch.runs
        assert run.loop == "graph" and run.cache_hit
        assert torch.equal(again.y, first.y)
        assert torch.equal(again.Iter, first.Iter)
        ref = solve_batch(*args, device="cpu")
        assert first.statuses == ref.statuses == ["Optimal"] * len(
            ref.statuses)
        assert torch.equal(first.Iter.cpu(), ref.Iter)
    graph.clear()
    assert graph.cache_info() == []


def test_the_guard_finds_a_callers_read_before_any_capture(cuda):
    # a caller's dense Schur solver on torch.linalg.cholesky (a host check
    # of info) reads the device: the first call's guard finds it before any
    # capture, the run solves on the eager loop naming the call, nothing is
    # stranded and the sync debug mode is restored; the verdict is kept, so
    # a second call decides before the solve. The same solver on the
    # port's ops.cholesky is captured, and gives the same answer.
    from conicip_tpu_torch import pivot, solver
    from conicip_tpu_torch.ops import cho_solve, cholesky
    from conicip_tpu_torch.solver import graph

    def dense(factor):
        def kkt2x2(Q, A, G, spec):
            def gen(F, FinvT):
                winv = 1.0 / (F.r_d * F.r_d)
                L = factor(Q + A.mT @ (winv[:, None] * A))
                return lambda by, bw: (cho_solve(L, by), bw)
            return gen
        return kkt2x2

    args = box_qp_dense(n=64, seed=3).args()
    reads = pivot(dense(lambda M: torch.linalg.cholesky(M)))
    stranded = len(graph._stranded)
    sol = conic_ip(*args, kktsolver=reads, device=cuda)
    run = solver.runs[-1]
    assert run.loop == "eager" and "torch.linalg.cholesky" in run.reason
    assert len(graph._stranded) == stranded
    assert not any(key[5] is reads for key in graph.cache_info())
    assert torch.cuda.get_sync_debug_mode() == 0
    assert solver._eager_reason(reads, cuda) == run.reason
    again = conic_ip(*args, kktsolver=reads, device=cuda)
    assert solver.runs[-1].loop == "eager"
    assert torch.equal(again.y, sol.y)
    clean = pivot(dense(cholesky))
    good = conic_ip(*args, kktsolver=clean, device=cuda)
    assert solver.runs[-1].loop == "graph"
    assert solver._eager_reason(clean, cuda) is None
    assert (good.status, good.Iter) == (sol.status, sol.Iter) == (
        "Optimal", sol.Iter)
    assert float((good.y - sol.y).abs().max()) < 1e-8


def test_the_guard_lets_a_callers_control_cond_through(cuda, tmp_path):
    # control.cond in a caller's level 2 (the port's lax.cond), directly
    # and inside kktsolver_schur_tp's ridge retry under a caller's lambda
    # (NCCL, a world of one): the guard's probe runs every body masked, so
    # the package reads no predicate inside a guarded call; both are
    # captured, and give the eager loop's answer
    from conicip_tpu_torch import pivot, solver
    from conicip_tpu_torch.ops import cho_solve, cholesky, control
    from conicip_tpu_torch.parallel import kktsolver_schur_tp, make_mesh
    from conicip_tpu_torch.parallel.mesh import start_rank
    from conicip_tpu_torch.solver import graph

    def ridged(Q, A, G, spec):
        def gen(F, FinvT):
            winv = 1.0 / (F.r_d * F.r_d)
            M = Q + A.mT @ (winv[:, None] * A)
            L = cholesky(M)
            eye = torch.eye(M.shape[-1], dtype=M.dtype, device=M.device)
            L = control.cond(~torch.isfinite(L).all(),
                             lambda: cholesky(M + 1e-10 * eye), L)
            return lambda by, bw: (cho_solve(L, by), bw)
        return gen

    def plain(Q, A, G, spec):
        def gen(F, FinvT):
            winv = 1.0 / (F.r_d * F.r_d)
            L = cholesky(Q + A.mT @ (winv[:, None] * A))
            return lambda by, bw: (cho_solve(L, by), bw)
        return gen

    args = box_qp_dense(n=64, seed=3).args()
    mine = pivot(ridged)
    # the same solver without the retry, whose factor never fails here
    ref = conic_ip(*args, kktsolver=pivot(plain), device=cuda)
    sol = conic_ip(*args, kktsolver=mine, device=cuda)
    run = solver.runs[-1]
    assert run.loop == "graph" and run.reason is None, run.reason
    assert any(key[5] is mine for key in graph.cache_info())
    assert solver._eager_reason(mine, cuda) is None
    assert (sol.status, sol.Iter) == (ref.status, ref.Iter)
    assert torch.equal(sol.y, ref.y)

    start_rank(0, 1, "file://" + str(tmp_path / "rendezvous"), "cuda")
    try:
        tp = kktsolver_schur_tp(make_mesh((1,), ("tp",)), "tp")
        wrapped = lambda *a: tp(*a)  # noqa: E731  a caller's own callable
        own = conic_ip(*args, kktsolver=tp, device=cuda)
        assert solver.runs[-1].loop == "graph"
        got = conic_ip(*args, kktsolver=wrapped, device=cuda)
        run = solver.runs[-1]
        assert run.loop == "graph" and run.reason is None, run.reason
        assert solver._eager_reason(wrapped, cuda) is None
        assert (got.status, got.Iter) == (own.status, own.Iter)
        assert float((got.y - own.y).abs().max()) < 1e-10
    finally:
        torch.distributed.destroy_process_group()
        graph.clear()


# ── the R cones' kernels (csrc/rcone.cu) ──

RCONE_SHAPES = [(1, 2000), (64, 1000), (1, 8192), (3, 1), (5, 300)]


def rcone_inputs(B, m, dt, device, seed=0):
    """An interior point, a direction (in a stack, with a NaN and an inf
    entry in the last instance), two more vectors, per-instance σμ and
    ã."""
    g = torch.Generator(device=device).manual_seed(seed)
    pos = lambda: torch.rand(B, m, generator=g, device=device,  # noqa: E731
                             dtype=dt) * 2.8 + 0.2
    nrm = lambda: torch.randn(B, m, generator=g, device=device,  # noqa: E731
                              dtype=dt)
    dv, ds = nrm(), nrm()
    if B > 1:
        dv[-1, 0] = float("nan")
        ds[-1, -1] = float("inf")
    return dict(v=pos(), s=pos(), dv=dv, ds=ds, x=nrm(), y=nrm(),
                smu=torch.rand(B, generator=g, device=device, dtype=dt) * 0.3
                + 0.3,
                atil=torch.rand(B, generator=g, device=device, dtype=dt) * 0.5
                + 0.5)


def same_values(a, b):
    """Equal entries, NaN where the other is NaN (the bits of the plain
    sequence; a signed zero may differ)."""
    nan = torch.isnan(a)
    return bool(torch.equal(nan, torch.isnan(b)) and ((a == b) | nan).all())


def within(a, b, terms, tol):
    """A reduced value within ``tol`` of the magnitudes of its terms where
    it is finite, equal (NaN where NaN) where it is not."""
    fin = torch.isfinite(b)
    bound = tol * terms.abs().sum(-1)
    return bool(torch.equal(torch.isnan(a), torch.isnan(b))
                and ((a == b) | fin | torch.isnan(b)).all()
                and ((a - b).abs() <= bound)[fin].all())


@pytest.mark.parametrize("dtype", ["float64", "float32"])
@pytest.mark.parametrize("B, m", RCONE_SHAPES)
def test_rcone_kernels_match_their_plain_twins(cuda, dtype, B, m):
    # every entry of csrc/rcone.cu against its plain PyTorch twin on the
    # same card tensors: elementwise outputs and the step equal, the
    # reduced values (mubar, the fts dots, fts) within 1e-13 (f64) / 1e-5
    # (f32) of their terms' magnitudes; one launch counted per call
    from conicip_tpu_torch.ops import rcone, rcone_kernel

    dt = getattr(torch, dtype)
    tol = 1e-13 if dt == torch.float64 else 1e-5
    a = rcone_inputs(B, m, dt, cuda)
    v, s, dv, ds = a["v"], a["s"], a["dv"], a["ds"]
    before = rcone_kernel.launch_count()
    got = rcone.r_scaling(v, s)
    want = rcone.r_scaling_plain(v, s)
    assert all(same_values(x, y) for x, y in zip(got[:4], want[:4]))
    assert within(got[4], want[4], v * s, tol)
    r_d, rinv, lam, lam2, _ = want
    assert all(same_values(x, y) for x, y in zip(
        rcone.r_reduce4_pre(a["x"], lam, r_d, a["y"]),
        rcone.r_reduce4_pre_plain(a["x"], lam, r_d, a["y"])))
    assert same_values(rcone.r_reduce4_post(a["x"], r_d, dv),
                       rcone.r_reduce4_post_plain(a["x"], r_d, dv))
    assert same_values(rcone.r_corrector(lam2, r_d, rinv, dv, ds, a["smu"]),
                       rcone.r_corrector_plain(lam2, r_d, rinv, dv, ds,
                                               a["smu"]))
    assert same_values(rcone.r_k4(lam, r_d, rinv, dv, ds),
                       rcone.r_k4_plain(lam, r_d, rinv, dv, ds))
    assert same_values(
        rcone.r_gondzio(lam, r_d, rinv, dv, ds, a["atil"], a["smu"]),
        rcone.r_gondzio_plain(lam, r_d, rinv, dv, ds, a["atil"], a["smu"]))
    for scale in (None, 1.0 / 0.99):
        alpha, ok = rcone.r_step(v, s, dv, ds, scale)
        p_alpha, p_ok = rcone.r_step_plain(v, s, dv, ds, scale)
        assert same_values(alpha, p_alpha) and torch.equal(ok, p_ok)
    alpha, ok, dots, f = rcone.r_step(v, s, dv, ds, fts=True)
    p_alpha, p_ok, p_dots, p_f = rcone.r_step_plain(v, s, dv, ds, fts=True)
    assert same_values(alpha, p_alpha) and torch.equal(ok, p_ok)
    terms = torch.stack([v * s, v * ds, dv * s, dv * ds], -2)
    assert within(dots, p_dots, terms, tol)
    assert within(f, p_f, terms.reshape(B, -1), tol)
    # fts is the plain formula on the kernel's own dots, bit for bit
    d = dots.unbind(-1)
    assert same_values(f, d[0] - alpha * d[1] - alpha * d[2]
                       + alpha * alpha * d[3])
    assert ok[:-1].all() and bool(ok[-1]) == (B == 1)
    assert rcone_kernel.launch_count() == before + 9
    assert rcone_kernel.rcone_launches[("scaling", dt, m, B)] >= 1


def test_rcone_kernels_reject_what_they_do_not_take(cuda):
    from conicip_tpu_torch.ops import rcone, rcone_kernel

    v = torch.ones(4, 8, device=cuda, dtype=torch.float64)
    with pytest.raises(TypeError):
        rcone_kernel.scaling(v.half(), v.half())
    with pytest.raises(ValueError):
        rcone_kernel.scaling(v, v.float())
    with pytest.raises(ValueError):
        rcone_kernel.scaling(v.T, v.T)
    with pytest.raises(ValueError):
        rcone_kernel.scaling(v.cpu(), v.cpu())
    with pytest.raises(ValueError):
        rcone_kernel.step(v[:0], v[:0], v[:0], v[:0])
    with pytest.raises(ValueError):
        rcone_kernel.comp("gondzio", v, v, v, v, v, smu=v[:, 0].clone())
    with pytest.raises(ValueError):
        rcone.r_k4(v, v, v, v.cpu(), v)
    # a vector shared by the stack is broadcast, a strided row copied
    wide = torch.ones(4, 10, device=cuda, dtype=torch.float64)[:, 2:]
    r_d, *_ = rcone.r_scaling(wide, v[0])
    assert r_d.shape == (4, 8) and bool((r_d == 1).all())


def test_an_r_only_solve_launches_every_entry_inside_the_graph(cuda):
    # the dense box QP (Schur, one Gondzio corrector): every entry of the
    # R cones' kernels launches on the device loop, its captured graph
    # counted per replay and per run of a refinement trip's body; the
    # eager loop on the same operands gives the same bits and launches
    # each entry too
    from conicip_tpu_torch import solver
    from conicip_tpu_torch.cones.spec import ConeSpec
    from conicip_tpu_torch.kkt import kktsolver_schur
    from conicip_tpu_torch.ops import rcone_kernel
    from conicip_tpu_torch.solver import graph, ipm

    P = box_qp_dense(n=200, seed=11)
    Q, c, A, b, cones = (torch.as_tensor(np.asarray(x), device=cuda)
                         if i < 4 else x for i, x in enumerate(P.args()[:5]))
    G = torch.zeros(0, 200, dtype=torch.float64, device=cuda)
    d = torch.zeros(0, dtype=torch.float64, device=cuda)
    args = (Q, c, A, b, G, d, ConeSpec(cones), kktsolver_schur,
            ipm.IPMOptions(centralityCorrectors=1))
    graph.clear()
    for hit in (False, True):
        rcone_kernel.reset_launch_count()
        stats = {}
        st = graph.solve(*args, stats=stats)
        assert stats["loop"] == "graph" and stats["cache_hit"] == hit
        for entry in rcone_kernel.ENTRIES:
            assert rcone_kernel.launch_count(entry) > 0, entry
        steps = stats["fast_steps"]
        # per step: the predictor, the corrector and the Gondzio's step
        assert rcone_kernel.launch_count("predictor") == steps
        assert rcone_kernel.launch_count("step") == 2 * steps
        assert rcone_kernel.launch_count("k4") == steps + stats["trips"]
    rcone_kernel.reset_launch_count()
    ref = ipm.ipm_solve(*args)
    assert all(rcone_kernel.launch_count(e) > 0
               for e in rcone_kernel.ENTRIES)
    assert torch.equal(st.y, ref.y) and torch.equal(st.Iter, ref.Iter)
    graph.clear()


def test_a_reading_bound_method_is_decided_before_its_second_call(cuda):
    # a caller's solver object whose level 2 reads the device (a host
    # check of torch.linalg.cholesky's info): its bound method, a new
    # object at each access, is found to read on the first call and
    # remembered by its object and function, so the second call takes
    # the eager loop with the reason before the solve: no probe, no capture
    from conicip_tpu_torch import pivot, solver
    from conicip_tpu_torch.ops import cho_solve, control
    from conicip_tpu_torch.solver import graph

    class Dense:
        def kkt2x2(self, Q, A, G, spec):
            def gen(F, FinvT):
                winv = 1.0 / (F.r_d * F.r_d)
                L = torch.linalg.cholesky(Q + A.mT @ (winv[:, None] * A))
                return lambda by, bw: (cho_solve(L, by), bw)
            return gen

        def kkt(self, Q, A, G, spec):
            return pivot(self.kkt2x2)(Q, A, G, spec)

    mine = Dense()
    args = box_qp_dense(n=64, seed=3).args()
    first = conic_ip(*args, kktsolver=mine.kkt, device=cuda)
    run = solver.runs[-1]
    assert run.loop == "eager" and "torch.linalg.cholesky" in run.reason
    assert control.eager_reason(mine.kkt, cuda) == run.reason
    assert control.eager_reason(Dense().kkt, cuda) is None
    probes, captures = [], []
    guarded, capture = control.guarded, graph._capture
    try:
        control.guarded = lambda k: probes.append(k) or guarded(k)
        graph._capture = lambda *a: captures.append(a) or capture(*a)
        again = conic_ip(*args, kktsolver=mine.kkt, device=cuda)
    finally:
        control.guarded, graph._capture = guarded, capture
    run = solver.runs[-1]
    assert run.loop == "eager" and "torch.linalg.cholesky" in run.reason
    assert probes == [] and captures == []
    assert (again.status, again.Iter) == (first.status, first.Iter)
    graph.clear()
