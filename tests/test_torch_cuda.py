"""Tests of the port that need an NVIDIA GPU (marker ``cuda``).

The CUDA kernel has no CPU mode, so each test skips where
``torch.cuda.is_available()`` is false. This file imports no JAX, so on a
machine with a card and without JAX it runs on its own:

    python -m pytest --noconftest -m cuda tests/test_torch_cuda.py
"""

from collections import Counter

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


INVERSE_SHAPES = tuple((n,) for n in (1, 31, 127, 128, 129, 255, 257, 500,
                                      1000, 1024, 1280)) + ((64, 500),
                                                            (64, 465))
# shapes held on the factors of ill-conditioned matrices as well
INVERSE_ILL = ((500,), (64, 500))
# condition numbers of those matrices by dtype: the f32 Schur last mile's
# regime in f32
ILL_KAPPA = {torch.float64: 1e12, torch.float32: 1e5}


def ill_conditioned(n, kappa, seed=0):
    """SPD with condition number ~kappa and unit diagonal (equilibrated)."""
    rng = np.random.default_rng(seed)
    Q, _ = np.linalg.qr(rng.standard_normal((n, n)))
    M = (Q * np.logspace(0, -np.log10(kappa), n)) @ Q.T
    d = 1 / np.sqrt(np.diag(M))
    M = M * d[:, None] * d[None, :]
    return (M + M.T) / 2


@pytest.mark.parametrize("dtype", ["float64", "float32"])
@pytest.mark.parametrize(
    "shape, ill",
    [pytest.param(s, False, id=f"shape{i}")
     for i, s in enumerate(INVERSE_SHAPES)]
    + [pytest.param(s, True, id=f"ill{i}") for i, s in enumerate(INVERSE_ILL)])
def test_inverse_kernel_matches_plain(cuda, dtype, shape, ill):
    # the kernel's inverse of a factor against the plain version (the
    # triangular solve against the identity) and by its residual |XL - I|:
    # the relative bounds of the factor's tests, rounding of two summation
    # orders, also on the factors of ill-conditioned matrices; the strict
    # upper triangle exactly zero; one count a call, under the entry that
    # ran; on a stack, each matrix the single entry's bit for bit
    dt = getattr(torch, dtype)
    tol = 1e-10 if dt == torch.float64 else 1e-4
    n = shape[-1]
    if ill:
        M = np.stack([ill_conditioned(n, ILL_KAPPA[dt], seed=i)
                      for i in range(shape[0] if len(shape) == 2 else 1)])
        M = M.reshape(shape + (n,))
    else:
        M = (spd(n, seed=n) if len(shape) == 1
             else spd_stack(shape[0], n, seed=n))
    L = cholesky_kernel.cholesky_factor(torch.from_numpy(M).to(cuda, dt))
    key = (dt, n) if len(shape) == 1 else (dt, n, shape[0])
    before = cholesky_kernel.inverse_launches[key]
    others = cholesky_kernel.launch_count(counter="inverse") - before
    X = cholesky_kernel.tri_inverse(L)
    assert cholesky_kernel.inverse_launches[key] == before + 1
    assert (cholesky_kernel.launch_count(counter="inverse")
            == before + 1 + others)
    Xp = cholesky_kernel.tri_inverse_plain(L)
    assert ((X - Xp).abs().max() / Xp.abs().max()).item() <= tol
    eye = torch.eye(n, device=cuda, dtype=dt)
    res = (X @ L - eye).abs().max() / (X.abs().max() * L.abs().max())
    assert res.item() <= tol
    assert torch.equal(X.triu(1), torch.zeros_like(X))
    if len(shape) == 2:
        for i in (0, shape[0] // 2, shape[0] - 1):
            assert torch.equal(X[i],
                               cholesky_kernel.tri_inverse(L[i].contiguous()))


@pytest.mark.parametrize("dtype", ["float64", "float32"])
def test_inverse_of_a_ridge_retried_stack(cuda, dtype):
    # the Schur solver's order: a stack whose instance 3 fails its first
    # factor, the predicated ridge retries (control.retry_while) until it
    # is finite, then the inverse: finite everywhere, the plain inverse's
    # to the factor tests' bounds, and a NaN factor's inverse non-finite
    # with its neighbours untouched
    from conicip_tpu_torch.ops.cholesky import cholesky, tri_inv
    from conicip_tpu_torch.ops.control import retry_while

    dt = getattr(torch, dtype)
    tol = 1e-10 if dt == torch.float64 else 1e-4
    B, n = 8, 300
    M = torch.from_numpy(spd_stack(B, n, seed=4)).to(cuda, dt)
    lo = torch.linalg.eigvalsh(M[3].double()).min().item()
    M[3] -= (lo + 1e-3) * torch.eye(n, device=cuda, dtype=dt)
    first = cholesky(M)
    assert not bool(torch.isfinite(first[3]).all())
    ridge = 1e-2
    eye = torch.eye(n, device=cuda, dtype=dt)
    # the retries write into the first attempt's buffer: keep a copy
    L = retry_while(lambda L: ~torch.isfinite(L).flatten(-2).all(-1),
                    lambda boost, skip, L: cholesky(M + boost * ridge * eye,
                                                    skip=skip, out=L),
                    first.clone(), 1.0, 10.0, 1e4)
    assert bool(torch.isfinite(L).all())
    keep = [i for i in range(B) if i != 3]
    assert torch.equal(L[keep], first[keep])
    X = tri_inv(L)
    Xp = cholesky_kernel.tri_inverse_plain(L)
    assert bool(torch.isfinite(X).all())
    assert ((X - Xp).abs().max() / Xp.abs().max()).item() <= tol
    bad = tri_inv(first)
    assert not bool(torch.isfinite(bad[3]).all())
    assert torch.equal(bad[keep], X[keep])


def test_inverse_runs_no_library_solve(cuda):
    # a profiled tri_inv on the card: the kernel's inv_diag, inv_w and
    # inv_step, and no trsm (the library's triangular solve it replaces)
    from torch.profiler import ProfilerActivity, profile

    from conicip_tpu_torch.ops.cholesky import tri_inv

    for shape in ((500, 500), (64, 500, 500)):
        n = shape[-1]
        M = torch.from_numpy(spd(n, seed=1) if len(shape) == 2
                             else spd_stack(shape[0], n, seed=1)).to(cuda)
        L = cholesky_kernel.cholesky_factor(M)
        tri_inv(L)
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            tri_inv(L)
            torch.cuda.synchronize()
        names = [e.name for e in prof.events()
                 if e.device_type == torch.autograd.DeviceType.CUDA]
        assert not [k for k in names if "trsm" in k.lower()], names
        assert any("inv_diag" in k for k in names), names


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
                                  (64, 5), (200, 10), (1, 40), (1, 64),
                                  (2, 100), (32, 64), (1, 119), (1, 120),
                                  (1, 169), (1, 170), (1, 200)])
def test_jacobi_kernels_match_model_and_library(cuda, dtype, B, d):
    # the model (tests/jacobi_model.py) does the kernels' arithmetic in
    # another summation order: values and vectors agree to a few hundred
    # units of rounding of the working type, at most a sweep apart; the
    # library (cuSOLVER) and the identities to 1e-12 / 1e-5 of max(1, |A|_F).
    # The shapes: a warp alone (1, 30), stacks of one-warp matrices at the
    # paths' orders, more matrices than SMs (200, 10), and the block-per-
    # matrix kernels of d > 32: (3, 33), the [sdp_large] solves' (2, 100)
    # and (32, 64), the on-chip / device-memory edges of eigh (119 / 120)
    # and of eigvalsh and svd (169 / 170), and 200 in device memory
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
    mismatched, slow, zeroed = jacobi_kernel.rotation_check(app, apq, aqq)
    assert mismatched == 0, (mismatched, slow)
    assert 0 < slow < n, (mismatched, slow)
    # Rutishauser's rule takes the a_pq that numpy's IEEE sums say it takes
    assert zeroed == int(negligible_on_host(app, apq, aqq).sum()) > 0


def negligible_on_host(*triples):
    """tests/jacobi_model.py's rule on the host copies of CUDA vectors."""
    return jacobi_model.negligible(*(v.cpu().numpy() for v in triples))


def test_jacobi_rotation_under_the_rule_at_its_edge(cuda):
    # at the rule's edge and one ulp past it the kernels' rotation gives
    # the library's bits under the rule, and the rule takes exactly the
    # first half: what numpy's sums take
    from jacobi_cases import rule_edge_triples

    app, apq, aqq = (torch.from_numpy(v).to(cuda)
                     for v in rule_edge_triples(1 << 16))
    mismatched, slow, zeroed = jacobi_kernel.rotation_check(app, apq, aqq)
    want = negligible_on_host(app, apq, aqq)
    assert mismatched == 0, (mismatched, slow, zeroed)
    half = app.numel() // 2
    assert want[:half].all() and not want[half:].any()
    assert zeroed == half


def kernel_sweeps(kind, A):
    """Sweeps the kernel takes on the stack A, found under a rising sweep
    limit (the first limit at which every output is finite)."""
    for sweeps in range(jacobi_kernel.MAX_SWEEPS + 1):
        out = jacobi_kernel._launch(kind, A, max_sweeps=sweeps)
        if all(o is None or bool(torch.isfinite(o).all()) for o in out):
            return sweeps
    return None


def repeated_spectra(d):
    """(label, order-d matrix): tests/test_torch_jacobi.py's exactly
    repeated spectra, reflected (seeds 1000 and 1003), the projector and
    the clustered one in a random basis."""
    from jacobi_cases import clustered, projector, reflected

    return (("reflected 1000", reflected(d, 1000)),
            ("reflected 1003", reflected(d, 1003)),
            ("projector", projector(d, 1000)),
            ("clustered", clustered(np.random.default_rng(d), d)))


@pytest.mark.parametrize("dtype", ["float64", "float32"])
@pytest.mark.parametrize("d", [10, 30, 33, 64])
def test_jacobi_repeated_spectra_converge_as_the_model_does(cuda, dtype, d):
    # the reflected spectrum at d = 64 came back NaN before the rule (not
    # converged within 80 sweeps); now every eigh kernel converges within
    # 30, as the model does, to the model's values within a few hundred
    # units of rounding (another summation order), the library's values and
    # the identities within 1e-12 / 1e-5 of max(1, |A|_F), and eigvalsh gives
    # eigh's bits in as many sweeps. At a limit of 2 sweeps each entry
    # still comes back NaN
    dt = getattr(torch, dtype)
    tol = 1e-12 if dt == torch.float64 else 1e-5
    near = 1e-10 if dt == torch.float64 else 1e-5
    for label, X in repeated_spectra(d):
        S = X.astype(dtype)
        A = torch.from_numpy(S).to(cuda)[None]
        w, U = jacobi_kernel.eigh(A)
        assert torch.isfinite(w).all() and torch.isfinite(U).all(), label
        assert torch.equal(jacobi_kernel.eigvalsh(A), w), label
        norms = []
        wm, _ = jacobi_model.eigh_one(S, norms=norms)
        assert np.abs(w[0].cpu().numpy() - wm).max() <= near * np.sqrt(d)
        scale = max(1.0, float(np.linalg.norm(S.astype(np.float64))))
        wl = torch.linalg.eigvalsh(A.double())
        assert (w.double() - wl).abs().max().item() <= tol * scale, label
        assert _invariants(A, w, U, svd=False) <= tol, label
        sweeps = {k: kernel_sweeps(k, A) for k in ("eigh", "eigvalsh")}
        sweeps["model"] = len(norms) - 1
        assert sweeps["eigh"] == sweeps["eigvalsh"], (label, sweeps)
        assert max(sweeps.values()) <= 30, (label, sweeps)
        for kind in ("eigh", "eigvalsh"):
            for out in jacobi_kernel._launch(kind, A, max_sweeps=2):
                assert out is None or torch.isnan(out).all(), (label, kind)


@pytest.mark.parametrize("d", [4, 40])
def test_jacobi_the_rule_takes_a_pq_up_to_its_edge_on_the_card(cuda, d):
    # tests/test_torch_jacobi.py's edge matrices on a warp kernel (d = 4)
    # and a block kernel (40): at the edge the pair (0, d - 1) is not
    # rotated (a twice, U's column ±e_0 exactly), one ulp past it rotates
    from jacobi_cases import rotated_pair, rule_edge

    for a in (0.75, 0.6, -0.9):
        for X, rotates in zip(rule_edge(a, d), (False, True)):
            A = torch.from_numpy(X).to(cuda)[None]
            w, U = jacobi_kernel.eigh(A)
            w, U = w[0].cpu().numpy(), U[0].cpu().numpy()
            assert rotated_pair(U, d) == rotates, (a, rotates)
            assert (np.count_nonzero(w == a) == 2) != rotates, (a, w)
            wm, Um = jacobi_model.eigh_one(X)
            assert np.abs(w - wm).max() <= 1e-15
            assert np.abs(np.abs(U) - np.abs(Um)).max() <= 1e-15


@pytest.mark.parametrize("dtype", ["float64", "float32"])
@pytest.mark.parametrize("d", [10, 30, 64])
def test_jacobi_a_matrix_that_converges_early_leaves_its_neighbours_alone(
        cuda, dtype, d):
    # a near-diagonal matrix between random ones needs fewer sweeps: its
    # warp (its block, d = 64) leaves the sweep loop while the others go
    # on, and it gets the answer it gets alone, bit for bit; so do the
    # random ones
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


@pytest.mark.parametrize("dtype", ["float64", "float32"])
def test_jacobi_a_nan_entry_leaves_its_neighbours_alone_above_a_warp(
        cuda, dtype):
    # the block kernels (d = 64): NaN in one matrix and +inf in another's
    # upper triangle give NaN in every output of those two alone; the
    # others get what they get alone, bit for bit
    d = 64
    rng = np.random.default_rng(d)
    X = rng.standard_normal((5, d, d))
    A = torch.from_numpy(((X + X.swapaxes(-1, -2)) / 2).astype(dtype)).to(
        cuda)
    A[1, 40, 3] = float("nan")
    A[3, 2, 50] = float("inf")
    for fn in (jacobi_kernel.eigh, jacobi_kernel.svd,
               lambda M: (jacobi_kernel.eigvalsh(M),)):
        stack = fn(A)
        for i in range(5):
            for a, b in zip(stack, fn(A[i:i + 1].contiguous())):
                if i in (1, 3):
                    assert torch.isnan(a[i]).all() and torch.isnan(b[0]).all()
                else:
                    assert torch.isfinite(a[i]).all()
                    assert torch.equal(a[i], b[0])


def test_jacobi_plan_agrees_with_the_kernels_and_a_refused_plan_raises(
        cuda, monkeypatch):
    # the wrapper's launch plan (ops/jacobi_kernel.py) counts the shared
    # memory as the built kernels lay it out: they launch with its count
    # and refuse another; a plan the kernels do not take (not whole warps)
    # is refused by the launch and raises, with no other route
    for kind in jacobi_kernel.KINDS:
        for d in (5, 32, 33, 64, 100, 119, 120, 169, 170, 200):
            A = torch.eye(d, device=cuda, dtype=torch.float64)[None]
            p = jacobi_kernel.launch_plan(kind, d, torch.float64)
            out = jacobi_kernel._launch(kind, A)
            assert all(torch.isfinite(x).all() for x in out if x is not None)
            other = p._replace(smem_bytes=p.smem_bytes + 8)
            with monkeypatch.context() as m:
                m.setattr(jacobi_kernel, "launch_plan", lambda *a: other)
                with pytest.raises(RuntimeError, match="launch failed"):
                    jacobi_kernel._launch(kind, A)
    A = torch.eye(64, device=cuda, dtype=torch.float64)[None]
    real = jacobi_kernel.launch_plan
    monkeypatch.setattr(jacobi_kernel, "launch_plan",
                        lambda *a: real(*a)._replace(threads=1000))
    before = jacobi_kernel.launch_count()
    for fn in (jacobi_kernel.eigh, jacobi_kernel.eigvalsh, jacobi_kernel.svd):
        with pytest.raises(RuntimeError, match="launch failed"):
            fn(A)
    assert jacobi_kernel.launch_count() == before


@pytest.mark.parametrize("case", ["single", "stack"])
def test_s_cones_above_a_warp_solve_on_the_card_as_on_the_cpu(cuda, case):
    # chip_smoke.py's [sdp_large] solves: conic_ip on instance 0 of
    # batched_small_sdp(1, k=100) (spectral, n = 5050) and solve_batch on
    # batched_small_sdp(32, k=64) (n = 2080): the card's status and Iter,
    # per instance, are the CPU's, every decomposition on the block kernels
    from conicip_tpu_torch import solve_batch
    from conicip_tpu_torch.models import batched_small_sdp

    if case == "single":
        Q, c, A, b, cones = batched_small_sdp(1, k=100)
        args = (Q[0], c[0], A[0], b[0], cones)
        solve = conic_ip
    else:
        args = batched_small_sdp(32, k=64)
        solve = solve_batch
    jacobi_kernel.reset_launch_count()
    sol = solve(*args, device=cuda)
    used = dict(jacobi_kernel.jacobi_launches)
    ref = solve(*args, device="cpu")
    if case == "single":
        assert sol.status == ref.status == "Optimal"
        assert sol.Iter == ref.Iter
    else:
        assert sol.statuses == ref.statuses == ["Optimal"] * 32
        assert torch.equal(sol.Iter.cpu(), ref.Iter)
    assert used and all(d > 32 for _, _, d, _ in used), used
    assert (sol.y.cpu() - ref.y).abs().max().item() <= 1e-6


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
        before = cholesky_kernel.launch_count(counter="predicated")
        L = cholesky_kernel.cholesky_factor(M, skip=flags, out=prev.clone())
        assert cholesky_kernel.launch_count(counter="predicated") == before + 1
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

RCONE_SHAPES = [(1, 2000), (64, 1000), (1, 8192), (3, 1), (5, 300),
                (1, 1000), (1, 8195)]


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


def every_entry(a, lam, r_d, rinv):
    """Every entry of csrc/rcone.cu on the inputs ``a`` and the scaling's
    λ, r_d and 1/r_d: the scaling's five outputs, ``reduce4_pre``'s two,
    ``reduce4_post``, the corrector (x = ``a["x"]``), k4, gondzio, the
    step's two and the predictor's four."""
    from conicip_tpu_torch.ops import rcone

    v, s, dv, ds = a["v"], a["s"], a["dv"], a["ds"]
    return (*rcone.r_scaling(v, s),
            *rcone.r_reduce4_pre(a["x"], lam, r_d, a["y"]),
            rcone.r_reduce4_post(a["x"], r_d, dv),
            rcone.r_corrector(a["x"], r_d, rinv, dv, ds, a["smu"]),
            rcone.r_k4(lam, r_d, rinv, dv, ds),
            rcone.r_gondzio(lam, r_d, rinv, dv, ds, a["atil"], a["smu"]),
            *rcone.r_step(v, s, dv, ds, 1.0 / 0.99),
            *rcone.r_step(v, s, dv, ds, fts=True))


def same_bits(xs, ys):
    """Equal outputs, NaN where the other is NaN."""
    return len(xs) == len(ys) and all(
        x.shape == y.shape and x.dtype == y.dtype
        and (torch.equal(x, y) or (x.is_floating_point()
                                   and same_values(x, y)))
        for x, y in zip(xs, ys))


@pytest.mark.parametrize("dtype", ["float64", "float32"])
@pytest.mark.parametrize("offset", [0, 1, 4])
def test_rcone_kernels_read_row_strided_views_in_place(
        cuda, dtype, offset, monkeypatch):
    # rows of a wider matrix (at an offset that breaks or keeps the 16-byte
    # alignment) and the cone identity shared by the stack at row stride
    # 0: every entry reads them in place, no copy, and gives the same bits
    # as on contiguous copies, the reduced values too (one shape, one
    # summation order); elementwise outputs and the step the twin's bits
    from conicip_tpu_torch.ops import rcone, rcone_kernel

    dt = getattr(torch, dtype)
    B, m = 6, 1001
    a = rcone_inputs(B, m, dt, cuda, seed=3)
    r_d, rinv, _, _, _ = rcone.r_scaling_plain(a["v"], a["s"])
    a.update(r_d=r_d, rinv=rinv)
    views = {}
    for k in ("v", "s", "dv", "ds", "x", "y", "r_d", "rinv"):
        wide = torch.full((B, m + 7), float("nan"), dtype=dt, device=cuda)
        wide[:, offset:offset + m] = a[k]
        views[k] = wide[:, offset:offset + m]
    views.update(smu=a["smu"], atil=a["atil"])
    e = torch.ones(m, dtype=dt, device=cuda)
    vec = rcone_kernel.plan_of("r_step", *(views[k] for k in "vs")).vec
    assert vec == (offset % (16 // views["v"].element_size()) == 0
                   and (m + 7) * views["v"].element_size() % 16 == 0)
    rows = []
    stack = rcone._stack
    monkeypatch.setattr(rcone, "_stack", lambda *x, **kw: rows.extend(
        stack(*x, **kw)[0]) or stack(*x, **kw))
    got = every_entry(views, e, views["r_d"], views["rinv"])
    # the kernels were handed the views themselves
    ptrs = {x.data_ptr() for x in (*views.values(), e)}
    assert len(rows) == 2 + 4 + 3 + 3 * 5 + 4 + 4
    assert all(x.data_ptr() in ptrs for x in rows)
    monkeypatch.undo()
    want = every_entry({k: x.contiguous() for k, x in views.items()},
                       e.expand(B, m).contiguous(), r_d, rinv)
    assert same_bits(got, want)
    dv, ds = a["dv"], a["ds"]
    plain = (*rcone.r_scaling_plain(a["v"], a["s"])[:4],
             *rcone.r_reduce4_pre_plain(a["x"], e, r_d, a["y"]),
             rcone.r_reduce4_post_plain(a["x"], r_d, dv),
             rcone.r_corrector_plain(a["x"], r_d, rinv, dv, ds, a["smu"]),
             rcone.r_k4_plain(e, r_d, rinv, dv, ds),
             rcone.r_gondzio_plain(e, r_d, rinv, dv, ds, a["atil"],
                                   a["smu"]),
             *rcone.r_step_plain(a["v"], a["s"], dv, ds, 1.0 / 0.99),
             *rcone.r_step_plain(a["v"], a["s"], dv, ds, fts=True)[:2])
    # all but μ̄ (output 4), the step's dots and fts
    assert same_bits(got[:4] + got[5:15], plain)


@pytest.mark.parametrize("dtype", ["float64", "float32"])
@pytest.mark.parametrize("B, m", [(1, 2000), (64, 1000), (1, 8195)])
def test_rcone_kernels_give_the_same_bits_every_launch(cuda, dtype, B, m):
    # two eager calls of every entry, and the replays of a captured graph
    # of the same calls, give the same bits: μ̄, the dots and fts included
    # (a cluster's partials summed in one order for a shape)
    from conicip_tpu_torch.ops import rcone

    dt = getattr(torch, dtype)
    a = rcone_inputs(B, m, dt, cuda, seed=5)
    r_d, rinv, lam, _, _ = rcone.r_scaling_plain(a["v"], a["s"])
    first = every_entry(a, lam, r_d, rinv)
    assert same_bits(first, every_entry(a, lam, r_d, rinv))
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        every_entry(a, lam, r_d, rinv)
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        captured = every_entry(a, lam, r_d, rinv)
    for _ in range(2):
        for x in captured:
            x.zero_()
        graph.replay()
        torch.cuda.synchronize()
        assert same_bits(captured, first)


def test_rcone_a_refused_cluster_raises_and_nothing_falls_back(
        cuda, monkeypatch):
    # a cluster larger than the card places (32 blocks) for r_step and
    # r_scaling: the launch is refused, the entry raises with the CUDA
    # error, counts nothing and returns nothing; the next call at the
    # wrapper's own plan runs
    from conicip_tpu_torch.ops import rcone, rcone_kernel

    a = rcone_inputs(1, 2000, torch.float64, cuda)
    v, s, dv, ds = a["v"], a["s"], a["dv"], a["ds"]
    real = rcone_kernel.launch_plan

    def oversized(kernel, B, m, dtype, aligned):
        plan = real(kernel, B, m, dtype, aligned)
        if kernel not in rcone_kernel.CLUSTER_KERNELS:
            return plan
        return plan._replace(grid=(32, plan.grid[1]), cluster=32)

    monkeypatch.setattr(rcone_kernel, "launch_plan", oversized)
    before = rcone_kernel.launch_count()
    with pytest.raises(RuntimeError, match="CUDA error"):
        rcone.r_step(v, s, dv, ds, fts=True)
    with pytest.raises(RuntimeError, match="CUDA error"):
        rcone.r_scaling(v, s)
    assert rcone_kernel.launch_count() == before
    monkeypatch.undo()
    alpha, ok = rcone.r_step(v, s, dv, ds)
    got = rcone.r_scaling(v, s)
    torch.cuda.synchronize()
    p_alpha, p_ok = rcone.r_step_plain(v, s, dv, ds)
    assert same_values(alpha, p_alpha) and torch.equal(ok, p_ok)
    want = rcone.r_scaling_plain(v, s)
    assert all(same_values(x, y) for x, y in zip(got[:4], want[:4]))
    assert rcone_kernel.launch_count() == before + 2


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
    # a vector shared by the stack is read at row stride 0, a row of a
    # wider matrix in place
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


def while_graph(limit, counter, flag, stream, child):
    """A captured graph of one conditional WHILE node (csrc/graph_cond.cu)
    whose body adds 1 to the device counter and sets the flag to counter
    < limit, the flag set the same way before the node."""
    import ctypes

    from conicip_tpu_torch.solver import graph as device_loop

    lib = device_loop._cond_library()
    g = torch.cuda.CUDAGraph()
    handle = ctypes.c_ulonglong(0)
    with torch.cuda.stream(stream):
        g.capture_begin(capture_error_mode=device_loop.CAPTURE_MODE)
        torch.lt(counter, limit, out=flag)
        errs = [lib.conicip_while_begin(
            stream.cuda_stream, child.cuda_stream, flag.data_ptr(),
            device_loop._CAPTURE_MODE_ENUM, ctypes.byref(handle))]
        with torch.cuda.stream(child):
            counter.add_(1)
            torch.lt(counter, limit, out=flag)
        errs.append(lib.conicip_while_end(child.cuda_stream, handle,
                                          flag.data_ptr()))
        g.capture_end()
    assert errs == [0, 0]
    return g


@pytest.mark.parametrize("limit", [0, 1, 7])
def test_the_while_node_runs_its_body_while_the_flag_holds(cuda, limit):
    # the node against a host loop of the same body: the counter ends at
    # the limit, run after run of the graph (the handle set anew before
    # the node on each), with no host read
    counter = torch.zeros((), dtype=torch.int64, device=cuda)
    flag = torch.zeros((), dtype=torch.bool, device=cuda)
    stream, child = torch.cuda.Stream(), torch.cuda.Stream()
    g = while_graph(limit, counter, flag, stream, child)
    for start in (0, 0, limit // 2):
        counter.fill_(start)
        torch.cuda.synchronize()
        g.replay()
        torch.cuda.synchronize()
        assert int(counter) == limit and not bool(flag)
    host = torch.zeros((), dtype=torch.int64, device=cuda)
    reads = 0
    while int(host) < limit:
        reads += 1
        host.add_(1)
    assert int(host) == int(counter) and reads == limit
    g.reset()


def launch_counters():
    """The kernels' launch counters, copied."""
    from conicip_tpu_torch.ops import rcone_kernel

    return [Counter(c) for c in (cholesky_kernel.cholesky_launches,
                                 cholesky_kernel.predicated_launches,
                                 jacobi_kernel.jacobi_launches,
                                 rcone_kernel.rcone_launches,
                                 cholesky_kernel.inverse_launches)]


def launched(fn):
    """``fn()`` and the launches it made, by counter and key."""
    before = launch_counters()
    out = fn()
    return out, [a - b for a, b in zip(launch_counters(), before)]


@pytest.mark.parametrize("stack", [None, 4])
def test_a_hit_reads_once_and_is_the_eager_loop(cuda, stack):
    # box_qp_dense(100) and a stack of 4 box QPs through graph.solve: a
    # miss and a hit on the WHILE node, each one host read (the final
    # copy), units equal to the eager loop's steps, the eager loop's
    # iterates bit for bit and its kernel launches by entry
    from conicip_tpu_torch.cones.spec import ConeSpec
    from conicip_tpu_torch.kkt import kktsolver_schur
    from conicip_tpu_torch.models import batched_box_qp
    from conicip_tpu_torch.solver import graph, ipm

    n = 100
    data = (box_qp_dense(n=n, seed=5).args()[:5] if stack is None
            else batched_box_qp(stack, n=n, seed=5))
    Q, c, A, b = (torch.as_tensor(np.asarray(x), device=cuda)
                  for x in data[:4])
    lead = () if stack is None else (stack,)
    G = torch.zeros(*lead, 0, n, dtype=torch.float64, device=cuda)
    d = torch.zeros(*lead, 0, dtype=torch.float64, device=cuda)
    args = (Q, c, A, b, G, d, ConeSpec(data[4]), kktsolver_schur,
            ipm.IPMOptions())
    graph.clear()
    est = {}
    ref, eager_launches = launched(lambda: ipm.ipm_solve(*args, stats=est))
    steps = est["fast_steps"] + est["slow_steps"]
    for hit in (False, True):
        stats = {}
        st, hit_launches = launched(lambda: graph.solve(*args, stats=stats))
        assert stats["loop"] == "graph" and stats["cache_hit"] == hit
        assert stats["polls"] == 1 and stats["replays"] == 1
        assert stats["units"] == ipm.POLL * -(-steps // ipm.POLL)
        assert stats["trips"] == est["trips"]
        for f in ("y", "w", "v", "Iter", "status"):
            assert torch.equal(getattr(st, f), getattr(ref, f)), f
        if hit:
            assert hit_launches == eager_launches
            # one inverse per KKT build, as one unconditional factor
            assert (sum(hit_launches[4].values())
                    == sum(hit_launches[0].values()) > 0)
    graph.clear()


def test_a_miss_that_ends_at_its_first_iterate_keeps_its_loop(cuda):
    # box_qp_dense(100) warm-started at its own solution ends at the
    # prologue's iterate: the miss still captures the WHILE node (its
    # eager first unit, a warm-up that changes nothing, counted in units
    # and KKT builds); the hit runs no unit; both read once and are the
    # eager loop bit for bit, the hit with its launches
    from conicip_tpu_torch import solver
    from conicip_tpu_torch.cones.spec import ConeSpec
    from conicip_tpu_torch.kkt import kktsolver_schur
    from conicip_tpu_torch.solver import graph, ipm
    from conicip_tpu_torch.trace import kkt_builds

    n = 100
    data = box_qp_dense(n=n, seed=5).args()[:5]
    Q, c, A, b = (torch.as_tensor(np.asarray(x), device=cuda)
                  for x in data[:4])
    G = torch.zeros(0, n, dtype=torch.float64, device=cuda)
    d = torch.zeros(0, dtype=torch.float64, device=cuda)
    args = (Q, c, A, b, G, d, ConeSpec(data[4]), kktsolver_schur,
            ipm.IPMOptions())
    cold = ipm.ipm_solve(*args)
    warm = solver._user_warm_vec(cold, A, b, 0)
    graph.clear()
    est = {}
    ref, eager_launches = launched(
        lambda: ipm.ipm_solve(*args, warm=warm, stats=est))
    erun = solver.Run(None, "", 0, **est)
    assert est["fast_steps"] + est["slow_steps"] == 0
    for hit in (False, True):
        stats = {}
        st, hit_launches = launched(
            lambda: graph.solve(*args, warm=warm, stats=stats))
        run = solver.Run(None, "", 0, **stats)
        assert run.loop == "graph" and run.cache_hit == hit
        assert len(graph.cache_info()) == 1
        assert run.polls == 1 and run.replays == 1
        assert run.units == (0 if hit else ipm.POLL)
        assert kkt_builds(run) == kkt_builds(erun) + (
            0 if hit else run.cold_start + ipm.POLL)
        for f in ("y", "w", "v", "Iter", "status"):
            assert torch.equal(getattr(st, f), getattr(ref, f)), f
        if hit:
            assert hit_launches == eager_launches
    graph.clear()


def test_a_verbose_hit_prints_the_eager_loops_text(cuda):
    # verbose output keeps the host-polled chunk: a miss and a hit print
    # the eager loop's text row for row, reading after each chunk
    import contextlib
    import io

    from conicip_tpu_torch import solver
    from conicip_tpu_torch.solver import graph

    args = box_qp_dense(n=64, seed=2).args()

    def printed(eager=False):
        rule = solver._eager_reason
        if eager:
            solver._eager_reason = lambda *a: "the eager loop, for comparison"
        buf = io.StringIO()
        try:
            with contextlib.redirect_stdout(buf):
                conic_ip(*args, device=cuda, verbose=True)
        finally:
            solver._eager_reason = rule
        return buf.getvalue(), solver.runs[-1]

    graph.clear()
    out_miss, miss = printed()
    out_hit, hit = printed()
    out_eager, erun = printed(eager=True)
    assert erun.loop == "eager" and miss.loop == hit.loop == "graph"
    assert not miss.cache_hit and hit.cache_hit
    assert out_miss == out_hit == out_eager and "│" in out_eager
    assert hit.polls == 1 + hit.replays and hit.replays == hit.fast_steps
    graph.clear()
