"""The S cones' small decompositions: the Jacobi kernels' arithmetic and the
CPU route of ``conicip_tpu_torch.ops.batched``.

The CUDA kernels (``csrc/jacobi.cu``) cannot run here. Their arithmetic is
held through ``tests/jacobi_model.py``, which follows them step for step,
against LAPACK (numpy) and against the JAX package's ``jnp.linalg.eigh`` /
``eigvalsh`` / ``svd`` on numpy-seeded stacks, with quantities that do not
depend on the choice of signs or bases: the values, |U diag(w) Uᵀ − A|_F,
|UᵀU − I|_F and, for the SVD, |Uᵀ M Mᵀ U − diag(σ²)|_F. The kernels
themselves are held against the model on the card (tests/test_torch_cuda.py)
and against their plain versions by chip_smoke.py.

Tolerances, relative to max(1, |A|_F) (|M|_F² for the Gram identity, which
is quadratic in M): 1e-12 in f64 and 1e-5 in f32, the rounding of the
working type at these orders with a margin for the two summation orders.
The kernels compute in double for both entries; an f32 Jacobi would not
meet 1e-5 for |UᵀU − I|_F (one rounding per rotation, some 10 ε32 after
5-7 sweeps: 2e-5 at d = 30 on this model), where f32 LAPACK does.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import conicip_tpu  # noqa: F401  (turns on x64 for the f64 comparisons)
import jacobi_model as model
from conicip_tpu_torch.ops import batched, jacobi_kernel

torch.set_num_threads(1)

ORDERS = (1, 2, 5, 10, 20, 30, 33)
DTYPES = (np.float64, np.float32)
TOL = {np.float64: 1e-12, np.float32: 1e-5}


def sym(rng, *shape):
    X = rng.standard_normal(shape)
    return (X + np.swapaxes(X, -1, -2)) / 2


def spd(rng, d, kappa):
    """SPD of order d with eigenvalues spread over [1/kappa, 1]."""
    Q, _ = np.linalg.qr(rng.standard_normal((d, d)))
    return (Q * np.logspace(0, -np.log10(kappa), d)) @ Q.T


def clustered(rng, d):
    """Symmetric with repeated eigenvalues: three values, d//3 times or more
    each (the central path's mat(λ) of small_sdp has them)."""
    Q, _ = np.linalg.qr(rng.standard_normal((d, d)))
    w = np.repeat([2.0, -0.5, 1.0], -(-d // 3))[:d]
    return (Q * w) @ Q.T


def eigh_cases(rng, d):
    """(label, matrix) of the eigendecomposition cases at order d."""
    return (("random", sym(rng, d, d)), ("identity", np.eye(d)),
            ("clustered", clustered(rng, d)),
            ("indefinite", sym(rng, d, d) - 2.0 * np.eye(d)),
            ("spd", spd(rng, d, 1e6)))


def lz_ls(rng, d):
    """Lzᵀ Ls of the NT scaling for an ill-conditioned pair Z, S."""
    Lz = np.linalg.cholesky(spd(rng, d, 1e8))
    Ls = np.linalg.cholesky(spd(rng, d, 1e5))
    return Lz.T @ Ls


def svd_cases(rng, d):
    return (("random", rng.standard_normal((d, d))), ("identity", np.eye(d)),
            ("lz_ls", lz_ls(rng, d)))


def scale(A):
    return max(1.0, float(np.linalg.norm(A.astype(np.float64))))


def check_eigh(A, w, U, tol, against):
    A, w, U = (x.astype(np.float64) for x in (A, w, U))
    d, s = A.shape[-1], scale(A)
    assert np.abs(w - against).max() <= tol * s
    assert np.all(np.diff(w) >= 0)
    assert np.linalg.norm(U @ np.diag(w) @ U.T - A) <= tol * s
    assert np.linalg.norm(U.T @ U - np.eye(d)) <= tol * s


def check_svd(M, U, sig, tol, against):
    M, U, sig = (x.astype(np.float64) for x in (M, U, sig))
    d, s = M.shape[-1], scale(M)
    assert np.abs(sig - against).max() <= tol * s
    assert np.all(np.diff(sig) <= 0) and np.all(sig >= 0)
    G = U.T @ M @ M.T @ U - np.diag(sig ** 2)
    assert np.linalg.norm(G) <= tol * s * s
    assert np.linalg.norm(U.T @ U - np.eye(d)) <= tol * s


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("d", ORDERS)
def test_eigh_model_against_lapack_and_jax(d, dtype):
    rng = np.random.default_rng(d)
    tol = TOL[dtype]
    for label, A in eigh_cases(rng, d):
        A = A.astype(dtype)
        w, U = model.eigh_one(A)
        assert w.dtype == U.dtype == dtype, label
        check_eigh(A, w, U, tol, np.linalg.eigvalsh(A.astype(np.float64)))
        wj, Uj = jnp.linalg.eigh(jnp.asarray(A))
        check_eigh(A, w, U, tol, np.asarray(wj))
        # values only: the same arithmetic on A, so the same values
        assert np.array_equal(model.eigh_one(A, vectors=False)[0], w), label
        wv = np.asarray(jnp.linalg.eigvalsh(jnp.asarray(A)), np.float64)
        assert np.abs(w - wv).max() <= tol * scale(A), label


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("d", ORDERS)
def test_svd_model_against_lapack_and_jax(d, dtype):
    rng = np.random.default_rng(100 + d)
    tol = TOL[dtype]
    for label, M in svd_cases(rng, d):
        M = M.astype(dtype)
        U, sig = model.svd_one(M)
        assert U.dtype == sig.dtype == dtype, label
        check_svd(M, U, sig, tol,
                  np.linalg.svd(M.astype(np.float64), compute_uv=False))
        Uj, sj, _ = jnp.linalg.svd(jnp.asarray(M))
        check_svd(M, U, sig, tol, np.asarray(sj))
        # the reference's U spans the same columns: |Uᵀ U_ref| = I where
        # the singular values are apart (the random and lz_ls cases)
        if label != "identity":
            P = np.abs(U.astype(np.float64).T @ np.asarray(Uj, np.float64))
            assert np.abs(P - np.eye(d)).max() <= 1e3 * tol, label


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("d", ORDERS)
def test_the_fused_round_gives_the_two_pass_rounds_bits(d, dtype):
    # the d <= 32 kernels rotate each 2 x 2 block rows-then-columns in one
    # pass: the same products in the same order as the row pass followed
    # by the column pass, so the same bits, values and vectors
    rng = np.random.default_rng(d)
    for label, A in eigh_cases(rng, d):
        A = A.astype(dtype)
        for vectors in (True, False):
            two = model.eigh_one(A, vectors)
            one = model.eigh_one(A, vectors, fused=True)
            for a, b in zip(two, one):
                assert (a is None and b is None) or np.array_equal(a, b), (
                    label, vectors)


def test_the_ordering_pairs_every_index_once_a_round_and_every_pair_once():
    for d in (1, 2, 3, 10, 33):
        n = d + (d & 1)
        seen = set()
        for r in range(n - 1):
            p, q = model.pairs(r, n)
            assert sorted(np.concatenate([p, q])) == list(range(n))
            assert np.all(p < q)
            seen |= {(a, b) for a, b in zip(p, q) if b < d}
        assert seen == {(a, b) for a in range(d) for b in range(a + 1, d)}


@pytest.mark.parametrize("dtype", DTYPES)
def test_a_non_finite_entry_is_nan_alone(dtype):
    rng = np.random.default_rng(7)
    A = sym(rng, 4, 6, 6).astype(dtype)
    A[1, 2, 3] = np.nan
    A[2, 0, 5] = np.inf  # in the upper triangle: still not finite input
    w, U = model.eigh(A)
    Us, sig = model.svd(A)
    for out in (w, U, Us, sig):
        assert np.isnan(out[[1, 2]]).all() and np.isfinite(out[[0, 3]]).all()
    w0, U0 = model.eigh_one(A[0])
    assert np.array_equal(w[0], w0) and np.array_equal(U[0], U0)
    assert np.array_equal(model.eigvalsh(A)[3], model.eigh_one(A[3])[0])


@pytest.mark.parametrize("dtype", DTYPES)
def test_the_sweep_limit_gives_nan_alone(dtype):
    rng = np.random.default_rng(8)
    A = np.stack([np.diag(rng.standard_normal(5)), sym(rng, 5, 5)]).astype(
        dtype)
    # a diagonal matrix is converged before any sweep, a full one is not
    # after one
    w, U = model.eigh(A, max_sweeps=1)
    assert np.isfinite(w[0]).all() and np.isnan(w[1]).all()
    assert np.isfinite(U[0]).all() and np.isnan(U[1]).all()
    assert np.isnan(model.eigvalsh(A, max_sweeps=1)[1]).all()
    # the SVD stops after a sweep with no rotation: one for a diagonal M
    Us, sig = model.svd(A, max_sweeps=1)
    assert np.isfinite(sig[0]).all() and np.isnan(sig[1]).all()
    assert np.isnan(Us[1]).all()
    # and with room enough both converge
    assert np.isfinite(model.eigh(A)[0]).all()
    assert np.isfinite(model.svd(A)[1]).all()


def test_the_model_keeps_the_kernels_sweep_limit():
    assert model.MAX_SWEEPS == jacobi_kernel.MAX_SWEEPS


# ── the CPU route of ops/batched.py: the plain versions, as before ─────────

def test_cpu_route_is_the_plain_library_call():
    rng = np.random.default_rng(3)
    for dt in (torch.float64, torch.float32):
        A = torch.from_numpy(sym(rng, 3, 5, 5)).to(dt)
        w, U = batched.safe_eigh(A)
        wl, Ul = torch.linalg.eigh(A)
        assert torch.equal(w, wl) and torch.equal(U, Ul)
        assert torch.equal(batched.safe_eigvalsh(A), torch.linalg.eigvalsh(A))
        Us, sig = batched.safe_svd(A)
        Ul, sl, _ = torch.linalg.svd(A)
        assert torch.equal(Us, Ul) and torch.equal(sig, sl)
        for safe, plain in ((batched.safe_eigh, batched.eigh_plain),
                            (batched.safe_svd, batched.svd_plain)):
            for a, b in zip(safe(A), plain(A)):
                assert torch.equal(a, b)


def test_cpu_route_nan_fills_a_non_finite_entry():
    rng = np.random.default_rng(4)
    A = torch.from_numpy(sym(rng, 3, 4, 4))
    A[1, 0, 0] = float("inf")
    w, U = batched.safe_eigh(A)
    Us, sig = batched.safe_svd(A)
    for out in (w, U, Us, sig, batched.safe_eigvalsh(A)):
        assert torch.isnan(out[1]).all() and torch.isfinite(out[[0, 2]]).all()
    assert torch.equal(w[[0, 2]], torch.linalg.eigh(A[[0, 2]])[0])


def test_kernel_module_imports_without_a_card_and_refuses_other_devices():
    A = torch.eye(3, dtype=torch.float64)
    for fn in (jacobi_kernel.eigh, jacobi_kernel.eigvalsh, jacobi_kernel.svd):
        # the CPU takes ops.batched's plain version, never these
        with pytest.raises(ValueError, match="device"):
            fn(A)
        with pytest.raises(ValueError, match="device"):
            fn(A.to("meta"))
    for fn in (batched.safe_eigh, batched.safe_eigvalsh, batched.safe_svd):
        with pytest.raises(ValueError, match="device"):
            fn(A.to("meta"))
    assert jacobi_kernel.launch_count() == 0  # nothing launched here


def test_launch_count_filters_by_kind_dtype_and_order():
    f64, f32 = torch.float64, torch.float32
    saved = jacobi_kernel.jacobi_launches.copy()
    try:
        jacobi_kernel.reset_launch_count()
        jacobi_kernel.jacobi_launches.update({("svd", f64, 10, 64): 3,
                                              ("eigvalsh", f32, 10, 128): 2,
                                              ("eigh", f64, 5, 1): 1})
        assert jacobi_kernel.launch_count() == 6
        assert jacobi_kernel.launch_count("svd") == 3
        assert jacobi_kernel.launch_count(dtype=f32) == 2
        assert jacobi_kernel.launch_count(d=10) == 5
        assert jacobi_kernel.launch_count("eigh", f64, 5) == 1
        jacobi_kernel.reset_launch_count()
        assert jacobi_kernel.launch_count() == 0
    finally:
        jacobi_kernel.jacobi_launches.clear()
        jacobi_kernel.jacobi_launches.update(saved)


def test_no_other_module_of_the_port_calls_a_library_decomposition():
    # every eigen- and singular-value decomposition of the port goes
    # through ops/batched.py, so a CUDA tensor reaches the kernels
    import pathlib
    import re

    import conicip_tpu_torch

    root = pathlib.Path(conicip_tpu_torch.__file__).parent
    pattern = re.compile(r"torch\.linalg\.(eigh|eigvalsh|svd|svdvals|eig|"
                         r"eigvals)\b")
    hits = [str(p.relative_to(root)) for p in root.rglob("*.py")
            if pattern.search(p.read_text())]
    assert hits == ["ops/batched.py"]
