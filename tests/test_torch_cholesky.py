"""The port's Cholesky (conicip_tpu_torch.ops) against the JAX package's.

On the CPU the wrapper runs the plain PyTorch version; it is held against
the Pallas TPU kernel itself (run in interpret mode), against
``conicip_tpu.ops.cholesky.cholesky`` in f64, and on the failure semantics the ridge
retry depends on. The CUDA kernel itself is checked on the card by
tests/test_torch_cuda.py and chip_smoke.py; its algorithm is checked here
through :func:`cholesky_blocked_model`, which follows it step for step, and
its inverse's through :func:`tri_inv_blocked_model`.
"""

import functools
import math

import jax
import jax.experimental.pallas as pl
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import conicip_tpu  # noqa: F401  (turns on x64 for the f64 comparisons)
from conicip_tpu.ops.cholesky import cho_solve as jax_cho_solve
from conicip_tpu.ops.cholesky import cholesky as jax_cholesky
from conicip_tpu.ops.cholesky import tri_inv as jax_tri_inv
from conicip_tpu.ops.pallas_cholesky import _kernel
from conicip_tpu_torch.ops import build, cholesky_kernel
from conicip_tpu_torch.ops.cholesky import cho_solve, cholesky, tri_inv

torch.set_num_threads(1)


def spd(n, seed=0):
    rng = np.random.default_rng(seed)
    B = rng.standard_normal((n, n))
    return B @ B.T / n + np.eye(n)


def rel_err(a, b):
    return np.max(np.abs(a - b)) / np.max(np.abs(b))


# --- the CUDA kernel's algorithm (csrc/cholesky.cu) in plain torch --------

def _pivot(d):
    """A positive pivot, or NaN."""
    return torch.where(d > 0, d, torch.full_like(d, math.nan))


def _factor_leaf(A, group=4):
    """L and inv(L) of a leaf together, right-looking, `group` columns a
    step, as the kernel's sweep (the leaf padded with the identity to a
    whole number of groups): the group's diagonal block G = L_g L_g^T, then
    l_iq = (a_iq - sum_{m<q} l_im l_qm) / l_qq and x_q = (y_q - sum_{m<q}
    l_qm x_m) / l_qq, a_ic -= sum_q l_iq l_cq, y_i -= sum_q l_iq x_q past the
    group; each l_qq = d / sqrt(d)."""
    m = A.shape[0]
    mp = -(-m // group) * group
    P = torch.eye(mp, dtype=A.dtype)
    P[:m, :m] = A
    A = P
    Y = torch.eye(mp, dtype=A.dtype)
    for j in range(0, mp, group):
        e = j + group
        Lg = torch.zeros(group, group, dtype=A.dtype)
        r = torch.zeros(group, dtype=A.dtype)
        Lb = torch.zeros(mp - e, group, dtype=A.dtype)  # rows past the group
        X = torch.zeros(group, mp, dtype=A.dtype)
        for q in range(group):
            d = _pivot(A[j + q, j + q] - Lg[q, :q] @ Lg[q, :q])
            r[q] = 1 / torch.sqrt(d)
            Lg[q, q] = d * r[q]
            Lg[q + 1:, q] = (A[j + q + 1:e, j + q]
                             - Lg[q + 1:, :q] @ Lg[q, :q]) * r[q]
            Lb[:, q] = (A[e:, j + q] - Lb[:, :q] @ Lg[q, :q]) * r[q]
            X[q] = (Y[j + q] - Lg[q, :q] @ X[:q]) * r[q]
        A[e:, e:] -= Lb @ Lb.T
        Y[e:] -= Lb @ X
        A[j:e, j:e] = Lg
        A[e:, j:e] = Lb
        Y[j:e] = X
    return A[:m, :m].tril(), Y[:m, :m]


def _factor_block(D, leaf):
    """factor_diag: L_kk by leaves, each leaf's rows below solved as a
    product with the leaf's inverse; returns L_kk and the leaf inverses."""
    kb = D.shape[0]
    inverses = []
    for s in range(0, kb, leaf):
        e = min(s + leaf, kb)
        L, Y = _factor_leaf(D[s:e, s:e])
        D[s:e, s:e] = L
        inverses.append(Y)
        X = D[e:, s:e] @ Y.T
        D[e:, s:e] = X
        D[e:, e:] -= X @ X.T
    return D.tril(), inverses


def _tri_inverse(L, inverses):
    """inv(L) by recursion on halves from the leaf inverses:
    inv([A 0; B C]) = [inv(A) 0; -inv(C) (B inv(A)) inv(C)]."""
    if len(inverses) == 1:
        return inverses[0]
    h, q = L.shape[0] // 2, len(inverses) // 2
    XA = _tri_inverse(L[:h, :h], inverses[:q])
    XC = _tri_inverse(L[h:, h:], inverses[q:])
    X = torch.zeros_like(L)
    X[:h, :h], X[h:, h:] = XA, XC
    X[h:, :h] = -(XC @ (L[h:, :h] @ XA))
    return X


def cholesky_blocked_model(M, nb=128, leaf=32):
    """The kernel's blocked factor: nb-wide panels, each a diagonal-block
    factor with its explicit inverse, the panel solved as X inv(L_kk)^T,
    and a lower-triangle trailing update; the last panel may be ragged."""
    A = M.clone().tril()
    n = A.shape[0]
    for k in range(0, n, nb):
        kb = min(nb, n - k)
        L, inverses = _factor_block(A[k:k + kb, k:k + kb].clone(), leaf)
        A[k:k + kb, k:k + kb] = L
        if k + kb < n:
            X = A[k + kb:, k:k + kb] @ _tri_inverse(L, inverses).T
            A[k + kb:, k:k + kb] = X
            A[k + kb:, k + kb:] -= (X @ X.T).tril()
    return A


def _leaf_inverse(L):
    """inv_diag's leaf: column c of inv(L) per lane, right-looking,
    y_r = s_r / l_rr (as s_r times 1 / l_rr), then s_m -= l_mr y_r below;
    the strict upper triangle written as zeros."""
    rd = 1 / torch.diagonal(L)
    S = torch.eye(L.shape[0], dtype=L.dtype)
    for r in range(L.shape[0]):
        S[r] = S[r] * rd[r]
        S[r + 1:] -= L[r + 1:, r:r + 1] * S[r]
    return S.tril()


def tri_inv_blocked_model(L, nb=128, leaf=32):
    """The kernel's inverse (csrc/cholesky.cu tri_inverse): each diagonal
    block, padded to nb with the identity, inverted from its leaves'
    inverses by recursion on halves (inv_diag); W_i,0:i = X_ii L_i,0:i for
    every block row (inv_w); then block row by block row, X_i,0:i =
    -W_i,0:i X_0:i,0:i (inv_step). The lower triangle of L is read; the
    strict upper triangle of X is zero."""
    L = L.tril()
    n = L.shape[0]
    X = torch.zeros_like(L)
    for k in range(0, n, nb):
        kb = min(nb, n - k)
        D = torch.eye(nb, dtype=L.dtype)
        D[:kb, :kb] = L[k:k + kb, k:k + kb]
        inverses = [_leaf_inverse(D[s:s + leaf, s:s + leaf])
                    for s in range(0, nb, leaf)]
        X[k:k + kb, k:k + kb] = _tri_inverse(D, inverses)[:kb, :kb].tril()
    W = {i0: X[i0:i0 + nb, i0:i0 + nb] @ L[i0:i0 + nb, :i0]
         for i0 in range(nb, n, nb)}
    for i0, Wi in W.items():
        X[i0:i0 + nb, :i0] = -(Wi @ X[:i0, :i0])
    return X


def ill_conditioned(n, kappa=1e12, seed=0):
    """SPD with condition number ~kappa and unit diagonal (equilibrated)."""
    rng = np.random.default_rng(seed)
    Q, _ = np.linalg.qr(rng.standard_normal((n, n)))
    M = (Q * np.logspace(0, -np.log10(kappa), n)) @ Q.T
    d = 1 / np.sqrt(np.diag(M))
    M = M * d[:, None] * d[None, :]
    return (M + M.T) / 2


@pytest.mark.parametrize("n", [1, 31, 127, 128, 129, 300, 500])
def test_blocked_model_matches_jax_f64(n):
    M = spd(n, seed=n)
    L_ref = np.asarray(jax_cholesky(jnp.asarray(M)))
    L = cholesky_blocked_model(torch.from_numpy(M)).numpy()
    assert rel_err(L, L_ref) <= 1e-12
    np.testing.assert_array_equal(np.triu(L, 1), 0.0)


@pytest.mark.parametrize("n", [200, 300])
def test_blocked_model_ill_conditioned(n):
    # the explicit inverse of each diagonal block rounds unlike a
    # substitution; backward error stays at rounding level for kappa ~ 1e12
    M = ill_conditioned(n, seed=n)
    assert np.linalg.cond(M) > 1e11
    L = cholesky_blocked_model(torch.from_numpy(M)).numpy()
    assert np.max(np.abs(L @ L.T - M)) / np.max(np.abs(M)) <= 1e-13


@pytest.mark.parametrize("n", [128, 256])
def test_blocked_model_matches_pallas_kernel(n):
    # f32, as test_plain_matches_pallas_kernel
    M = spd(n).astype(np.float32)
    call = pl.pallas_call(
        functools.partial(_kernel, n=n, n_blocks=n // 128, unroll=1),
        out_shape=jax.ShapeDtypeStruct((n, n), jnp.float32),
        interpret=True,
    )
    L_tpu = np.asarray(call(jnp.asarray(M)))
    L = cholesky_blocked_model(torch.from_numpy(M)).numpy()
    assert L.dtype == np.float32
    assert rel_err(L, L_tpu) <= 1e-5


@pytest.mark.parametrize("p", [10, 200, 299])  # first, middle, last panel
def test_blocked_model_nan_from_failing_pivot(p):
    # a failing pivot at column p makes every entry on and below the
    # diagonal from column p on NaN, through the leaf, the diagonal block's
    # inverse, the panel product and the trailing updates; the columns
    # before p stay finite
    n = 300
    M = spd(n, seed=7)
    M[p, p] = -1.0
    L = cholesky_blocked_model(torch.from_numpy(M)).numpy()
    i, c = np.indices((n, n))
    np.testing.assert_array_equal(np.isnan(L), (c >= p) & (i >= c))


@pytest.mark.parametrize("n, kappa", [(1, None), (127, None), (128, None),
                                      (129, None), (257, None), (500, None),
                                      (200, 1e12), (300, 1e12)])
def test_tri_inv_blocked_model_matches_solve_and_jax_f64(n, kappa):
    # the kernel's block inverse against the plain version (the triangular
    # solve against the identity) and JAX's tri_inv, on well-conditioned
    # factors and on those of kappa ~ 1e12 matrices (kappa(L) ~ 1e6): f64
    # rounding of the two orders, and a residual |X L - I| at rounding level
    M = spd(n, seed=n) if kappa is None else ill_conditioned(n, kappa, seed=n)
    L = cholesky(torch.from_numpy(M))
    X = tri_inv_blocked_model(L).numpy()
    Xp = tri_inv(L).numpy()
    assert rel_err(X, Xp) <= 1e-12
    assert rel_err(X, np.asarray(jax_tri_inv(jnp.asarray(L.numpy())))) <= 1e-12
    res = np.abs(X @ L.numpy() - np.eye(n)).max()
    assert res / (np.abs(X).max() * np.abs(L.numpy()).max()) <= 1e-13
    np.testing.assert_array_equal(np.triu(X, 1), 0.0)
    np.testing.assert_array_equal(np.triu(Xp, 1), 0.0)


@pytest.mark.parametrize("n", [128, 256])
def test_plain_matches_pallas_kernel(n):
    # f32, the TPU kernel's own type; relative 1e-5 covers f32 rounding of
    # two different summation orders at these sizes
    M = spd(n).astype(np.float32)
    call = pl.pallas_call(
        functools.partial(_kernel, n=n, n_blocks=n // 128, unroll=1),
        out_shape=jax.ShapeDtypeStruct((n, n), jnp.float32),
        interpret=True,
    )
    L_tpu = np.asarray(call(jnp.asarray(M)))
    L = cholesky(torch.from_numpy(M)).numpy()
    assert rel_err(L, L_tpu) <= 1e-5
    assert np.all(np.triu(L, 1) == 0)


@pytest.mark.parametrize("n", [1, 31, 200])
def test_plain_matches_jax_f64(n):
    M = spd(n, seed=n)
    L_ref = np.asarray(jax_cholesky(jnp.asarray(M)))
    L = cholesky(torch.from_numpy(M)).numpy()
    assert rel_err(L, L_ref) <= 1e-12
    np.testing.assert_array_equal(np.triu(L, 1), 0.0)


def test_indefinite_gives_non_finite_in_both():
    M = spd(40)
    M[20, 20] = -1.0
    assert not np.all(np.isfinite(np.asarray(jax_cholesky(jnp.asarray(M)))))
    L = cholesky(torch.from_numpy(M))
    assert not bool(torch.isfinite(L).all())
    # the JAX CPU fill: NaN on and below the diagonal, zeros above
    ref = np.asarray(jax_cholesky(jnp.asarray(M)))
    np.testing.assert_array_equal(np.isnan(L.numpy()), np.isnan(ref))


def test_tri_inv_and_cho_solve_match_jax():
    M = spd(50, seed=3)
    b = np.random.default_rng(4).standard_normal(50)
    L = cholesky(torch.from_numpy(M))
    Lj = jax_cholesky(jnp.asarray(M))
    np.testing.assert_allclose(tri_inv(L).numpy(),
                               np.asarray(jax_tri_inv(Lj)),
                               rtol=1e-12, atol=1e-12)
    np.testing.assert_allclose(cho_solve(L, torch.from_numpy(b)).numpy(),
                               np.asarray(jax_cho_solve(Lj, jnp.asarray(b))),
                               rtol=1e-10, atol=1e-12)


def test_wrapper_takes_plain_version_on_cpu_without_counting():
    # the factor's wrapper and the inverse's
    M = torch.from_numpy(spd(33, seed=5))
    before = dict(cholesky_kernel.cholesky_launches)
    inv_before = dict(cholesky_kernel.inverse_launches)
    L = cholesky_kernel.cholesky_factor(M)
    X = cholesky_kernel.tri_inverse(L)
    assert cholesky_kernel.cholesky_launches == before
    assert cholesky_kernel.inverse_launches == inv_before
    assert torch.equal(L, cholesky_kernel.cholesky_plain(M))
    assert torch.equal(X, cholesky_kernel.tri_inverse_plain(L))
    assert torch.equal(tri_inv(L), X)


def test_wrapper_rejects_other_devices():
    with pytest.raises(ValueError):
        cholesky_kernel.cholesky_factor(torch.empty(4, 4, device="meta"))
    with pytest.raises(ValueError):
        cholesky_kernel.tri_inverse(torch.empty(4, 4, device="meta"))


def test_missing_nvcc_raises(monkeypatch):
    monkeypatch.setattr(build.shutil, "which", lambda name: None)
    monkeypatch.delenv("CUDA_HOME", raising=False)
    monkeypatch.setattr(build.os.path, "isfile", lambda path: False)
    with pytest.raises(RuntimeError, match="nvcc not found"):
        build.find_nvcc()


# ── stacks of matrices: the batched entry's contract, on the CPU ──


def spd_stack(B, n, seed=0):
    rng = np.random.default_rng(seed)
    X = rng.standard_normal((B, n, n))
    return X @ X.transpose(0, 2, 1) / n + np.eye(n)


@pytest.mark.parametrize("B, n", [(5, 129), (3, 40), (4, 1)])
def test_blocked_model_per_instance_over_a_stack(B, n):
    # the batched entry gives every matrix the single entry's arithmetic
    # (the batch is a grid dimension): the model run per instance, against
    # the stacked plain version and JAX's vmapped factor, f64 rounding
    M = spd_stack(B, n, seed=n)
    L = torch.stack([cholesky_blocked_model(torch.from_numpy(M[i]))
                     for i in range(B)]).numpy()
    Lp = cholesky_kernel.cholesky_plain(torch.from_numpy(M)).numpy()
    Lj = np.asarray(jax.vmap(jax_cholesky)(jnp.asarray(M)))
    assert rel_err(L, Lp) <= 1e-12 and rel_err(L, Lj) <= 1e-12
    assert np.array_equal(np.triu(L, 1), np.zeros_like(L))


def test_blocked_model_nan_instance_stays_alone():
    # an indefinite matrix in the middle of a stack: NaN from its failing
    # pivot on in the model, NaN in the plain version's whole lower
    # triangle, and in both every other instance's factor untouched
    B, n, p = 5, 200, 150
    M = spd_stack(B, n, seed=3)
    good = cholesky_kernel.cholesky_plain(torch.from_numpy(M))
    M[2, p, p] = -1.0
    Lp = cholesky_kernel.cholesky_plain(torch.from_numpy(M))
    L = torch.stack([cholesky_blocked_model(torch.from_numpy(M[i]))
                     for i in range(B)])
    i, c = np.indices((n, n))
    np.testing.assert_array_equal(torch.isnan(L[2]).numpy(), (c >= p) & (i >= c))
    np.testing.assert_array_equal(torch.isnan(Lp[2]).numpy(), i >= c)
    keep = [0, 1, 3, 4]
    assert torch.equal(Lp[keep], good[keep])
    assert rel_err(L[keep].numpy(), good[keep].numpy()) <= 1e-12


def test_tri_inv_nan_instance_stays_alone():
    # one factor of a stack NaN from a failing pivot (the kernel's pattern,
    # the model's factor; and the plain factor's whole lower triangle):
    # its inverse is non-finite, every other instance's is what it is alone
    B, n, p = 5, 200, 150
    M = spd_stack(B, n, seed=3)
    M[2, p, p] = -1.0
    Lp = cholesky_kernel.cholesky_plain(torch.from_numpy(M))
    X = tri_inv(Lp)
    keep = [0, 1, 3, 4]
    assert not bool(torch.isfinite(X[2]).all())
    for i in keep:
        assert torch.equal(X[i], tri_inv(Lp[i]))
    L = torch.stack([cholesky_blocked_model(torch.from_numpy(M[i]))
                     for i in range(B)])
    Xm = torch.stack([tri_inv_blocked_model(L[i]) for i in range(B)])
    assert not bool(torch.isfinite(Xm[2]).all())
    assert bool(torch.isfinite(Xm[keep]).all())
    assert rel_err(Xm[keep].numpy(), X[keep].numpy()) <= 1e-12
    assert torch.equal(Xm.triu(1), torch.zeros_like(Xm))


def test_stacked_cholesky_tri_inv_cho_solve_match_jax():
    B, n = 4, 30
    M = spd_stack(B, n, seed=1).reshape(2, 2, n, n)  # two leading dims
    rng = np.random.default_rng(2)
    b, Bm = rng.standard_normal((2, 2, n)), rng.standard_normal((2, 2, n, 3))
    L = cholesky(torch.from_numpy(M))
    Lj = jax.vmap(jax.vmap(jax_cholesky))(jnp.asarray(M))
    assert rel_err(L.numpy(), np.asarray(Lj)) <= 1e-12
    assert rel_err(tri_inv(L).numpy(),
                   np.asarray(jax.vmap(jax.vmap(jax_tri_inv))(Lj))) <= 1e-11
    x = cho_solve(L, torch.from_numpy(b))
    xj = jax.vmap(jax.vmap(jax_cho_solve))(Lj, jnp.asarray(b))
    assert x.shape == (2, 2, n) and rel_err(x.numpy(), np.asarray(xj)) <= 1e-11
    X = cho_solve(L, torch.from_numpy(Bm))
    Xj = jax.vmap(jax.vmap(jax_cho_solve))(Lj, jnp.asarray(Bm))
    assert rel_err(X.numpy(), np.asarray(Xj)) <= 1e-11
    L32 = cholesky(torch.from_numpy(M), torch.float32)
    assert L32.dtype == torch.float32 and rel_err(L32.numpy(), L.numpy()) <= 1e-5


def test_launch_count_tells_batched_from_single_launches():
    f64, f32 = torch.float64, torch.float32
    saved = dict(cholesky_kernel.cholesky_launches)
    try:
        cholesky_kernel.reset_launch_count()
        cholesky_kernel.cholesky_launches.update(
            {(f64, 500): 3, (f64, 500, 64): 7, (f32, 500, 64): 2,
             (f64, 10, 8): 5})
        count = cholesky_kernel.launch_count
        assert count() == 17 and count(f64) == 15 and count(n=500) == 12
        assert count(batch=False) == 3 and count(batch=True) == 14
        assert count(f64, 500, True) == 7 and count(f64, 500, False) == 3
        assert count(f32, batch=False) == 0 and count(f64, 10, batch=True) == 5
        # one stack size is one key of the counter
        assert cholesky_kernel.cholesky_launches[(f64, 500, 64)] == 7
    finally:
        cholesky_kernel.reset_launch_count()
        cholesky_kernel.cholesky_launches.update(saved)


def test_launch_count_reads_the_inverse_counter():
    # counter="inverse" counts tri_inverse's calls, keyed as the factors',
    # and no factor; the factors' counts leave the inverses out
    f64, f32 = torch.float64, torch.float32
    saved = [dict(c) for c in (cholesky_kernel.cholesky_launches,
                               cholesky_kernel.inverse_launches)]
    try:
        cholesky_kernel.reset_launch_count()
        cholesky_kernel.cholesky_launches.update({(f64, 500): 3})
        cholesky_kernel.inverse_launches.update(
            {(f64, 500): 2, (f64, 500, 64): 4, (f32, 465, 64): 1})
        count = cholesky_kernel.launch_count
        assert count() == 3 and count(counter="predicated") == 0
        assert count(counter="inverse") == 7
        assert count(f64, counter="inverse") == 6
        assert count(n=500, batch=True, counter="inverse") == 4
        assert count(f32, 465, False, counter="inverse") == 0
        cholesky_kernel.reset_launch_count()
        assert count(counter="inverse") == 0
    finally:
        cholesky_kernel.reset_launch_count()
        cholesky_kernel.cholesky_launches.update(saved[0])
        cholesky_kernel.inverse_launches.update(saved[1])
