"""The port's Cholesky (conicip_tpu_torch.ops) against the JAX package's.

On the CPU the wrapper runs the plain PyTorch version; it is held against
the Pallas TPU kernel itself (run in interpret mode), against
``conicip_tpu.ops.cholesky.cholesky`` in f64, and on the failure semantics the ridge
retry depends on. The CUDA kernel itself is checked on the card by
tests/test_torch_cuda.py and chip_smoke.py.
"""

import functools

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
    M = torch.from_numpy(spd(33, seed=5))
    before = cholesky_kernel.cholesky_launches
    L = cholesky_kernel.cholesky_factor(M)
    assert cholesky_kernel.cholesky_launches == before
    assert torch.equal(L, cholesky_kernel.cholesky_plain(M))


def test_wrapper_rejects_other_devices():
    with pytest.raises(ValueError):
        cholesky_kernel.cholesky_factor(torch.empty(4, 4, device="meta"))


def test_missing_nvcc_raises(monkeypatch):
    monkeypatch.setattr(build.shutil, "which", lambda name: None)
    monkeypatch.delenv("CUDA_HOME", raising=False)
    monkeypatch.setattr(build.os.path, "isfile", lambda path: False)
    with pytest.raises(RuntimeError, match="nvcc not found"):
        build.find_nvcc()
